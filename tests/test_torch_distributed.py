"""Data-parallel training in the port over ``torch.distributed`` on the
CPU (``gloo``): one subprocess (this file run as a script, 180 s at
most) spawns 4 ranks on a (pod=2, data=2, model=1) ``DeviceMesh``, then
2 ranks on (data=2, model=1), each process group through a ``file://``
store under the test's temporary directory (no port to collide under
xdist) and one intra-op thread a rank. Every run is qwen3-0.6b SMOKE at
fp32, so the data-parallel and the single-process steps differ only by
fp32 reassociation. It checks:

  * three ZeRO-1 data-parallel steps (each rank its ``DataPipeline``
    shard, gradients mean all-reduced, each data rank updating its
    block of layers and broadcasting it) against the single-process
    step on the whole batch: losses within 1e-5 relative (the third
    reads params that two steps moved), params within 1e-5 relative and
    1e-4 x lr wherever the single run's gradient was never near zero
    (``_close_where_held``), m within 1e-4 of each leaf's largest, and
    the optimizer state each rank holds: its own layers' m and v, none
    of the others' (``gather_opt`` gives back the whole state);
  * ``compress_psum`` (int8 with error feedback) within 0.05 of the
    true mean, and error feedback shrinking the running mean's error
    (the reference's bounds);
  * an elastic restart: 4 ranks train with a checkpoint at step 2 and
    fail there; 2 ranks resume from it (``reshard_state`` recomputes the
    owners) and finish: their losses and final params as the
    single-process ``train`` of the same config, at the bounds of the
    steps above;
  * ``to_placements`` on the mesh: the batch's spec, distributed as a
    ``DTensor``, gives each rank its pipeline shard;
  * a (data=2, model=2) mesh, which the port refused before ROADMAP
    A10's tensor parallelism: 2 ``model`` ranks a data-parallel group
    of 2.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_REL = 1e-5
LR = 1e-3
PARAM_REL, PARAM_LR = 1e-5, 1e-4   # params: rtol, and atol as a share of lr
# of a leaf's largest gradient: Adam's early steps move a param by about
# lr x g / |g|, so a reassociation error e in a gradient near zero moves
# it by about lr x e / |g| (up to 2 lr if its sign flips); such params
# are not held
SMALL_GRAD = 1e-3
DP_STEPS = 3         # the ZeRO-1 run: lr_scale 0, 0.5, 1 (warmup 2)
STEPS = 4            # the elastic run: fails at 2, resumes on 2 ranks


def _ranks(world, fn, tmp, *args):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(world, r, fn, tmp) + args)
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=150)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert codes == [0] * world, codes


def _rank_main(world, rank, fn, tmp, *args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg{world}",
                            world_size=world, rank=rank)
    try:
        globals()[fn](rank, tmp, *args)
    finally:
        dist.destroy_process_group()


def _flat(params):
    from repro_torch.checkpoint import flatten_with_paths

    return {k: v.float().numpy() for k, v in flatten_with_paths(params)}


def _fp32_smoke():
    """``train`` builds qwen3 SMOKE at fp32 in this process, as
    ``_setup``."""
    import dataclasses

    import repro_torch.launch.train as tr

    if not hasattr(tr, "_bf16_smoke_config"):
        tr._bf16_smoke_config = tr.get_smoke_config
        tr.get_smoke_config = lambda arch: dataclasses.replace(
            tr._bf16_smoke_config(arch), dtype="float32")


def _setup():
    """qwen3 SMOKE at fp32: the sharded and the whole batch's products
    differ only by fp32 reassociation."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.models import RunConfig, build_model
    from repro_torch.optim import AdamWConfig

    cfg = dataclasses.replace(get_smoke_config("qwen3_0_6b"), dtype="float32")
    return (build_model(cfg), RunConfig(attn_chunk=8), AdamWConfig(lr=LR),
            DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8))


def _single_steps(model, rc, ocfg, dcfg, steps, total, warmup):
    """The single-process step on the whole batch ``steps`` times:
    (params, opt state, losses, small) where ``small`` marks, per leaf,
    the elements whose gradient was nonzero but at most SMALL_GRAD of
    its leaf's largest at some step."""
    import torch
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.data import global_batch_at
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.optim import adamw_init

    step = make_train_step(model, ocfg, rc, total_steps=total, warmup=warmup)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = adamw_init(params, ocfg)
    losses, small = [], {}
    for i in range(steps):
        batch = {k: torch.from_numpy(v)
                 for k, v in global_batch_at(dcfg, i).items()}
        for k, g in flatten_with_paths(value_and_grad(model, params, batch,
                                                      rc)[1]):
            low = ((g != 0) & (g.abs() <= SMALL_GRAD * g.abs().max())).numpy()
            small[k] = low | small.get(k, False)
        params, opt, met = step(params, opt, batch)
        losses.append(met["loss"].item())
    return params, opt, losses, small


def _dp_steps(mesh, tmp, rank, tag):
    import torch
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import device_batch
    from repro_torch.optim import adamw_init

    model, rc, ocfg, dcfg = _setup()
    step = make_train_step(model, ocfg, rc, total_steps=10, warmup=2,
                           mesh=mesh)
    dp = step.dp
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = dp.shard_opt(params, adamw_init(params, ocfg))
    pipe = DataPipeline(dcfg, dp_rank=dp.rank, dp_size=dp.size)
    losses = []
    for _ in range(DP_STEPS):
        params, opt, met = step(params, opt, device_batch(next(pipe), "cpu"))
        losses.append(met["loss"].item())
    pipe.close()
    held = [bool(lp["attn"]["wq"]["w"].numel()) for lp in opt.m["layers"]]
    full = dp.gather_opt(params, opt)
    if rank == 0:
        np.savez(f"{tmp}/{tag}.npz", **_flat(params))
        np.savez(f"{tmp}/{tag}_m.npz", **_flat(full.m))
    with open(f"{tmp}/{tag}_{rank}.json", "w") as f:
        json.dump({"losses": losses, "held": held, "dp_rank": dp.rank,
                   "data_rank": dp.data_rank}, f)


def four_ranks(rank, tmp):
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.data import global_batch_at
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import DataParallel
    from repro_torch.launch.train import train
    from repro_torch.optim import compress_psum, init_error_feedback
    from repro_torch.runtime import sharding as shd

    _fp32_smoke()
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
    _dp_steps(mesh, tmp, rank, "dp")
    out = {}

    # the batch spec as DTensor placements: each rank's pipeline shard
    _, _, _, dcfg = _setup()
    tokens = torch.from_numpy(global_batch_at(dcfg, 0)["tokens"])
    spec = shd.batch_pspecs({"tokens": tokens}, mesh)["tokens"]
    local = distribute_tensor(tokens, mesh, shd.to_placements(spec, mesh))
    out["placements"] = bool(torch.equal(local.to_local(),
                                         tokens.chunk(4)[rank]))

    # int8 error-feedback compression over the world
    g_all = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 64)).astype(np.float32))
    g = {"g": g_all[rank]}
    ef = init_error_feedback(g)
    red, ef = compress_psum(g, ef)
    true = g_all.mean(0)
    err1 = (red["g"] - true).abs().max().item()
    applied = red["g"].clone()
    for _ in range(7):
        red, ef = compress_psum(g, ef)
        applied += red["g"]
    out["compress_rel"] = err1 / true.abs().max().item()
    out["ef_improves"] = (applied / 8 - true).abs().max().item() < 0.5 * err1

    # the model axis (refused before ROADMAP A10 was ported): the ranks
    # split into 2 data-parallel ranks of 2 tensor-parallel ranks each
    tp_dp = DataParallel(make_mesh((2, 2), ("data", "model")))
    out["tp"] = [tp_dp.tp.size(), tp_dp.size,
                 dist.get_world_size(tp_dp.group)]

    # elastic: a checkpoint at step 2, then a failure there
    try:
        train("qwen3-0.6b", steps=STEPS, seq_len=16, global_batch=8,
              ckpt_dir=f"{tmp}/elastic", ckpt_every=2, fail_at=2,
              max_restarts=0, log_every=0, mesh=mesh, device="cpu")
        out["failed"] = False
    except RuntimeError as e:
        out["failed"] = "exceeded 0 restarts" in str(e)
    dist.barrier()
    with open(f"{tmp}/four_{rank}.json", "w") as f:
        json.dump(out, f)


def two_ranks(rank, tmp):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train

    _fp32_smoke()
    res = train("qwen3-0.6b", steps=STEPS, seq_len=16, global_batch=8,
                ckpt_dir=f"{tmp}/elastic", ckpt_every=2, log_every=0,
                mesh=make_local_mesh(model=1), device="cpu")
    if rank == 0:
        np.savez(f"{tmp}/elastic.npz", **_flat(res["params"]))
        with open(f"{tmp}/elastic.json", "w") as f:
            json.dump({str(k): v for k, v in res["losses"].items()}, f)


def single(tmp):
    import torch
    from repro_torch.launch.train import build_trainer, train

    torch.set_num_threads(1)
    _fp32_smoke()
    model, rc, ocfg, dcfg = _setup()
    params, opt, losses, small = _single_steps(model, rc, ocfg, dcfg,
                                               DP_STEPS, total=10, warmup=2)
    np.savez(f"{tmp}/single.npz", **_flat(params))
    np.savez(f"{tmp}/single_m.npz", **_flat(opt.m))
    np.savez(f"{tmp}/single_small.npz", **small)
    res = train("qwen3-0.6b", steps=STEPS, seq_len=16, global_batch=8, lr=LR,
                log_every=0, device="cpu")
    np.savez(f"{tmp}/single_train.npz", **_flat(res["params"]))
    # ``train``'s own step, config and schedule, for its near-zero
    # gradients
    model, _, rc, ocfg, dcfg = build_trainer(
        "qwen3-0.6b", smoke=True, seq_len=16, global_batch=8, lr=LR)
    *_, small = _single_steps(model, rc, ocfg, dcfg, STEPS,
                              total=max(STEPS, 2), warmup=max(STEPS // 10, 1))
    np.savez(f"{tmp}/single_train_small.npz", **small)
    with open(f"{tmp}/single.json", "w") as f:
        json.dump({"losses": losses, "train": {str(k): v for k, v in
                                               res["losses"].items()}}, f)


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist"))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, __file__, tmp], env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    load = lambda name: json.load(open(os.path.join(tmp, name)))
    return {"tmp": tmp, "single": load("single.json"),
            "dp": [load(f"dp_{r}.json") for r in range(4)],
            "four": [load(f"four_{r}.json") for r in range(4)],
            "elastic": load("elastic.json"),
            "npz": lambda n: dict(np.load(os.path.join(tmp, n + ".npz")))}


def _close_where_held(got, want, small):
    """Params within PARAM_REL and PARAM_LR x lr wherever ``small`` is
    false, and ``small`` at most 5% of them (a stale or unbroadcast
    block of layers is off by about lr in nearly every element)."""
    assert got.keys() == want.keys() == small.keys()
    held = total = 0
    for k in want:
        keep = ~small[k]
        held, total = held + int(keep.sum()), total + keep.size
        np.testing.assert_allclose(got[k][keep], want[k][keep], rtol=PARAM_REL,
                                   atol=PARAM_LR * LR, err_msg=k)
    assert held >= 0.95 * total, (held, total)


def test_zero1_step_matches_single_process(result):
    for r in result["dp"]:
        for a, b in zip(r["losses"], result["single"]["losses"]):
            assert abs(a - b) <= LOSS_REL * abs(b), (a, b)
    assert len(result["single"]["losses"]) == DP_STEPS
    _close_where_held(result["npz"]("dp"), result["npz"]("single"),
                      result["npz"]("single_small"))
    m, want = result["npz"]("dp_m"), result["npz"]("single_m")
    for k in want:
        assert np.abs(m[k] - want[k]).max() <= 1e-4 * np.abs(want[k]).max()


def test_zero1_each_data_rank_holds_its_block_of_layers(result):
    """qwen3 SMOKE has 2 layers: data rank d holds layer d's m and v (in
    both pods), not the other's."""
    for r in result["dp"]:
        assert r["held"] == [i == r["data_rank"] for i in range(2)]
    assert sorted(r["dp_rank"] for r in result["dp"]) == [0, 1, 2, 3]


def test_gradient_compression(result):
    for r in result["four"]:
        assert r["compress_rel"] < 0.05
        assert r["ef_improves"]


def test_elastic_restart_continues_as_single_process(result):
    assert all(r["failed"] for r in result["four"])
    got, want = result["elastic"], result["single"]["train"]
    assert sorted(got) == [str(s) for s in range(2, STEPS)]
    for s in got:
        assert abs(got[s] - want[s]) <= LOSS_REL * abs(want[s]), s
    _close_where_held(result["npz"]("elastic"), result["npz"]("single_train"),
                      result["npz"]("single_train_small"))


def test_batch_placements(result):
    assert all(r["placements"] for r in result["four"])


def test_model_axis_refused(result):
    """A mesh with ``model`` = 2 was refused naming ROADMAP A10; it now
    splits into tensor-parallel and data-parallel groups
    (``tests/test_torch_tensor_parallel.py`` trains on such meshes)."""
    for r in result["four"]:
        assert r["tp"] == [2, 2, 2]


if __name__ == "__main__":
    tmp = sys.argv[1]
    _ranks(4, "four_ranks", tmp)
    _ranks(2, "two_ranks", tmp)
    single(tmp)
