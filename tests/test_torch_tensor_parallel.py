"""Tensor parallelism over ``model`` in the port's train step
(``runtime/tensor_parallel.py``, ``launch/steps.py``) on the CPU:
one subprocess (this file run as a script, 180 s at most) spawns 8
``gloo`` ranks on a (pod=2, data=2, model=2) ``DeviceMesh``, then 4
ranks on (data=2, model=2), each process group through a ``file://``
store under the test's temporary directory and one intra-op thread a
rank; every run is a SMOKE config at fp32. It checks:

  * three sharded steps of qwen3-0.6b (params as DTensors on the
    ``model`` sub-mesh, ZeRO-1 optimizer state, each rank its pipeline
    shard of the batch) against the single-process step on the whole
    batch, at the bounds of ``tests/test_torch_distributed.py``'s ZeRO-1
    steps (losses 1e-5 relative, params by ``_close_where_held``, m
    within 1e-4 of each leaf's largest);
  * the first step's loss against the JAX single-device loss of the
    same params (drawn by ``jax``, converted) on the same batch: within
    the reference's 2e-3, and within 1e-5 at fp32;
  * every rank's local shard shapes against the specs
    (``sharding.param_pspecs``): a dim the spec names ``model`` holds
    half its length, and the vocab-sharded ``emb`` among them;
  * one step of mixtral SMOKE (4 experts over ``model``) against the
    single-process step over the same 4 data-parallel shards as
    microbatches (a shard's tokens set its experts' capacity);
  * a decode step with the cache's time axis split over ``model``
    (sequence-parallel decode; qwen3 contiguous, mixtral's wrapped
    ring) against the single process's: logits and the written cache
    within 1e-5 of their largest, the lengths equal;
  * a checkpoint of the sharded params (``CheckpointManager.save`` on
    every rank, DTensor leaves) byte for byte one process's checkpoint
    of the same params whole;
  * an elastic restart: 8 ranks train with a checkpoint at step 2 and
    fail there; 4 ranks on (data=2, model=2) resume and finish, their
    losses and final params as the single-process ``train``'s;
  * a (data, model) mesh with ``model`` = 2 builds the sharded step where
    the port once refused it.
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
PARAM_REL, PARAM_LR = 1e-5, 1e-4   # as tests/test_torch_distributed.py
SMALL_GRAD = 1e-3
TP_STEPS = 3
STEPS = 4            # the elastic run: fails at 2, resumes on 4 ranks


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
    import dataclasses

    import repro_torch.launch.train as tr

    if not hasattr(tr, "_bf16_smoke_config"):
        tr._bf16_smoke_config = tr.get_smoke_config
        tr.get_smoke_config = lambda arch: dataclasses.replace(
            tr._bf16_smoke_config(arch), dtype="float32")


def _setup(arch="qwen3_0_6b"):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig
    from repro_torch.models import RunConfig, build_model
    from repro_torch.optim import AdamWConfig

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    return (build_model(cfg), RunConfig(attn_chunk=8), AdamWConfig(lr=LR),
            DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8))


def _params(tmp, arch):
    import torch

    if arch == "qwen3_0_6b":   # the JAX init, converted by the test
        return torch.load(f"{tmp}/init.pt")
    model = _setup(arch)[0]
    return model.init(torch.Generator().manual_seed(0), device="cpu")


def _tp_steps(mesh, tmp, rank, arch, steps, tag):
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import device_batch
    from repro_torch.optim import adamw_init, tree_flatten
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import tensor_parallel as tp

    model, rc, ocfg, dcfg = _setup(arch)
    step = make_train_step(model, ocfg, rc, total_steps=10, warmup=2,
                           mesh=mesh)
    dp = step.dp
    whole = _params(tmp, arch)
    params = dp.shard_params(whole)
    opt = dp.shard_opt(whole, adamw_init(whole, ocfg))
    # each rank's shards against the stacked specs
    shapes_ok, n_sharded = True, 0
    specs = tp.flat_specs(dp.specs(whole), whole)
    for x, full, spec in zip(tree_flatten(params)[0],
                             tree_flatten(whole)[0], specs):
        if not isinstance(x, DTensor):
            continue
        want = [n // 2 if d < len(spec) and spec[d] == "model" else n
                for d, n in enumerate(full.shape)]
        shapes_ok &= list(x.to_local().shape) == want
        n_sharded += want != list(full.shape)
    emb_spec = shd.param_pspecs(whole, mesh)["embedding"]["emb"]
    pipe = DataPipeline(dcfg, dp_rank=dp.rank, dp_size=dp.size)
    losses = []
    for _ in range(steps):
        params, opt, met = step(params, opt, device_batch(next(pipe), "cpu"))
        losses.append(met["loss"].item())
    pipe.close()
    full_p = dp.full_params(params)
    full_o = dp.gather_opt(params, opt)
    if rank == 0:
        np.savez(f"{tmp}/{tag}.npz", **_flat(full_p))
        np.savez(f"{tmp}/{tag}_m.npz", **_flat(full_o.m))
    with open(f"{tmp}/{tag}_{rank}.json", "w") as f:
        json.dump({"losses": losses, "shapes_ok": bool(shapes_ok),
                   "n_sharded": n_sharded, "emb_spec": list(emb_spec)}, f)
    return params, full_p


def _decode_case(arch, generator_seed=3):
    """A decode step's inputs on the CPU, the same on every rank: the
    arch's SMOKE params at fp32, a cache of 64 positions (a ring of 64
    for mixtral's window) with random rows and lengths 5 and 63 (the
    ring: 70, wrapped), one token a row."""
    import torch

    model = _setup(arch)[0]
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(generator_seed)
    cache = model.init_cache(2, 64, device="cpu")
    for seg in cache.values():
        for name in ("k", "v"):
            seg[name].copy_(torch.randn(seg[name].shape, generator=g))
        seg["len"].copy_(torch.tensor(
            [5, 70 if model.cfg.sliding_window else 63],
            dtype=torch.int32).expand_as(seg["len"]))
    tok = torch.randint(0, model.cfg.vocab_size, (2, 1), generator=g)
    pos = cache[next(iter(cache))]["len"][0][:, None].clone()
    return model, params, cache, tok.to(torch.int32), pos


def _tp_decode(mesh, tmp, rank, arch):
    """A decode step with the params over ``model`` and the cache's time
    axis split over it (sequence-parallel decode), its logits and
    written cache whole on rank 0."""
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.models import RunConfig
    from repro_torch.runtime import tensor_parallel as tp

    model, params, cache, tok, pos = _decode_case(arch)
    params = tp.distribute(params, mesh, tp.port_specs(params, mesh))
    mm = tp.model_mesh(mesh)
    for seg in cache.values():
        for name in ("k", "v"):
            seg[name] = distribute_tensor(seg[name], mm, [Shard(2)],
                                          src_data_rank=None)
    with torch.no_grad(), tp.tp_region():
        logits, cache = model.decode(params, tok, pos, cache,
                                     RunConfig(mode="decode"))
    got = {"logits": logits.full_tensor()}
    for sname, seg in cache.items():
        for name in ("k", "v", "len"):
            got[f"{sname}/{name}"] = tp.full(seg[name])
    if rank == 0:
        np.savez(f"{tmp}/decode_{arch}.npz",
                 **{k: v.float().numpy() for k, v in got.items()})


def eight_ranks(rank, tmp):
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train

    _fp32_smoke()
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    params, whole = _tp_steps(mesh, tmp, rank, "qwen3_0_6b", TP_STEPS, "tp")
    # the sharded params saved by every rank (written whole by rank 0),
    # and the same params whole by one process
    CheckpointManager(f"{tmp}/ckpt_tp", async_save=False).save(
        1, {"params": params})
    if rank == 0:
        CheckpointManager(f"{tmp}/ckpt_single", async_save=False).save(
            1, {"params": whole})
    _tp_steps(mesh, tmp, rank, "mixtral_8x22b", 1, "moe")
    for arch in ("qwen3_0_6b", "mixtral_8x22b"):
        _tp_decode(mesh, tmp, rank, arch)
    out = {}
    try:
        train("qwen3-0.6b", steps=STEPS, seq_len=16, global_batch=8,
              ckpt_dir=f"{tmp}/elastic", ckpt_every=2, fail_at=2,
              max_restarts=0, log_every=0, mesh=mesh, device="cpu")
        out["failed"] = False
    except RuntimeError as e:
        out["failed"] = "exceeded 0 restarts" in str(e)
    dist.barrier()
    with open(f"{tmp}/eight_{rank}.json", "w") as f:
        json.dump(out, f)


def four_ranks(rank, tmp):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import train

    _fp32_smoke()
    mesh = make_local_mesh(model=2)
    model, rc, ocfg, _ = _setup()
    dp = make_train_step(model, ocfg, rc, mesh=mesh).dp
    res = train("qwen3-0.6b", steps=STEPS, seq_len=16, global_batch=8,
                ckpt_dir=f"{tmp}/elastic", ckpt_every=2, log_every=0,
                mesh=mesh, device="cpu")
    if rank == 0:
        np.savez(f"{tmp}/elastic.npz", **_flat(res["params"]))
        with open(f"{tmp}/elastic.json", "w") as f:
            json.dump({"losses": {str(k): v for k, v in
                                  res["losses"].items()},
                       "tp_group": dp.tp.size(), "dp_size": dp.size}, f)


def _single_steps(model, rc, ocfg, dcfg, params, steps, total, warmup,
                  accum=1):
    import torch
    from repro_torch.checkpoint import flatten_with_paths
    from repro_torch.data import global_batch_at
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.optim import adamw_init

    step = make_train_step(model, ocfg, rc, total_steps=total, warmup=warmup,
                           accum_steps=accum)
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


def single(tmp):
    import torch
    from repro_torch.launch.train import build_trainer, train

    torch.set_num_threads(1)
    _fp32_smoke()
    out = {}
    # MoE capacity follows the tokens of a rank's batch, so the sharded
    # MoE step is held to the whole batch in 4 microbatches, one a
    # data-parallel rank's shard
    for arch, steps, accum, tag in (("qwen3_0_6b", TP_STEPS, 1, "single"),
                                    ("mixtral_8x22b", 1, 4, "single_moe")):
        model, rc, ocfg, dcfg = _setup(arch)
        params, opt, losses, small = _single_steps(
            model, rc, ocfg, dcfg, _params(tmp, arch), steps, total=10,
            warmup=2, accum=accum)
        np.savez(f"{tmp}/{tag}.npz", **_flat(params))
        np.savez(f"{tmp}/{tag}_m.npz", **_flat(opt.m))
        np.savez(f"{tmp}/{tag}_small.npz", **small)
        out[tag] = losses
    for arch in ("qwen3_0_6b", "mixtral_8x22b"):
        from repro_torch.models import RunConfig

        model, params, cache, tok, pos = _decode_case(arch)
        with torch.no_grad():
            logits, cache = model.decode(params, tok, pos, cache,
                                         RunConfig(mode="decode"))
        np.savez(f"{tmp}/decode_{arch}_single.npz", logits=logits.numpy(),
                 **{f"{s}/{n}": seg[n].float().numpy()
                    for s, seg in cache.items() for n in ("k", "v", "len")})
    res = train("qwen3-0.6b", steps=STEPS, seq_len=16, global_batch=8, lr=LR,
                log_every=0, device="cpu")
    np.savez(f"{tmp}/single_train.npz", **_flat(res["params"]))
    model, _, rc, ocfg, dcfg = build_trainer(
        "qwen3-0.6b", smoke=True, seq_len=16, global_batch=8, lr=LR)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    *_, small = _single_steps(model, rc, ocfg, dcfg, params, STEPS,
                              total=max(STEPS, 2), warmup=max(STEPS // 10, 1))
    np.savez(f"{tmp}/single_train_small.npz", **small)
    out["train"] = {str(k): v for k, v in res["losses"].items()}
    with open(f"{tmp}/single.json", "w") as f:
        json.dump(out, f)


def _jax_init(tmp):
    """qwen3 SMOKE's params drawn by the reference at fp32, converted and
    saved for the ranks; returns the reference's loss of them on the
    first batch."""
    import dataclasses

    import jax
    import torch
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import build_model as jax_build_model
    from repro.models import common as jcm
    from repro_torch.convert import from_jax_params
    from repro_torch.data import global_batch_at

    jcfg = dataclasses.replace(jax_smoke_config("qwen3_0_6b"),
                               dtype="float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    torch.save(params, f"{tmp}/init.pt")
    _, _, _, dcfg = _setup()
    batch = global_batch_at(dcfg, 0)
    return float(jm.loss(jp, batch, jcm.RunConfig(attn_chunk=8)))


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp"))
    jax_loss = _jax_init(tmp)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, __file__, tmp], env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    load = lambda name: json.load(open(os.path.join(tmp, name)))
    return {"tmp": tmp, "jax_loss": jax_loss, "single": load("single.json"),
            "tp": [load(f"tp_{r}.json") for r in range(8)],
            "moe": [load(f"moe_{r}.json") for r in range(8)],
            "eight": [load(f"eight_{r}.json") for r in range(8)],
            "elastic": load("elastic.json"),
            "npz": lambda n: dict(np.load(os.path.join(tmp, n + ".npz")))}


def _close_where_held(got, want, small):
    """As ``tests/test_torch_distributed.py``: params within PARAM_REL
    and PARAM_LR x lr wherever ``small`` is false, and ``small`` at most
    5% of them."""
    assert got.keys() == want.keys() == small.keys()
    held = total = 0
    for k in want:
        keep = ~small[k]
        held, total = held + int(keep.sum()), total + keep.size
        np.testing.assert_allclose(got[k][keep], want[k][keep], rtol=PARAM_REL,
                                   atol=PARAM_LR * LR, err_msg=k)
    assert held >= 0.95 * total, (held, total)


def _losses_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert abs(a - b) <= LOSS_REL * abs(b), (a, b)


def test_tp_steps_match_single_process(result):
    for r in result["tp"]:
        _losses_close(r["losses"], result["single"]["single"])
    _close_where_held(result["npz"]("tp"), result["npz"]("single"),
                      result["npz"]("single_small"))
    m, want = result["npz"]("tp_m"), result["npz"]("single_m")
    for k in want:
        assert np.abs(m[k] - want[k]).max() <= 1e-4 * np.abs(want[k]).max()


def test_tp_first_loss_matches_jax(result):
    got, want = result["tp"][0]["losses"][0], result["jax_loss"]
    assert abs(got - want) <= 2e-3 * abs(want)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_local_shards_follow_specs(result):
    for r in result["tp"]:
        assert r["shapes_ok"]
        assert r["n_sharded"] > 0
        assert r["emb_spec"] == ["model", None]


def test_moe_experts_over_model_step(result):
    for r in result["moe"]:
        assert r["shapes_ok"]
        _losses_close(r["losses"], result["single"]["single_moe"])
    _close_where_held(result["npz"]("moe"), result["npz"]("single_moe"),
                      result["npz"]("single_moe_small"))


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "mixtral_8x22b"])
def test_sequence_parallel_decode_matches_single_process(result, arch):
    """A decode step with the cache's time axis split over ``model``
    (qwen3: contiguous, mixtral: a wrapped ring of its window): the
    logits within 1e-5 of their largest, the new rows written at the
    same slot (within 1e-5 of the cache's largest: the sharded products
    sum in another order; a row at a wrong slot is off by ~1) and the
    lengths equal."""
    got = result["npz"](f"decode_{arch}")
    want = result["npz"](f"decode_{arch}_single")
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith("len"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            scale = np.abs(want[k]).max()
            assert np.abs(got[k] - want[k]).max() <= 1e-5 * scale, k


def test_tp_checkpoint_bytes_equal_single_process(result):
    tmp = result["tmp"]
    a = os.path.join(tmp, "ckpt_tp", "step_0000000001")
    b = os.path.join(tmp, "ckpt_single", "step_0000000001")
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        got, want = (dict(np.load(os.path.join(d, name)))
                     if name.endswith(".npz") else
                     open(os.path.join(d, name), "rb").read() for d in (a, b))
        if name.endswith(".npz"):
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert got[k].tobytes() == want[k].tobytes(), k
        else:
            assert got == want


def test_elastic_restart_onto_data_model_mesh(result):
    assert all(r["failed"] for r in result["eight"])
    got = result["elastic"]["losses"]
    want = result["single"]["train"]
    assert sorted(got) == [str(s) for s in range(2, STEPS)]
    for s in got:
        assert abs(got[s] - want[s]) <= LOSS_REL * abs(want[s]), s
    _close_where_held(result["npz"]("elastic"), result["npz"]("single_train"),
                      result["npz"]("single_train_small"))
    assert result["elastic"]["tp_group"] == 2
    assert result["elastic"]["dp_size"] == 2


if __name__ == "__main__":
    tmp = sys.argv[1]
    _ranks(8, "eight_ranks", tmp)
    _ranks(4, "four_ranks", tmp)
    single(tmp)
