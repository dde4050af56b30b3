"""Pipeline parallelism in the port (``runtime/pipeline.py``) against the
reference's case (``tests/test_pipeline.py``): a (pod=4, data=2) mesh,
L 8 tanh layers of width D 16, batch 8 in 4 microbatches. One
subprocess (this file run as a script, 180 s at most) spawns 8 ``gloo``
ranks through a ``file://`` store under the test's temporary directory;
each rank holds one stage (2 layers). The pipelined forward must be
within 1e-5, and the gradients of a scalar loss within 1e-4, of JAX's
sequential scan over the same numpy inputs, on every rank.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
L, D, B, N_MICRO, STAGES = 8, 16, 8, 4, 4


def _inputs():
    rng = np.random.default_rng(0)
    return {"w": (rng.standard_normal((L, D, D)) / np.sqrt(D)
                  ).astype(np.float32),
            "b": (0.1 * rng.standard_normal((L, D))).astype(np.float32),
            "x": rng.standard_normal((B, D)).astype(np.float32)}


def _rank_main(world, rank, tmp):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                            world_size=world, rank=rank)
    try:
        _pipelined(rank, tmp)
    finally:
        dist.destroy_process_group()


def _pipelined(rank, tmp):
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.pipeline import (make_pipelined_forward,
                                              split_stages, stage_of)

    inp = _inputs()
    mesh = make_mesh((STAGES, 2), ("pod", "data"))
    stage = mesh.get_local_rank("pod")
    whole = {"w": torch.from_numpy(inp["w"]), "b": torch.from_numpy(inp["b"])}
    mine = {k: v.clone().requires_grad_(True)
            for k, v in stage_of(split_stages(whole, STAGES), stage).items()}
    fwd = make_pipelined_forward(lambda lp, x: torch.tanh(x @ lp["w"]
                                                          + lp["b"]),
                                 mesh, axis="pod", n_micro=N_MICRO)
    y = fwd(mine, torch.from_numpy(inp["x"]))
    gw, gb = torch.autograd.grad(torch.sum(y ** 2), [mine["w"], mine["b"]])
    np.savez(f"{tmp}/rank{rank}.npz", y=y.detach().numpy(), gw=gw.numpy(),
             gb=gb.numpy(), stage=stage,
             held=sum(v.numel() for v in mine.values()))


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    tmp = str(tmp_path_factory.mktemp("pipe"))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, __file__, tmp], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    inp = _inputs()

    def seq(params, x):
        def body(c, lp):
            return jnp.tanh(c @ lp["w"] + lp["b"]), None
        return jax.lax.scan(body, x, params)[0]

    params = {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])}
    y_ref = np.asarray(seq(params, inp["x"]))
    g_ref = jax.grad(lambda p: jnp.sum(seq(p, inp["x"]) ** 2))(params)
    _, err = proc.communicate(timeout=180)
    assert proc.returncode == 0, err[-3000:]
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
             for r in range(2 * STAGES)]
    return {"y_ref": y_ref, "gw": np.asarray(g_ref["w"]),
            "gb": np.asarray(g_ref["b"]), "ranks": ranks}


def test_pipelined_forward_matches_sequential(result):
    for r in result["ranks"]:
        assert np.abs(r["y"] - result["y_ref"]).max() < 1e-5


def test_pipelined_gradients_match_sequential(result):
    per = L // STAGES
    for r in result["ranks"]:
        s = int(r["stage"])
        rows = slice(s * per, (s + 1) * per)
        assert np.abs(r["gw"] - result["gw"][rows]).max() < 1e-4
        assert np.abs(r["gb"] - result["gb"][rows]).max() < 1e-4


def test_each_rank_holds_one_stage(result):
    stages = sorted(int(r["stage"]) for r in result["ranks"])
    assert stages == sorted(list(range(STAGES)) * 2)
    for r in result["ranks"]:
        assert int(r["held"]) == (L // STAGES) * (D * D + D)


if __name__ == "__main__":
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(2 * STAGES, r, sys.argv[1]))
             for r in range(2 * STAGES)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=150)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    sys.exit(0 if codes == [0] * len(procs) else 1)
