"""Fault-tolerant training driver (``repro/launch/train.py``, the
reference's CLI, flag for flag, plus ``--device``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 50 --ckpt-dir /tmp/ckpt --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --full --steps 4 --seq-len 256            # on the card

Wires together the model, the data pipeline, AdamW under the
warmup-cosine schedule, the checkpoint manager (async, atomic), the step
watchdog and the restart loop: a failure (``fail_at`` injects one into
the data pipeline, once) restarts the loop from the latest checkpoint.
The params are drawn from a ``torch.Generator`` seeded with ``seed`` on
the device, in fp32, with the config's activation dtype (the
reference's ``model.init``); the tokens are the reference's, bit for
bit.

Sharded training: ``train(..., mesh=...)`` over a ``DeviceMesh`` of the
process group (``launch/steps.py``): data-parallel over its ``("pod",
"data")`` axes, tensor-parallel over ``model`` where that axis is larger
than 1; the returned ``params`` are whole. From the command line,
``--dist-file PATH --world-size N --rank R`` for each of N processes
initialises the group through a ``file://`` store at PATH (no port to
collide) over ``gloo`` on the CPU, ``nccl`` on CUDA devices.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, DataPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import RunConfig, build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import StepWatchdog, run_with_restarts
from repro_torch.runtime.elastic import reshard_state


def build_trainer(arch: str, *, smoke: bool, seq_len: int, global_batch: int,
                  lr: float, mesh: Any = None, remat: bool = True):
    """(model, mesh, run config, AdamW config, data config) of a run."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = build_model(cfg)
    rc = RunConfig(mode="train", remat=remat, attn_chunk=min(seq_len, 1024))
    opt_cfg = AdamWConfig(lr=lr)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      global_batch=global_batch)
    return model, mesh, rc, opt_cfg, dcfg


def device_batch(batch: Dict[str, Any], device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """A pipeline batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def train(arch: str = "qwen3-0.6b", *, smoke: bool = True, steps: int = 20,
          seq_len: int = 64, global_batch: int = 8, lr: float = 1e-3,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 10,
          fail_at: Optional[int] = None, max_restarts: int = 2,
          log_every: int = 5, mesh: Any = None, seed: int = 0,
          remat: bool = True, device: DeviceLike = None) -> Dict[str, Any]:
    """Train ``arch`` for ``steps`` steps on ``device`` (default "cuda");
    with ``mesh`` sharded over it, this process one rank. Returns the
    reference's ``losses`` (step -> loss), ``restarts``, ``stragglers``
    and ``final_loss``, and the final ``params``."""
    dev = resolve_device(device)
    model, mesh, rc, opt_cfg, dcfg = build_trainer(
        arch, smoke=smoke, seq_len=seq_len, global_batch=global_batch, lr=lr,
        mesh=mesh, remat=remat)
    step_fn = make_train_step(model, opt_cfg, rc, total_steps=max(steps, 2),
                              warmup=max(steps // 10, 1), mesh=mesh)
    dp = step_fn.dp
    lead = dp is None or dist.get_rank() == 0
    mgr = (CheckpointManager(ckpt_dir, keep=2, async_save=True)
           if ckpt_dir else None)
    watchdog = StepWatchdog()
    losses: Dict[int, float] = {}
    # a failure is injected once: the "failed node" is replaced on restart
    fault = {"fail_at": fail_at}
    out: Dict[str, Any] = {}

    def save(step, params, opt, block=False):
        if dp is not None:  # every rank takes part; the first one writes
            opt = dp.gather_opt(params, opt)
            params = dp.full_params(params)
            block = True
        if lead:
            mgr.save(step, {"params": params, "opt": opt}, block=block)
        if dp is not None:
            dist.barrier(group=dp.group)

    def train_loop(start_step: int) -> int:
        params = model.init(torch.Generator(device=dev).manual_seed(seed),
                            device=dev)
        opt = adamw_init(params, opt_cfg)
        resume = start_step
        if mgr is not None and mgr.latest_step() is not None:
            resume, state = mgr.restore(device=dev)
            params, opt = state["params"], state["opt"]
        if dp is not None:
            params, opt = reshard_state(params, opt, model, mesh, device=dev)
        pipe = DataPipeline(dcfg, start_step=resume, fail_at=fault["fail_at"],
                            dp_rank=0 if dp is None else dp.rank,
                            dp_size=1 if dp is None else dp.size)
        try:
            step = resume
            for batch in pipe:
                if step >= steps:
                    break
                watchdog.start_step()
                params, opt, metrics = step_fn(params, opt,
                                               device_batch(batch, dev))
                loss = float(metrics["loss"])
                losses[step] = loss
                watchdog.end_step()
                step += 1
                if log_every and step % log_every == 0 and lead:
                    print(f"step {step:5d} loss {loss:.4f} "
                          f"gnorm {float(metrics['gnorm']):.3f}", flush=True)
                if mgr is not None and step % ckpt_every == 0:
                    save(step, params, opt)
        finally:
            pipe.close()
            if mgr is not None:
                mgr.wait()  # a save in flight lands before a restart
        if mgr is not None:
            save(steps, params, opt, block=True)
            mgr.wait()
        out["params"] = params if dp is None else dp.full_params(params)
        return steps

    def on_failure(e, n):
        fault["fail_at"] = None  # replaced node: don't re-inject
        return (mgr.latest_step() or 0) if mgr else 0

    stats = run_with_restarts(train_loop, max_restarts=max_restarts,
                              on_failure=on_failure)
    return {"losses": losses, "restarts": stats.restarts,
            "stragglers": watchdog.straggler_steps,
            "final_loss": losses[max(losses)] if losses else float("nan"),
            "params": out["params"]}


def init_distributed(dist_file: str, world_size: int, rank: int,
                     device: torch.device) -> None:
    """Join a ``world_size``-process group through a ``file://`` store at
    ``dist_file`` (``gloo`` for the CPU, ``nccl`` for CUDA devices)."""
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"file://{os.path.abspath(dist_file)}",
        world_size=world_size, rank=rank)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--dist-file", default=None,
                    help="file:// store of a data-parallel process group")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    mesh = None
    if args.dist_file:
        if dev.type == "cuda":
            dev = torch.device("cuda", args.rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        init_distributed(args.dist_file, args.world_size, args.rank, dev)
        from repro_torch.launch.mesh import make_local_mesh

        mesh = make_local_mesh(model=1)
    try:
        out = train(args.arch, smoke=args.smoke, steps=args.steps,
                    seq_len=args.seq_len, global_batch=args.global_batch,
                    lr=args.lr, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, fail_at=args.fail_at,
                    mesh=mesh, device=dev)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if mesh is None or args.rank == 0:
        print(f"final loss: {out['final_loss']:.4f} "
              f"restarts: {out['restarts']}")


if __name__ == "__main__":
    main()
