"""Multi-pod dry run (``repro/launch/dryrun.py``): build and count every
(architecture x input-shape) cell on the production meshes and record
memory, cost and roofline data.

  single-pod mesh: (data=16, model=16)        = 256 ranks
  multi-pod mesh:  (pod=2, data=16, model=16) = 512 ranks

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out experiments/dryrun_torch]

Where the reference lowers and compiles each cell for 512 forced host
devices, the port runs the step once as rank 0 of a fake process group
of the mesh's size (``torch.distributed``'s "fake" backend: every
collective returns at once), over meta tensors, so no device and no
memory holds the weights: per-device FLOPs, collective bytes and
argument / output / temp bytes come from ``roofline.counting``, and the
report from ``roofline.analysis`` with the H100 SXM data-sheet
constants. This is the one entry point of the port that does not run on
the card.

Each cell writes <out>/<arch>__<shape>__<mesh>.json incrementally, so the
sweep is resumable. Shape->step mapping: train_4k -> train_step,
prefill_32k -> prefill_step (INT8 path), decode_*/long_* -> decode step
(EVA VQ path; ``--serve-step``: the serving decode step, greedy).
long_500k runs only for sub-quadratic archs (``Model.supports_shape``).
The exit code is 1 if any cell ends in an error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.plan import PlanPolicy
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.api import SHAPES, Model, build_model
from repro_torch.models.common import RunConfig
from repro_torch.roofline.analysis import analyze_counted, model_flops


def fc_param_counts(model: Model) -> Dict[str, float]:
    """Analytic FC-parameter counts (total and decode-active) from specs."""
    specs = model.param_specs()
    cfg = model.cfg
    total = 0.0
    active = 0.0

    def walk(node, path):
        nonlocal total, active
        if isinstance(node, list):
            for v in node:
                walk(v, path)
        elif isinstance(node, dict):
            if "w" in node and hasattr(node["w"], "ndim") \
                    and node["w"].ndim >= 2:
                sz = float(np.prod(node["w"].shape))
                total += sz
                if "experts" in path and cfg.num_experts:
                    active += sz * cfg.top_k / cfg.num_experts
                else:
                    active += sz
                return
            for k, v in node.items():
                walk(v, path + (k,))

    walk(specs, ())
    return {"total_fc": total, "active_fc": active}


def fake_mesh(sizes: Dict[str, int]):
    """A ``DeviceMesh`` of ``sizes`` over a fake process group of that
    many ranks, this process rank 0 (a group of another size is
    replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = int(np.prod(list(sizes.values())))
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return make_mesh(tuple(sizes.values()), tuple(sizes))
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return make_mesh(tuple(sizes.values()), tuple(sizes))


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str,
             *, vq_mode: str = "eva", tag: str = "",
             serve_step: bool = False) -> Dict[str, Any]:
    """Count one cell and write its JSON (an existing file is returned as
    it is)."""
    cfg = get_config(arch)
    model = build_model(cfg)
    mesh_name = "pod2" if mesh_kind == "multi" else "pod1"
    suffix = f"__{tag}" if tag else ""
    out_path = os.path.join(out_dir,
                            f"{arch}__{shape}__{mesh_name}{suffix}.json")
    if os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)

    result: Dict[str, Any] = {"arch": arch, "shape": shape,
                              "mesh": mesh_name, "tag": tag,
                              "status": "pending"}
    if not model.supports_shape(shape):
        result["status"] = "skipped"
        result["reason"] = ("long_500k requires sub-quadratic attention; "
                            "skipped per DESIGN.md §4")
        _write(out_path, result)
        return result

    t0 = time.time()
    try:
        sizes = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        mesh = fake_mesh(sizes)
        chips = int(np.prod(list(sizes.values())))
        kind, specs = model.input_specs(shape)
        # meta tensors take the plain paths (impl="torch"), no kernel
        if kind == "train":
            rc = RunConfig(mode="train", remat=True, attn_chunk=2048,
                           plan_policy=PlanPolicy(impl="torch"))
            low = steps_mod.lower_train_step(model, mesh, specs, rc)
        elif kind == "prefill":
            rc = RunConfig(mode="prefill", remat=False, attn_chunk=2048,
                           plan_policy=PlanPolicy(impl="torch",
                                                  int8_prefill=True))
            low = steps_mod.lower_prefill_step(model, mesh, specs, rc,
                                               quantized=True)
        else:
            rc = RunConfig(mode="decode", remat=False,
                           plan_policy=PlanPolicy(impl="torch",
                                                  vq_mode=vq_mode))
            if serve_step:
                result["serve_step"] = True
                low = steps_mod.lower_serve_decode_step(
                    model, mesh, specs, rc, quantized=True, vq_mode=vq_mode)
            else:
                low = steps_mod.lower_decode_step(
                    model, mesh, specs, rc, quantized=True, vq_mode=vq_mode)
        t_lower = time.time() - t0

        seq, gb, _ = SHAPES[shape]
        counts = fc_param_counts(model)
        mf = model_flops(cfg, kind, seq, gb, counts["total_fc"],
                         counts["active_fc"])
        # the port's decode cache is updated in place: an argument, never
        # an output, so nothing is subtracted from the outputs
        report = analyze_counted(
            low.costs, arch=arch, shape=shape, mesh_name=mesh_name,
            chips=chips, model_flops=mf, step_kind=kind,
            cache_bytes_per_device=0.0)
        c = low.costs
        result.update({
            "status": "ok",
            "chips": chips,
            "step_kind": kind,
            "lower_s": round(t_lower, 2),
            "memory_analysis": {
                "argument_bytes": c.argument_bytes,
                "output_bytes": c.output_bytes,
                "temp_bytes": c.temp_bytes,
                "peak_bytes_estimate": c.argument_bytes + c.output_bytes
                + c.temp_bytes,
                "cache_bytes": low.cache_bytes,
            },
            "collective_counts": dict(c.collective_counts),
            "replicated_ops": low.replicated_ops,
            "roofline": report.to_dict(),
            "fc_params": counts,
        })
    except Exception as e:  # noqa: BLE001 - the cell records its error
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    result["wall_s"] = round(time.time() - t0, 2)
    _write(out_path, result)
    return result


def _write(path: str, obj: Dict[str, Any]):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, default=float)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--vq-mode", default="eva", choices=["eva", "dequant"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--serve-step", action="store_true",
                    help="count decode cells as the full serving step "
                         "(sampling and stopping, greedy; serve/api.py)")
    args = ap.parse_args()
    if args.serve_step and not args.tag:
        args.tag = "servestep"  # keep plain-decode cells resumable

    archs = [a for a in ARCH_IDS if a != "llama2_7b"] \
        if args.all or not args.arch \
        else [args.arch.replace("-", "_").replace(".", "_")]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    torch.set_num_threads(1)
    any_fail = False
    try:
        for arch in archs:
            for shape in shapes:
                for mk in meshes:
                    r = run_cell(arch, shape, mk, args.out,
                                 vq_mode=args.vq_mode, tag=args.tag,
                                 serve_step=args.serve_step)
                    line = (f"{arch:24s} {shape:12s} {r['mesh']:5s} "
                            f"{r['status']:8s}")
                    if r["status"] == "ok":
                        rl = r["roofline"]
                        line += (f" wall={r['wall_s']:7.1f}s "
                                 f"t_comp={rl['t_compute']*1e3:8.3f}ms "
                                 f"t_mem={rl['t_memory']*1e3:8.3f}ms "
                                 f"t_coll={rl['t_collective']*1e3:8.3f}ms "
                                 f"bound={rl['bottleneck']}")
                    elif r["status"] == "error":
                        line += f" {r['error'][:120]}"
                        any_fail = True
                    print(line, flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(1 if any_fail else 0)


if __name__ == "__main__":
    main()
