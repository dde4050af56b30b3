"""Three-term roofline analysis of a counted step
(``repro/roofline/analysis.py``).

Per (arch x shape x mesh):
  compute term    = FLOPs / (chips x peak FLOP/s)
  memory term     = HBM bytes / (chips x HBM bandwidth)
  collective term = collective bytes / (chips x link bandwidth)

Sources:
  * FLOPs: ``roofline/counting.py``'s count of the products one rank
    runs on its shards (per-device, x chips = global), where the
    reference parses the SPMD module's HLO.
  * HBM bytes (a traffic proxy): the counted argument, output and temp
    bytes of one rank, with the reference's step-kind aware model:
      decode : args + (outputs - cache_out_bytes)   (cache read once,
               written one slot)
      prefill: args + outputs + temp                (activations stream
               through HBM once)
      train  : args + outputs + 2*temp              (activations written
               in the forward, read in the backward)
    The port's decode step updates its cache in place, so the cache is
    an argument and never an output: ``cache_out_bytes`` is 0 and the
    decode term is args + outputs, the same traffic the reference's
    subtraction leaves. Arguments dominate decode (weights, VQ indices,
    the KV cache), which is the term EVA attacks.
  * collective bytes: per-device wire bytes, ring model
    (``counting.ring_bytes``).

Hardware constants, one NVIDIA H100 SXM (data-sheet figures, not
measurements): 989 TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s
fp32 outside them, 1979 TOPS dense int8, 3.35 TB/s HBM3. The link term
takes one 400 Gb/s NDR InfiniBand port, 50 GB/s each way: a 16-wide
``model`` axis spans two 8-GPU NVLink nodes, so its rings cross the
network. NVLink 4's 450 GB/s each way, inside a node, is recorded beside
it and not used.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

PEAK_FLOPS = 989e12          # dense bf16, tensor cores (data sheet)
PEAK_FLOPS_FP32 = 67e12      # fp32 outside the tensor cores (data sheet)
PEAK_INT8_OPS = 1979e12      # dense int8, tensor cores (data sheet)
HBM_BW = 3.35e12             # bytes/s, HBM3 (data sheet)
LINK_BW = 50e9               # bytes/s each way, one NDR InfiniBand port
NVLINK_BW = 450e9            # bytes/s each way, NVLink 4 (unused)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device quantities
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, float]
    # counted memory (the reference's memory_analysis fields)
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    # derived terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0
    useful_ratio: float = 0.0

    def finalize(self) -> "RooflineReport":
        self.t_compute = self.flops_per_device / PEAK_FLOPS
        self.t_memory = self.hbm_bytes_per_device / HBM_BW
        self.t_collective = self.collective_bytes_per_device / LINK_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        if self.model_flops and self.flops_per_device:
            self.useful_ratio = self.model_flops / (self.flops_per_device
                                                    * self.chips)
        return self

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def hbm_bytes(step_kind: str, argument_bytes: float, output_bytes: float,
              temp_bytes: float, cache_bytes_per_device: float = 0.0
              ) -> float:
    """The step-kind aware HBM traffic model (module docstring)."""
    if step_kind == "decode":
        return argument_bytes + max(output_bytes - cache_bytes_per_device,
                                    0.0)
    if step_kind == "prefill":
        return argument_bytes + output_bytes + temp_bytes
    return argument_bytes + output_bytes + 2 * temp_bytes


def analyze_counted(costs, *, arch: str, shape: str, mesh_name: str,
                    chips: int, model_flops: float = 0.0,
                    step_kind: str = "train",
                    cache_bytes_per_device: float = 0.0) -> RooflineReport:
    """The report of one rank's ``counting.StepCosts`` (the reference's
    ``analyze_compiled`` over a compiled program)."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=float(costs.flops),
        hbm_bytes_per_device=float(hbm_bytes(
            step_kind, costs.argument_bytes, costs.output_bytes,
            costs.temp_bytes, cache_bytes_per_device)),
        collective_bytes_per_device=float(costs.collective_bytes),
        collective_breakdown=dict(costs.collective_bytes_by_op),
        argument_bytes=int(costs.argument_bytes),
        output_bytes=int(costs.output_bytes),
        temp_bytes=int(costs.temp_bytes),
        model_flops=model_flops,
    ).finalize()


# --------------------------------------------------------- MODEL_FLOPS ----


def model_flops(cfg, shape_kind: str, seq: int, batch: int,
                n_params_fc: float,
                n_active_fc: Optional[float] = None) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode processes batch tokens,
    train includes backward (3x forward)."""
    n = n_active_fc if n_active_fc is not None else n_params_fc
    tokens = batch * (seq if shape_kind in ("train", "prefill") else 1)
    mult = 6 if shape_kind == "train" else 2
    return mult * n * tokens


def format_report_row(r: RooflineReport) -> str:
    return (
        f"| {r.arch} | {r.shape} | {r.mesh} | "
        f"{r.t_compute*1e3:.3f} | {r.t_memory*1e3:.3f} | "
        f"{r.t_collective*1e3:.3f} | {r.bottleneck} | "
        f"{r.useful_ratio:.3f} |"
    )
