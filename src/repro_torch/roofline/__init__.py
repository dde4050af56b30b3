"""Roofline analysis of the port's steps (``repro/roofline``): the
per-device counts of one step (``counting``) and the three-term report
with the H100 SXM data-sheet constants (``analysis``)."""
from repro_torch.roofline.analysis import (
    HBM_BW, LINK_BW, NVLINK_BW, PEAK_FLOPS, PEAK_FLOPS_FP32, PEAK_INT8_OPS,
    RooflineReport, analyze_counted, format_report_row, model_flops,
)
from repro_torch.roofline.counting import StepCosts, StepCounter, ring_bytes
