"""Optimizers of the port (``repro/optim``): AdamW with optional fp32
master copies, SGD with momentum, learning-rate schedules and int8
gradient compression with error feedback."""
from repro_torch.optim.adamw import (
    AdamWConfig, AdamWState, adamw_init, adamw_update,
    SGDConfig, SGDState, sgd_init, sgd_update,
    clip_by_global_norm, global_norm, map_leaves, float_leaves,
    tree_flatten, tree_unflatten,
)
from repro_torch.optim.schedule import warmup_cosine, warmup_linear, constant
from repro_torch.optim.compress import (
    compress_psum, init_error_feedback, compression_ratio,
)
