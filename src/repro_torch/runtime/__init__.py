"""Runtime helpers of the port (``repro/runtime``): sharding specs, the
step watchdog, the checkpoint-restart loop and elastic resharding."""
from repro_torch.runtime.sharding import (
    param_pspecs, opt_pspecs, batch_pspecs, cache_pspecs, to_placements,
    zero1_owners,
)
from repro_torch.runtime.fault_tolerance import (
    RestartStats, StepWatchdog, StragglerReport, run_with_restarts,
)
from repro_torch.runtime.elastic import reshard_state, valid_dp_sizes
