"""Runtime helpers of the port (``repro/runtime``): the serving step
watchdog. The training half (restarts, elastic resharding) waits for
ROADMAP A10."""
from repro_torch.runtime.fault_tolerance import StepWatchdog, StragglerReport
