"""Request-level serving of the port: engine, typed API, scheduler,
metrics, KV-cache utilities and the resilience layer."""
from repro_torch.serve.api import (GenerationRequest, RequestEvicted,
                                   RequestOutput, SamplingParams, StreamEvent)
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.kvcache import cache_bytes, pad_prefill_cache
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.resilience import (BOUNDARIES, CircuitBreaker,
                                          EngineSnapshot, FaultPlan, FaultSpec,
                                          InjectedFault, ServeRestartStats,
                                          load_snapshot_arrays, save_snapshot,
                                          serve_with_restarts)
from repro_torch.serve.scheduler import QueueFull, Scheduler, TrackedRequest
