"""Request-level serving of the port: engine, typed API, scheduler,
metrics and KV-cache utilities (contiguous fp cache)."""
from repro_torch.serve.api import (GenerationRequest, RequestOutput,
                                   SamplingParams, StreamEvent)
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.kvcache import cache_bytes, pad_prefill_cache
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.scheduler import QueueFull, Scheduler, TrackedRequest
