from .admission import AdmissionQueue, QueueFull
from .engine import (EngineDraining, QueueDeadlineExceeded, ServeEngine,
                     ServeRequest, SlotPool, engine_knobs, maybe_engine)
from .paged import KVPoolExhausted, PagedKV
from .prefix_cache import PagedPrefixCache, PrefixCache
from .supervisor import (EngineDown, PoisonedRequest, RequestDeadlineExceeded,
                         StepFailure, Supervisor)

__all__ = ["AdmissionQueue", "EngineDown", "EngineDraining", "KVPoolExhausted",
           "PagedKV", "PagedPrefixCache", "PoisonedRequest",
           "PrefixCache", "QueueDeadlineExceeded", "QueueFull",
           "RequestDeadlineExceeded", "ServeEngine", "ServeRequest",
           "SlotPool", "StepFailure", "Supervisor", "engine_knobs",
           "maybe_engine"]
