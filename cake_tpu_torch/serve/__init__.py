from .engine import (AdmissionQueue, EngineDraining, QueueFull, ServeEngine,
                     ServeRequest, SlotPool)
from .paged import KVPoolExhausted, PagedKV
from .prefix_cache import PagedPrefixCache, PrefixCache
from .supervisor import EngineDown, PoisonedRequest, StepFailure, Supervisor

__all__ = ["AdmissionQueue", "EngineDown", "EngineDraining", "KVPoolExhausted",
           "PagedKV", "PagedPrefixCache", "PoisonedRequest", "PrefixCache",
           "QueueFull", "ServeEngine", "ServeRequest", "SlotPool",
           "StepFailure", "Supervisor"]
