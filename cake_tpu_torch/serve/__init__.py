from .engine import (AdmissionQueue, EngineDown, EngineDraining, QueueFull,
                     ServeEngine, ServeRequest, SlotPool)
from .paged import KVPoolExhausted, PagedKV
from .prefix_cache import PagedPrefixCache, PrefixCache

__all__ = ["AdmissionQueue", "EngineDown", "EngineDraining", "KVPoolExhausted",
           "PagedKV", "PagedPrefixCache", "PrefixCache", "QueueFull",
           "ServeEngine", "ServeRequest", "SlotPool"]
