from .engine import (AdmissionQueue, EngineDown, EngineDraining, QueueFull,
                     ServeEngine, ServeRequest, SlotPool)

__all__ = ["AdmissionQueue", "EngineDown", "EngineDraining", "QueueFull",
           "ServeEngine", "ServeRequest", "SlotPool"]
