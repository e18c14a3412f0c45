"""Host utilities of the port."""
from .weights import params_from_numpy

__all__ = ["params_from_numpy"]
