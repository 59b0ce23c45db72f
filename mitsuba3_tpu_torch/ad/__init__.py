"""Differentiation — counterpart of ``mitsuba3_tpu/ad/``: path replay
backpropagation (``prb.py``), the optimizers (``optimizers.py``), the
LargeSteps preconditioner (``largesteps.py``) and pixel mini-batches
(``ray_loader.py``)."""
from . import optimizers
from .largesteps import LargeSteps
from .optimizers import SGD, Adam, RMSProp
from .ray_loader import RayDataLoader, render_batch

__all__ = ["Adam", "LargeSteps", "RMSProp", "RayDataLoader", "SGD",
           "optimizers", "render_batch"]
