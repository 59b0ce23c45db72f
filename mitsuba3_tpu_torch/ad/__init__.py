"""Differentiation — counterpart of ``mitsuba3_tpu/ad/``: path replay
backpropagation (``prb.py``), the optimizers (``optimizers.py``) and the
LargeSteps preconditioner (``largesteps.py``)."""
from . import optimizers
from .largesteps import LargeSteps
from .optimizers import SGD, Adam, RMSProp

__all__ = ["Adam", "LargeSteps", "RMSProp", "SGD", "optimizers"]
