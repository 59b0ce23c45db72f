"""Built-in scene descriptions — counterpart of ``mitsuba3_tpu/models/``."""
from .cornell_box import cornell_box

__all__ = ["cornell_box"]
