"""Differentiation — counterpart of ``mitsuba3_tpu/ad/`` (path replay
backpropagation, ``prb.py``)."""
