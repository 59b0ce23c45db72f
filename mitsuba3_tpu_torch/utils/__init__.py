"""Utilities — counterpart of ``mitsuba3_tpu/utils/`` (``params.py``:
``traverse`` and ``SceneParameters``)."""
