"""Emitter plugins — counterpart of ``mitsuba3_tpu/emitters/__init__.py``.

The environment emitter is the scene-level constant map
(``emitters/envmap.py``); delta emitters are rows of ``scene.de_params``.
The port carries point, spot and directional emitters; the projector
is not ported.
"""

# delta emitter type ids (static `delta_emitter_types` entries)
POINT = 0
SPOT = 1
DIRECTIONAL = 2
PROJECTOR = 3

# de_params row layout (width 20), as in the JAX package:
#   [0:3] position, [3:6] intensity/irradiance RGB, [6:9] axis (+z),
#   [9] cos_cutoff, [10] cutoff_rad, [11] 1/transition_width,
#   [12] texture slot + 1 (projector), [13:16] axis_x, [16:19] axis_y,
#   [19] tan(fov/2) (projector)
DE_ROW = 20
