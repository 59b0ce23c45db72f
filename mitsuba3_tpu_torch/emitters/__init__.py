"""Emitter plugins — counterpart of ``mitsuba3_tpu/emitters/__init__.py``.

Area emitters (``area`` and ``directionalarea``) live on scene faces
(``face_emitter`` and ``em_radiance``; a sphere's also in ``em_sphere``
for cone sampling); the environment emitter is the scene-level map
(``emitters/envmap.py``: constant, envmap, and ``sunsky``/``timed_sunsky``
baked by ``emitters/sunsky.py``); delta emitters (point, spot,
directional, projector) are rows of ``scene.de_params``.
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


def projector_textures(de_types, de_rows) -> tuple:
    """The texture ids (k + 1 for ``scene.textures[k]``) that the projector
    rows of ``de_params`` name, sorted: the textures a delta-emitter
    lookup can reach."""
    return tuple(sorted({int(round(float(row[12])))
                         for t, row in zip(de_types, de_rows)
                         if t == PROJECTOR and round(float(row[12])) > 0}))
