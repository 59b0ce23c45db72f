"""Built-in Cornell Box scene description — counterpart of
``mitsuba3_tpu/models/cornell_box.py``, built on the port's own transform.

Dict-compatible with the reference's ``mi.cornell_box()``
(src/python/python/util.py:569): same geometry placement, materials and
light, so renders are directly comparable; ``bench.py`` renders it.
"""
from __future__ import annotations

from ..core.transform import Transform4f


def cornell_box(width: int = 256, height: int = 256, spp: int = 64,
                max_depth: int = 8, rfilter: str = "gaussian") -> dict:
    T = Transform4f
    return {
        'type': 'scene',
        'integrator': {
            'type': 'path',
            'max_depth': max_depth,
        },
        'sensor': {
            'type': 'perspective',
            'fov_axis': 'smaller',
            'near_clip': 0.001,
            'far_clip': 100.0,
            'fov': 39.3077,
            'to_world': T().look_at(origin=[0, 0, 3.90],
                                    target=[0, 0, 0],
                                    up=[0, 1, 0]),
            'sampler': {'type': 'independent', 'sample_count': spp},
            'film': {
                'type': 'hdrfilm',
                'width': width,
                'height': height,
                'rfilter': {'type': rfilter},
                'pixel_format': 'rgb',
            },
        },
        'white': {'type': 'diffuse',
                  'reflectance': {'type': 'rgb',
                                  'value': [0.885809, 0.698859, 0.666422]}},
        'green': {'type': 'diffuse',
                  'reflectance': {'type': 'rgb',
                                  'value': [0.105421, 0.37798, 0.076425]}},
        'red': {'type': 'diffuse',
                'reflectance': {'type': 'rgb',
                                'value': [0.570068, 0.0430135, 0.0443706]}},
        'light': {
            'type': 'rectangle',
            'to_world': T().translate([0.0, 0.99, 0.01])
                           .rotate([1, 0, 0], 90)
                           .scale([0.23, 0.19, 0.19]),
            'bsdf': {'type': 'ref', 'id': 'white'},
            'emitter': {'type': 'area',
                        'radiance': {'type': 'rgb',
                                     'value': [18.387, 13.9873, 6.75357]}},
        },
        'floor': {'type': 'rectangle',
                  'to_world': T().translate([0.0, -1.0, 0.0]).rotate([1, 0, 0], -90),
                  'bsdf': {'type': 'ref', 'id': 'white'}},
        'ceiling': {'type': 'rectangle',
                    'to_world': T().translate([0.0, 1.0, 0.0]).rotate([1, 0, 0], 90),
                    'bsdf': {'type': 'ref', 'id': 'white'}},
        'back': {'type': 'rectangle',
                 'to_world': T().translate([0.0, 0.0, -1.0]),
                 'bsdf': {'type': 'ref', 'id': 'white'}},
        'green-wall': {'type': 'rectangle',
                       'to_world': T().translate([1.0, 0.0, 0.0]).rotate([0, 1, 0], -90),
                       'bsdf': {'type': 'ref', 'id': 'green'}},
        'red-wall': {'type': 'rectangle',
                     'to_world': T().translate([-1.0, 0.0, 0.0]).rotate([0, 1, 0], 90),
                     'bsdf': {'type': 'ref', 'id': 'red'}},
        'small-box': {'type': 'cube',
                      'to_world': T().translate([0.335, -0.7, 0.38])
                                     .rotate([0, 1, 0], -17).scale(0.3),
                      'bsdf': {'type': 'ref', 'id': 'white'}},
        'large-box': {'type': 'cube',
                      'to_world': T().translate([-0.33, -0.4, -0.28])
                                     .rotate([0, 1, 0], 18.25)
                                     .scale([0.3, 0.61, 0.3]),
                      'bsdf': {'type': 'ref', 'id': 'white'}},
    }
