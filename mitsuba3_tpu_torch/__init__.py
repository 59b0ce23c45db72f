"""mitsuba3_tpu_torch — the PyTorch and CUDA port of ``mitsuba3_tpu``.

The port renders on an NVIDIA GPU: plain tensor code is PyTorch, and each
Pallas kernel of the JAX package becomes a hand-written CUDA kernel for
Hopper (``sm_90a``) under ``csrc/``, built with ``nvcc`` at first use. The
public API follows the JAX package::

    import mitsuba3_tpu_torch as mi
    scene = mi.load_dict(scene_dict)              # on the card
    img, n_rays = mi.render_with_stats(scene, seed=0, spp=4)

``load_dict(d, device="cpu")`` puts a scene on the CPU, where every
kernel runs as its plain PyTorch version; ``load_file(path)`` and
``load_string(xml)`` read a Mitsuba XML scene (with its OBJ, PLY and
serialized meshes) the same way. The port carries the plugins of
triangle scenes (meshes, rectangles, cubes, mesh files) with every
sampler, sensor and reconstruction filter and the crop window, BSDFs
(diffuse, conductor, roughconductor, plastic, roughplastic, dielectric,
thindielectric, roughdielectric, null, mask, blendbsdf, normalmap,
principled, principledthin, hair, measured and twosided, and a user's
own through ``register_bsdf``), analytic spheres, disks and cylinders,
``linearcurve`` and ``bsplinecurve`` sets as analytic round cones (up to
512) or tessellated tubes, SDF grids (``sdfgrid``), ``merge``,
``ellipsoidsmesh`` shell clouds and ``shapegroup``s placed by
``instance``s (prototypes stored once), area lights (on meshes and
tessellated spheres, disks and cylinders; cone-sampled on spheres),
directionalarea, point, spot, directional and projector lights and a
constant, image or sun and sky environment, such as ``cornell_box()``,
rendered by the ``path``, ``direct``, ``aov``, ``depth``, ``moment`` or
``ptracer`` integrator or differentiated by ``prb`` (path replay
backpropagation: gradients of the scene's tables through
``torch.autograd``); participating media (homogeneous and heterogeneous,
six phase functions) render under ``volpath`` and ``volpathmis`` and
differentiate under ``prbvolpath``; small scenes use the dense
intersector, large ones the accel that ``MI3T_ACCEL`` names (cellserve,
bvh_serve or bvh_tiled); see ``loader.py``. ``load_dict(d,
spectral=True)`` (or ``set_variant("cuda_ad_spectral")`` before a load)
renders the spectral variant: hero wavelengths, sampled-spectrum
emitters and reflectances, ``specfilm`` and dielectric dispersion
(``core/spectral.py``).

The inverse-rendering loop is ported too (with ``ad.RayDataLoader`` and
``ad.render_batch`` for pixel mini-batches): ``traverse(scene)`` gives the
scene's parameters under the JAX package's keys, and its ``update()``
rebuilds what an edit invalidates (the accel after a vertex edit);
``ad.Adam``, ``ad.SGD`` and ``ad.RMSProp`` step them with optax's rules,
and ``ad.LargeSteps`` reparametrises vertices::

    params = mi.traverse(scene)
    opt = mi.ad.Adam(lr=0.05, params={"bsdf_params": params["bsdf_params"]})
    ...                                   # render, loss, backward
    opt.step(grads)
    params["bsdf_params"] = opt["bsdf_params"]
    scene = params.update()
"""

__version__ = "0.1.0"

from . import ad
from .core.transform import Transform4f
from .loader import load_dict
from .models import cornell_box
from .render.integrator import render, render_with_stats
from .render.scene import Scene
from .utils.params import SceneParameters, traverse
from .utils.xml import load_file, load_string

ScalarTransform4f = Transform4f


# the variant (the JAX package's set_variant): a backend prefix is taken
# and ignored (the scene's device is the load's `device`); a name with
# "spectral" selects hero-wavelength spectral transport, others RGB
_VARIANT = "rgb"
_KNOWN_VARIANTS = ("rgb", "spectral", "scalar_rgb", "llvm_rgb", "cuda_rgb",
                   "llvm_ad_rgb", "cuda_ad_rgb", "scalar_spectral",
                   "llvm_ad_spectral")


def set_variant(*names):
    """Select the variant of later loads (``load_dict``, ``load_file``,
    ``load_string`` without `spectral`): the first of `names` that is
    known or names "rgb" or "spectral"."""
    global _VARIANT
    for name in names:
        if name in _KNOWN_VARIANTS or "rgb" in name or "spectral" in name:
            _VARIANT = "spectral" if "spectral" in name else "rgb"
            return
    raise ValueError(f"Unknown variant(s) {names!r}")


def variant() -> str:
    return _VARIANT


def variants():
    return list(_KNOWN_VARIANTS)


def register_bsdf(name, module, lower=None):
    """Register a user's BSDF plugin under the scene-dict type `name` (the
    JAX package's ``register_bsdf``); returns its type id. See
    ``bsdfs.register_custom`` for the module's contract (FLAGS, sample and
    eval_pdf on torch tensors) and `lower`."""
    from . import bsdfs
    return bsdfs.register_custom(name, module, lower)


__all__ = ["Scene", "SceneParameters", "ScalarTransform4f", "Transform4f",
           "ad", "cornell_box", "load_dict", "load_file", "load_string",
           "register_bsdf", "render", "render_with_stats", "set_variant",
           "traverse", "variant", "variants"]
