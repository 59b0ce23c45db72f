"""mitsuba3_tpu_torch — the PyTorch and CUDA port of ``mitsuba3_tpu``.

The port renders on an NVIDIA GPU: plain tensor code is PyTorch, and each
Pallas kernel of the JAX package becomes a hand-written CUDA kernel for
Hopper (``sm_90a``) under ``csrc/``, built with ``nvcc`` at first use. The
public API follows the JAX package::

    import mitsuba3_tpu_torch as mi
    scene = mi.load_dict(scene_dict)              # on the card
    img, n_rays = mi.render_with_stats(scene, seed=0, spp=4)

``load_dict(d, device="cpu")`` puts a scene on the CPU, where every kernel
runs as its plain PyTorch version. The port carries the plugins of
triangle scenes (meshes, rectangles, cubes) with diffuse BSDFs, area
lights, a directional sun and a constant environment, such as
``cornell_box()``, rendered by the ``path`` integrator or differentiated
by ``prb`` (path replay backpropagation: gradients of the scene's tables
through ``torch.autograd``); small scenes use the dense intersector,
large ones the accel that ``MI3T_ACCEL`` names (cellserve, bvh_serve or
bvh_tiled); see ``loader.py``.
"""

__version__ = "0.1.0"

from .core.transform import Transform4f
from .loader import load_dict
from .models import cornell_box
from .render.integrator import render, render_with_stats
from .render.scene import Scene

ScalarTransform4f = Transform4f

__all__ = ["Scene", "ScalarTransform4f", "Transform4f", "cornell_box",
           "load_dict", "render", "render_with_stats"]
