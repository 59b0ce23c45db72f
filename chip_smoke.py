#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``mitsuba3_tpu_torch``).

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases:
1. the card's name and power limit (exits nonzero without a CUDA device);
2. build every kernel and the SAH builder from ``mitsuba3_tpu_torch/csrc``
   into ``build/kernels/`` (nvcc or g++, one process per source, all at
   once), with ptxas' registers and spills per kernel (K1-K8 must not
   spill);
3. kernels: one full-width round of the terrain64k main path (primary
   rays of the 512^2, 4 spp camera) through each kernel and its plain
   PyTorch version, compared and timed: K1 after pairgen and the pair sort
   (closest and any-hit), K2 as the first bvh_serve cull, K3 as the first
   bvh_serve block serve after the leaf sort, K2 again on a late cull
   (after the rounds have left at most 60 % of the width live), K4 as the
   first bvh_tiled 16-slot round (closest and any-hit);
4. render: ``load_dict`` of the terrain64k scene of ``bench.py``, a
   4 spp render, then a timed one, then one under torch.profiler for
   device time by kernel; first with the default accel (cellserve, K1),
   then under ``MI3T_ACCEL=serve`` (K2, K3) and ``MI3T_ACCEL=tiled`` (K4),
   each held against the cellserve image and checked to launch its kernels
   (K1's and K4's device time per mode, closest and any-hit);
5. agreement: the small terrain rendered on the card and on the CPU, under
   each accel;
6. Cornell fwd + PRB bwd, ``bench.py``'s main path: ``load_dict(
   cornell_box(512, 512, max_depth=8))`` with ``prb`` (dense intersector,
   area light), a one-pass warm-up and one timed step of ``bench.py``'s
   grad_step at 64 spp (the image loss against a zero target,
   gradients of bsdf_params, em_radiance, textures and env_data), Mrays/s
   counted as ``bench.py`` counts it ((1 + bwd_ratio) x forward rays,
   bwd_ratio measured on a 64^2 wavefront), one profiled pass; a 32^2
   Cornell render on the card against the CPU;
7. terrain64k PRB step: the terrain64k scene with ``prb`` through
   cellserve, a one-pass warm-up, one timed and one profiled grad_step
   (gradients of bsdf_params, env_data and de_params); K1 closest and
   any-hit must launch in the primal and, as often, in the replay; K1's
   device ms per step; the small terrain's step on the card against the
   CPU;
8. interior120k, bench.py:192-252: K1 against its plain version on one
   full-width round of the interior's primary rays; ``load_dict`` of the
   120,000-triangle room lit by one point light (cellserve), a warm-up
   and three timed 256^2, 4 spp renders (Mrays/s as bench.py counts it;
   K1's launches, device ms and bound and the straggler rounds per query
   from CUDA events around each launch), a profiled render, the image
   mean held within 1 % of a ``MI3T_ACCEL=tiled`` render;
9. the inverse-rendering loop of ``examples/02_inverse_rendering.py`` at
   bench.py's Cornell width (512^2, max_depth 8, prb): a 64 spp target,
   the albedo offset by +0.25, three Adam steps at 16 spp through
   ``traverse`` and ``update()``; the albedo error and a fixed-seed loss
   must fall;
10. a vertex loop on terrain64k (prb, 4 spp, cellserve): heights lifted
   by a bump, three Adam steps on LargeSteps coordinates, each ending in
   ``update()``'s host rebuild of the accel, held array by array against
   a fresh ``load_dict`` of the edited mesh; vertex gradients finite and
   nonzero; K1 launched as often in each replay as in its primal; per
   step the rebuild's seconds, CG iterations and K1's device ms;
11. kernels K5-K8 (the attic intersectors), each against its plain version
   at full width on the terrain queries of ``benchmarks/bench_bvh.py``
   (65,522 triangles, 2^19 primary rays): K5 as bvh_pallas packs the rays
   (closest and any-hit; but for the primary closest row, K5 is held on
   the first 65,536 rays, its full-width time kept as ``kernel_ms``), K6
   as the first bvh_queue cull, K7 as its first
   serve after the sort and the schedule, K8 as the first bvh2 round's
   serve on the 2^19 bounce rays; K5 (unsorted and sorted) and K7 also
   on the bounce rays, each in its own row; closest hits bit-equal in t,
   prim, u and v; per K5 row the spread of the tests over the tiles and
   (printed, not in the row) their work makespan over the resident CTAs
   modelled at the peak, in launch order and with the heaviest first;
   K8's row timed by the profiler's device time (``kernel_ms``) and by
   the CUDA-event span of the wrapper's calls (``issue_ms``), its device
   times taken by a process of their own (``chip_smoke.py
   --k8-device-ms``, see phase_k8_device);
12. attic queries: bvh_pallas, bvh_pallas sorted, bvh_queue and bvh2, each
   closest and any-hit on 2^19 primary and 2^19 bounce rays (bvh2 on the
   primary rays only: BVH2_QUERY_RAYS), timed after
   a warm-up, held to the dense oracle (``ops/intersect.py``) on the first
   32,768 rays with ``bench_bvh.verify``'s checks and to bvh_tiled at full
   width, and checked to launch every kernel of its module; per bvh2
   query K8's device ms (its launches recorded and replayed in that
   process);
13. materials (after phase 7): the Cornell step of phase 6 again at 8
   spp with tests/test_regression.py's cornell_glossy BSDFs
   (glossy_cornell_dict: a gold roughconductor, a plastic box), the
   roughconductor's alpha
   gradients nonzero; the every-BSDF Cornell
   (every_bsdf_dict: every BSDF type the port loads) rendered by `path`
   at 512^2, 8 spp, max_depth 8, and its PRB step at 128^2, 8 spp; K1
   against its plain version on one full-width round of terrain64k
   bounce rays off a roughplastic (GGX, alpha 0.3) terrain; that glossy
   terrain64k rendered through cellserve (K1 launches and device ms per
   mode by CUDA events, a profiled render); each held against the CPU at
   a small size;
14. scene files (after the loops): terrain64k written as a binary PLY
   and an XML file, whose ``load_file`` scene must equal ``load_dict``'s
   array for array (cellserve's included), rendered at 512^2, 4 spp with
   K1 launched in both modes; the Cornell box as XML with OBJ walls,
   rendered by `path` with the orthogonal sampler, a thinlens sensor and
   the lanczos filter (512^2, 16 spp, max_depth 8; one timed render, a
   profiled pass), a PRB step with multijitter, mitchell and a 384^2 crop
   at 16 spp beside phase 6's step at 16 spp; five sampler, sensor and
   filter combinations (XML_COMBOS, 32^2) and the radiancemeter,
   irradiancemeter and distant sensors (4^2) on the card against the
   CPU, per pixel;
15. textures (after the scene files; every image written by the port's
   own writers): the Cornell box with a mipmapped 1024^2 EXR floor, a
   checkerboard wall, a normalmap from a PNG around a roughplastic with a
   PNG reflectance and a mask with a PFM opacity, as an XML file whose
   ``load_file`` scene must equal ``load_dict``'s, its PRB step (512^2,
   8 spp, max_depth 8) with every texture's gradient finite and nonzero,
   a profiled pass and a 32^2 render on the card against the CPU; then
   terrain64k with a mipmapped 2048^2 EXR reflectance and an envmap from
   a 2048x1024 RGBE file: a 512^2, 4 spp render through K1 (K1 launched
   in both modes, its device ms from a profiled render), a PRB step of
   the texture and env_data, and the small terrain so textured on the
   card against the CPU;
16. media (after the textures): the fog Cornell (tests/test_regression.py's
   fog cube, homogeneous sigma_t 0.4, albedo 0.7, in bench.py's Cornell
   box) at 512^2, 8 spp, max_depth 6 under prbvolpath: a PRB step
   (Mrays/s with its bwd_ratio, peak memory, gradients of the medium
   rows, BSDF rows and emitter radiance finite, sigma_t and albedo
   nonzero) and a profiled pass; interior120k with the camera in a
   homogeneous medium (sigma_t 0.1, albedo 0.8, HG g 0.3) under volpath
   through cellserve, two timed 256^2, 4 spp renders with K1's launches
   counted from zero (closest must launch) and its device ms and bound
   by CUDA events; examples/03_volumetric.py's smoke on a 256^3 grid at
   512^2, 4 spp, max_depth 8 under volpath and volpathmis (its cell
   table built once for both), a profiled volpath render; the fog
   Cornell (and its gradients), the smoke on 16^3 and the 9,000-triangle
   foggy interior on the card against the CPU. Run it alone with
   ``python3 chip_smoke.py --phase media``;
17. integrators and lights (after the media): ``direct`` on terrain64k
   (512^2, 4 spp, cellserve: a timed and a profiled render, K1 closest
   and any-hit launches counted from zero, its device ms and bound by
   CUDA events) and ``depth`` there (hit pixels equal to an ``aov`` depth
   channel); ``aov`` (all eight AOVs and a nested path, 20 channels) on
   interior120k at 256^2, its RGB equal to a plain ``path`` render;
   ``moment`` around ``path`` on bench.py's Cornell (512^2, 64 spp), its
   RGB equal to ``path``'s, and the three Z-tests of
   tests/test_regression.py through it; the light tracer on that Cornell
   (512^2, 16 spp: 8 passes of 2^19 light paths), its channel means
   within 8 % of the path render's; the sphere-lit Cornell's PRB step
   (cone NEE; 512^2, 4 spp), ``path`` renders of a directionalarea and
   a projector Cornell (512^2, 16 spp), terrain64k under sunsky and
   timed_sunsky
   (512^2, 4 spp through K1); ten scenes on the card against the CPU at
   32^2. Run it alone with ``python3 chip_smoke.py --phase
   integrators``;
18. materials (after the integrators): a hair ball (HAIR_STRANDS strands
   from a seed, a linearcurve file the loader tessellates into 196,608
   faces) in hair of eumelanin 1.3, `path` at 512^2, 4 spp, max_depth 8
   through cellserve (K1 closest and any-hit launches counted from zero,
   device ms and bound by CUDA events, a profiled render), and in hair of
   a sigma_a its PRB step at 128^2 (sigma_a gradient finite and
   nonzero); principled terrain64k with the textured terrain's EXR as its
   base_color through K1 (both modes) and its PRB step (metallic,
   roughness, clearcoat and texture gradients nonzero); the materials
   Cornell (principled, principledthin, two measured tables read from
   .bsdf files through load_file of an XML scene, a half_diffuse
   registered in torch) at 512^2, 8 spp and its PRB step at 4 spp; the
   Cornell, a principled small terrain and a tessellated bsplinecurve
   hair scene on the card against the CPU at 32^2. Run it alone with
   ``python3 chip_smoke.py --phase materials``;
19. shapes (after the materials): terrain64k under 40 analytic spheres
   (one with a mipmapped bitmap), 12 cylinders and 12 disks in diffuse,
   roughconductor and dielectric and five B-spline sets of 80 round cones
   (464 analytic rows), `path` at 512^2, 4 spp, max_depth 4 and its PRB
   step; an instanced field (prototype R, make_terrain(129) with its own
   cellserve, in 64 instances on an 8 x 8 grid; prototype G, a cube and a
   sphere, 3,980 faces on the dense test, in 256), `path` and its PRB
   step at 128^2; a seeded 128^3 SDF blob on terrain64k, `path` and the
   grid's gradient at 128^2 by plain autograd; a merge of a ground and an
   ellipsoidsmesh of 2,048 ellipsoids (163,840 faces), `path`; per scene
   K1's launches in both modes from zero and its device ms and bound by
   CUDA events, the peak memory with the working set of one full-width
   analytic and instance query, the instance loop's rounds per query and
   a profiled render (but the instanced field's); the four scenes cut to
   CPU size at 32^2 on the card against the CPU (the analytic terrain
   without its cones, which are held on the same rays instead); then K1
   against its plain version on the instanced field's prototype-R query
   of the first instance round. Run it alone with ``python3 chip_smoke.py
   --phase shapes``;
20. accels (after the shapes): terrain64k (512^2, 4 spp)
   through ``MI3T_ACCEL=xla`` (the stackless BVH), ``grid`` (the DDA
   grid) and a HybridAccel (the grid's closest hits, bvh_tiled's any-hit
   through K4, whose launches and device ms must be above 0): per render
   the build and wall seconds, Mrays/s, peak memory, the traversal steps
   a query and the image held against cellserve's of the same seed, and
   for the hybrid a profiled render; ``MI3T_ACCEL=none`` (the dense test
   over all 65,536 faces) at NONE_SIDE^2; interior120k (256^2, 4 spp)
   through xla and grid; the small terrain on the card against the CPU
   through each of the four; ``update()`` after a vertex edit of
   terrain64k under xla, grid and the hybrid (the rebuild's seconds, the
   accel's type kept, a finite render); the hybrid's K4 any-hit launches
   metered in an untimed rerun (_K4Meter: their summed bound, tests
   counted by K4's own cull). Run it alone with ``python3
   chip_smoke.py --phase accels``;
21. the spectral variant (``phase_spectral``): terrain64k at
   512^2, 4 spp through cellserve (K1 launches counted and timed, K1 held
   bit-equal to its plain version on the render's largest launch of each
   mode: the ``.spectral`` rows), its luminance against the RGB render's;
   the spectral Cornell's PRB step at 512^2, 16 spp (primal = path
   image), the dispersive glass box and a 4-channel specfilm; a few
   RayDataLoader / render_batch steps; and on the card against the CPU at
   32^2: the spectral Cornell by load_dict and by load_string after
   set_variant, the glass box (GLASS_LIFT above the floor, max_depth 8;
   on the floor, bounce by bounce), the specfilm, the small terrain, and
   the RGB-projected spectral Cornell (dict and XML). Run it alone
   with ``python3 chip_smoke.py --phase spectral``;
22. JSON lines of render, query, PRB, material, interior, loop, scene-file,
   texture, media, integrator, slice-material, shape, accel, spectral and
   per-kernel numbers.

The last line is ``{"ok": true, "device": {...}}``; any failed check ends
the script with a nonzero code before it. The script imports no JAX: the
terrain and ray functions below are numpy copies of the benchmarks'.
"""
from __future__ import annotations

import contextlib
import heapq
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit). The data
# sheet's 67 TFLOP/s fp32 counts a fused multiply-add as two operations;
# the kernels are built with -fmad=false (so they round as their plain
# versions do), which makes every add, mul, min, max or comparison one
# instruction, and the card issues 33.5e12 of those per second.
PEAK_FP32_OPS = 33.5e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations of one ray-triangle test in csrc/cellserve_serve.cu:
# 46 arithmetic (pv 9, det 5, 1/det 1, tv 3, u 6, qv 9, v 6, t 6, u+v 1)
# and 6 comparisons (det != 0, u >= 0, v >= 0, u+v <= 1, t > MINT,
# t < best). K4's test has the same count (t >= 0 and t <= best); K3's
# adds id >= 0.
OPS_PER_TEST = 52
# operations of one ray-box test in csrc/bvh_serve_cull.cu: 18 for the three
# slabs (2 sub, 2 mul, min, max each), 4 to fold them, 1 for the entry and
# 2 comparisons (t_near <= t_far, entry < tb); a leaf box adds 2 for the
# key and 2 comparisons (key > lk, id <= n_leaves)
OPS_PER_SUP = 25
OPS_PER_BOX = 29
# operations of one ray-node test in csrc/bvh_pallas_traverse.cu: 18 for
# the slabs, 4 to fold them and 3 comparisons (t_near <= t_far,
# t_far >= 0, t_near <= best)
OPS_PER_NODE = 25
K = 128
# bench_bvh's terrain queries: make_terrain(182), 2^19 rays of each kind;
# the dense oracle holds the first HOLD_RAYS of them
BVH_SIDE = 182
BVH_RAYS = 1 << 19
HOLD_RAYS = 32768
K5_HELD_RAYS = 65536   # K5's rows but the primary closest one: rays held
LIBRARY_NOTE = ("none: no single PyTorch call computes this function")
# the name of K8's kernel function, which the profiler's tables carry
K8_KERNEL = "bvh2_serve_kernel"
# sources whose kernels must build without register spills (K1-K8;
# their launch bounds leave ptxas the registers they need)
SPILL_FREE = ("cellserve_serve.cu", "bvh_tiled_mt.cu", "bvh_serve_cull.cu",
              "bvh_serve_serve.cu", "bvh_pallas_traverse.cu",
              "bvh_queue_serve.cu", "bvh2_serve.cu")
# the late cull of the K2 phase: the first cull after the round loop has
# left at most this share of the width live
LATE_LIVE = 0.6


# ---------------------------------------------------------------------------
# Scenes (numpy copies; benchmarks/bench_bvh.py imports JAX)
# ---------------------------------------------------------------------------

def make_terrain(side: int, seed: int = 0):
    """side x side heightfield -> 2*(side-1)^2 triangles (p0, e1, e2);
    the terrain of benchmarks/bench_bvh.py."""
    rng = np.random.default_rng(seed)
    # multi-octave value noise
    h = np.zeros((side, side), np.float32)
    for octave in range(5):
        k = 2 ** octave
        g = rng.normal(0, 1.0 / (octave + 1), (4 * k + 1, 4 * k + 1))
        gi = np.linspace(0, 4 * k, side)
        xi = np.clip(gi.astype(int), 0, 4 * k - 1)
        fx = gi - xi
        a = g[np.ix_(xi, xi)]
        b = g[np.ix_(xi + 1, xi)]
        c = g[np.ix_(xi, xi + 1)]
        dd = g[np.ix_(xi + 1, xi + 1)]
        h += ((a * (1 - fx)[:, None] + b * fx[:, None]) * (1 - fx)[None, :]
              + (c * (1 - fx)[:, None] + dd * fx[:, None]) * fx[None, :])
    xs = np.linspace(-10, 10, side, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    P = np.stack([X, Y, 2.0 * h], axis=-1).reshape(-1, 3)
    idx = np.arange(side * side).reshape(side, side)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[:-1, 1:].ravel()
    d = idx[1:, 1:].ravel()
    faces = np.concatenate(
        [np.stack([a, b, c], -1), np.stack([b, d, c], -1)], 0)
    v = P[faces]
    p0 = v[:, 0]
    return p0, v[:, 1] - p0, v[:, 2] - p0


def make_rays(n: int, seed: int, kind: str):
    """n rays (o, d) of benchmarks/bench_bvh.py's terrain queries: "primary"
    from a camera at altitude in pixel order, or incoherent "bounce" rays
    from near the surface."""
    rng = np.random.default_rng(seed)
    if kind == "primary":
        # camera at altitude looking down-forward; pixel-ordered grid
        side = int(np.ceil(np.sqrt(n)))
        u = (np.arange(side) + 0.5) / side
        U, V = np.meshgrid(u, u, indexing="ij")
        U, V = U.ravel()[:n], V.ravel()[:n]
        o = np.tile(np.array([[0.0, -14.0, 8.0]], np.float32), (n, 1))
        tgt = np.stack([(U - 0.5) * 20,
                        (V - 0.5) * 20 - 2.0,
                        np.zeros(n)], -1).astype(np.float32)
        d = tgt - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    else:
        # bounce-style: origins near the surface, cosine-ish directions up
        o = rng.uniform(-9, 9, (n, 3)).astype(np.float32)
        o[:, 2] = rng.uniform(0.0, 3.0, n)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d[:, 2] = np.abs(d[:, 2]) * rng.choice([1.0, -1.0], n)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def make_interior(n_tris_target: int, seed: int = 0):
    """A closed 20 x 20 x 6 room filled with randomly placed, rotated,
    tessellated boxes and spheres until about `n_tris_target` triangles
    -> (p0, e1, e2); the interior of benchmarks/bench_bvh.py."""
    rng = np.random.default_rng(seed)
    tris = []

    def add_box(center, half, rot):
        c = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                      [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
                     np.float32) * half
        c = c @ rot.T + center
        faces = [(0, 1, 2), (0, 2, 3), (4, 6, 5), (4, 7, 6),
                 (0, 4, 5), (0, 5, 1), (3, 2, 6), (3, 6, 7),
                 (0, 3, 7), (0, 7, 4), (1, 5, 6), (1, 6, 2)]
        for a, b, d in faces:
            tris.append((c[a], c[b], c[d]))

    def add_sphere(center, radius, res):
        th = np.linspace(0, np.pi, res + 1)
        ph = np.linspace(0, 2 * np.pi, 2 * res + 1)
        P = np.stack([np.outer(np.sin(th), np.cos(ph)),
                      np.outer(np.sin(th), np.sin(ph)),
                      np.outer(np.cos(th), np.ones_like(ph))],
                     -1) * radius + center
        for i in range(res):
            for j in range(2 * res):
                a, b = P[i, j], P[i + 1, j]
                c2, d = P[i + 1, j + 1], P[i, j + 1]
                tris.append((a, b, c2))
                tris.append((a, c2, d))

    # room shell (12 tris) 20 x 20 x 6
    add_box(np.array([0, 0, 3.0]), np.array([10, 10, 3.0]), np.eye(3))
    # clutter until the budget is reached
    while len(tris) < n_tris_target - 400:
        kind = rng.random()
        pos = np.array([rng.uniform(-9, 9), rng.uniform(-9, 9),
                        rng.uniform(0.2, 2.5)])
        if kind < 0.5:
            ang = rng.uniform(0, np.pi)
            ca, sa = np.cos(ang), np.sin(ang)
            rot = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]],
                           np.float32)
            add_box(pos, rng.uniform(0.15, 0.9, 3), rot)
        else:
            add_sphere(pos, rng.uniform(0.2, 0.7),
                       int(rng.integers(6, 14)))
    t = np.asarray(tris, np.float32)
    p0 = t[:, 0]
    return p0, t[:, 1] - p0, t[:, 2] - p0


def _lights():
    return {
        "sun": {"type": "directional",
                "direction": [0.3, 0.3, -1.0],
                "irradiance": {"type": "rgb", "value": [3, 3, 3]}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": 0.3}},
    }


def terrain64k_dict(transform):
    """The terrain64k scene of bench.py: 65,522 triangles, path tracer at
    max_depth 4, 512^2 at 4 spp. `transform` is a package's
    ScalarTransform4f class."""
    p0n, e1n, e2n = make_terrain(int(np.sqrt(65536 / 2)) + 1)
    v = np.concatenate([p0n, p0n + e1n, p0n + e2n], 0)
    f = np.arange(len(p0n) * 3).reshape(3, -1).T
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {"type": "perspective", "fov": 55.0,
                   "to_world": transform().look_at(
                       origin=[0, -14, 8], target=[0, 0, 0],
                       up=[0, 0, 1]),
                   "film": {"width": 512, "height": 512},
                   "sampler": {"type": "independent",
                               "sample_count": 4}},
        "terrain": {"type": "mesh", "vertices": v, "faces": f,
                    "bsdf": {"type": "diffuse"}},
        **_lights(),
    }


def interior_dict(transform, n_tris: int = 120000, width: int = 256):
    """The interior120k scene of bench.py:192-252: make_interior(n_tris)
    as a triangle soup, one point light at (0, 0, 5) of intensity 60, path
    tracer at max_depth 4, width^2 at 4 spp."""
    p0n, e1n, e2n = make_interior(n_tris)
    v = np.concatenate([p0n, p0n + e1n, p0n + e2n], 0)
    f = np.arange(len(p0n) * 3).reshape(3, -1).T
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 4},
        "sensor": {"type": "perspective", "fov": 60.0,
                   "to_world": transform().look_at(
                       origin=[0, -8.5, 1.7], target=[0, 2, 1.5],
                       up=[0, 0, 1]),
                   "film": {"width": width, "height": width},
                   "sampler": {"type": "independent",
                               "sample_count": 4}},
        "room": {"type": "mesh", "vertices": v, "faces": f,
                 "bsdf": {"type": "diffuse"}},
        "lamp": {"type": "point", "position": [0, 0, 5.0],
                 "intensity": {"type": "rgb", "value": [60, 60, 60]}},
    }


def small_terrain_dict(transform, width: int = 24):
    """68 x 68 heightfield (8,978 faces, above the 8192-face accel
    threshold) under terrain64k's sun and environment."""
    side = 68
    rng = np.random.default_rng(3)
    xs = np.linspace(-2, 2, side, dtype=np.float32)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    Z = (0.3 * np.sin(2 * X) * np.cos(3 * Y)
         + 0.05 * rng.normal(size=X.shape)).astype(np.float32)
    verts = np.stack([X, Y, Z], -1).reshape(-1, 3)
    idx = np.arange(side * side).reshape(side, side)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, dd = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([b, dd, c], -1)], 0)
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": 3},
        "sensor": {"type": "perspective", "fov": 50.0,
                   "to_world": transform().look_at(
                       origin=[0, -4, 3], target=[0, 0, 0], up=[0, 0, 1]),
                   "film": {"width": width, "height": width},
                   "sampler": {"type": "independent",
                               "sample_count": 4}},
        "terrain": {"type": "mesh", "vertices": verts, "faces": faces,
                    "bsdf": {"type": "diffuse"}},
        **_lights(),
    }


def glossy_cornell_dict(mi, width: int, height: int, max_depth: int):
    """tests/test_regression.py's cornell_glossy materials on
    ``mi.cornell_box`` (`mi` is a package: the port or the JAX one): a gold
    roughconductor (alpha 0.25) small box and a plastic large box."""
    d = mi.cornell_box(width, height, max_depth=max_depth)
    d["small-box"]["bsdf"] = {"type": "roughconductor", "alpha": 0.25,
                              "material": "Au"}
    d["large-box"]["bsdf"] = {"type": "plastic"}
    return d


def every_bsdf_dict(mi, width: int, height: int, max_depth: int):
    """The Cornell box with every BSDF type the port loads on a surface
    (hair takes curves): a dielectric small box, a Beckmann
    roughdielectric large box, a blendbsdf back wall (diffuse and an
    anisotropic GGX copper roughconductor), a twosided(mask(roughplastic))
    floor, an aluminium conductor ceiling, a nonlinear plastic green wall,
    a thindielectric red wall, a null rectangle inside the box, and three
    panels before the back wall (EVERY_BSDF_PANELS): principled,
    principledthin and measured (an isotropic GGX table of 4 x 16^2,
    measured_fields)."""
    T = mi.ScalarTransform4f
    d = mi.cornell_box(width, height, max_depth=max_depth)
    d["small-box"]["bsdf"] = {"type": "dielectric", "int_ior": 1.5}
    d["large-box"]["bsdf"] = {"type": "roughdielectric", "alpha": 0.2,
                              "distribution": "beckmann"}
    d["back"]["bsdf"] = {
        "type": "blendbsdf", "weight": 0.3,
        "bsdf_0": {"type": "diffuse", "reflectance": {
            "type": "rgb", "value": [0.8, 0.7, 0.6]}},
        "bsdf_1": {"type": "roughconductor", "material": "Cu",
                   "alpha_u": 0.05, "alpha_v": 0.3,
                   "distribution": "ggx"}}
    d["floor"]["bsdf"] = {"type": "twosided", "bsdf": {
        "type": "mask", "opacity": 0.7,
        "bsdf": {"type": "roughplastic", "alpha": 0.2,
                 "distribution": "ggx", "diffuse_reflectance": {
                     "type": "rgb", "value": [0.6, 0.6, 0.7]}}}}
    d["ceiling"]["bsdf"] = {"type": "conductor", "material": "Al"}
    d["green-wall"]["bsdf"] = {"type": "plastic", "nonlinear": True,
                               "diffuse_reflectance": {
                                   "type": "rgb",
                                   "value": [0.105421, 0.37798, 0.076425]}}
    d["red-wall"]["bsdf"] = {"type": "thindielectric"}
    d["veil"] = {"type": "rectangle",
                 "to_world": T().translate([0.25, 0.1, 0.6]).rotate(
                     [0, 1, 0], 30).scale(0.3),
                 "bsdf": {"type": "null"}}
    for k, bsdf in enumerate((
            {"type": "principled", "metallic": 0.4, "roughness": 0.35,
             "anisotropic": 0.3, "clearcoat": 0.6, "sheen": 0.3,
             "base_color": {"type": "rgb", "value": [0.8, 0.5, 0.3]}},
            {"type": "principledthin", "spec_trans": 0.6, "diff_trans": 0.5,
             "roughness": 0.4},
            {"type": "measured", "tables": measured_fields(1, 4, 16)})):
        d[EVERY_BSDF_PANELS[k]] = {
            "type": "rectangle", "bsdf": bsdf, "to_world": T().translate(
                [-0.6 + 0.6 * k, 0.55, -0.7]).scale(0.18)}
    return d


EVERY_BSDF_PANELS = ("principled panel", "principledthin panel",
                     "measured panel")


def every_bsdf_diffuse_box_dict(mi, width: int, height: int,
                                max_depth: int):
    """every_bsdf_dict with a diffuse small box in place of its smooth
    dielectric: the one lobe of that scene that turns a rounding
    difference into a different path by max_depth 8 (ROADMAP queue 3,
    tests/test_torch_glossy.py::test_every_bsdf_depth8_parts_on_one_ulp)."""
    d = every_bsdf_dict(mi, width, height, max_depth)
    d["small-box"]["bsdf"] = {"type": "diffuse"}
    return d


# ---------------------------------------------------------------------------
# Participating media
# ---------------------------------------------------------------------------

FOG_MEDIUM = {"type": "homogeneous",
              "sigma_t": {"type": "rgb", "value": 0.4},
              "albedo": {"type": "rgb", "value": 0.7}}
INTERIOR_MEDIUM = {"type": "homogeneous",
                   "sigma_t": {"type": "rgb", "value": 0.1},
                   "albedo": {"type": "rgb", "value": 0.8},
                   "phase": {"type": "hg", "g": 0.3}}


def fog_cornell_dict(mi, width: int, height: int, max_depth: int,
                     integrator: str = "volpath"):
    """tests/test_regression.py's fog_cube on ``mi.cornell_box`` (`mi` is
    a package: the port or the JAX one): a null-BSDF cube (0.9, raised by
    1) holding a homogeneous medium of sigma_t 0.4 and albedo 0.7."""
    d = mi.cornell_box(width, height, max_depth=max_depth)
    d["integrator"] = {"type": integrator, "max_depth": max_depth}
    d["fog"] = {"type": "cube",
                "to_world": mi.ScalarTransform4f().translate([0, 1, 0])
                .scale(0.9),
                "bsdf": {"type": "null"}, "interior": dict(FOG_MEDIUM)}
    return d


def smoke_density(side: int) -> np.ndarray:
    """examples/03_volumetric.py's density blob on a side^3 grid."""
    z, y, x = np.mgrid[0:side, 0:side, 0:side].astype(np.float32) / (
        side - 1)
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    return (np.clip(1.0 - 3.0 * r, 0.0, 1.0) ** 2).astype(np.float32)


def smoke_dict(mi, width: int, side: int, integrator: str = "volpath",
               max_depth: int = 8, spp: int = 4):
    """examples/03_volumetric.py's scene (a heterogeneous smoke of sigma_t
    4 and albedo 0.9 with an HG phase of g 0.4 in a null cube, lit by an
    area light and a dim environment) at width^2 with its density formula
    on a side^3 grid."""
    T = mi.ScalarTransform4f
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": max_depth},
        "sensor": {"type": "perspective", "fov": 40.0,
                   "to_world": T().look_at(origin=[0, 0, -4],
                                           target=[0, 0, 0], up=[0, 1, 0]),
                   "film": {"width": width, "height": width,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "smoke": {"type": "cube", "bsdf": {"type": "null"},
                  "interior": {"type": "heterogeneous",
                               "sigma_t": {"type": "rgb",
                                           "value": [4.0, 4.0, 4.0]},
                               "albedo": {"type": "rgb",
                                          "value": [0.9, 0.9, 0.9]},
                               "density": smoke_density(side),
                               "phase": {"type": "hg", "g": 0.4}}},
        "light": {"type": "rectangle",
                  "to_world": T().translate([0, 2.2, 0])
                  .rotate([1, 0, 0], 90).scale(1.2),
                  "emitter": {"type": "area",
                              "radiance": {"type": "rgb",
                                           "value": [12, 12, 12]}}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": 0.05}},
    }


def foggy_interior_dict(transform, n_tris: int = 120000, width: int = 256,
                        integrator: str = "volpath"):
    """interior_dict with the camera in a homogeneous medium (sigma_t 0.1,
    albedo 0.8, HG g 0.3) that fills the room, under `integrator` at
    max_depth 4: every NEE shadow ray becomes closest-hit segments."""
    d = interior_dict(transform, n_tris, width)
    d["integrator"] = {"type": integrator, "max_depth": 4}
    d["sensor"]["medium"] = dict(INTERIOR_MEDIUM)
    return d


# ---------------------------------------------------------------------------
# Scene files: a user's own XML, with meshes in OBJ and PLY files
# ---------------------------------------------------------------------------

CORNELL_WALLS = {"floor": "white", "ceiling": "white", "back": "white",
                 "green-wall": "green", "red-wall": "red"}
RECT_V = ((-1.0, -1.0, 0.0), (1.0, -1.0, 0.0), (1.0, 1.0, 0.0),
          (-1.0, 1.0, 0.0))
LOOKAT = '<lookat origin="0, 0, 3.9" target="0, 0, 0" up="0, 1, 0"/>'
# the sensors' to_world and parameters in a Cornell XML file
XML_SENSORS = {
    "perspective": ('<float name="fov" value="39.3077"/>'
                    '<string name="fov_axis" value="smaller"/>'
                    f'<transform name="to_world">{LOOKAT}</transform>'),
    "thinlens": ('<float name="fov" value="39.3077"/>'
                 '<string name="fov_axis" value="smaller"/>'
                 '<float name="aperture_radius" value="0.05"/>'
                 '<float name="focus_distance" value="3.5"/>'
                 f'<transform name="to_world">{LOOKAT}</transform>'),
    "orthographic": ('<transform name="to_world"><scale value="1.1, 1.1, 1"/>'
                     f'{LOOKAT}</transform>'),
    "radiancemeter": ('<transform name="to_world"><lookat origin="0, 0, 3.9" '
                      'target="0.3, -0.5, 0" up="0, 1, 0"/></transform>'),
    "irradiancemeter": ('<transform name="to_world"><lookat origin="0, '
                        '-0.98, 0.2" target="0, 1, 0.2" up="0, 0, 1"/>'
                        '</transform>'),
    "distant": ('<transform name="to_world"><scale value="0.5, 0.5, 1"/>'
                f'{LOOKAT}</transform>'),
}


# the scene-file phase's card-vs-CPU scenes: (sampler, sensor, rfilter,
# crop window on a 32^2 film), and the sensors it checks on a 4^2 film
XML_COMBOS = (
    ("independent", "batch", "box", None),
    ("stratified", "thinlens", "tent", None),
    ("multijitter", "orthographic", "mitchell", None),
    ("ldsampler", "perspective", "catmullrom", (20, 12, 6, 10)),
    ("orthogonal", "thinlens", "lanczos", None))
XML_METERS = ("radiancemeter", "irradiancemeter", "distant")


def _f(x) -> str:
    """A float as text that reads back to the same double."""
    return repr(float(x))


def write_ply(path: str, vertices, faces):
    """A binary little-endian PLY: double x y z, uchar/int face lists."""
    v = np.ascontiguousarray(vertices, "<f8")
    rows = np.empty(len(faces), [("n", "u1"), ("idx", "<i4", (3,))])
    rows["n"] = 3
    rows["idx"] = faces
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(v)}\nproperty double x\n"
              "property double y\nproperty double z\n"
              f"element face {len(rows)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii") + v.tobytes() + rows.tobytes())


def terrain_xml(dirpath: str, d: dict, name: str) -> str:
    """A terrain dict (terrain64k_dict, small_terrain_dict) as a scene file:
    its mesh as `name`.ply, the rest as `name`.xml (the camera as its
    to_world matrix). Returns the XML file's path."""
    sensor = d["sensor"]
    mtx = " ".join(_f(x) for x in np.asarray(
        sensor["to_world"].matrix).reshape(-1))
    write_ply(os.path.join(dirpath, f"{name}.ply"), d["terrain"]["vertices"],
              d["terrain"]["faces"])
    sun, env = d["sun"], d["env"]
    xml = f"""<scene version="3.0.0">
  <integrator type="{d['integrator']['type']}">
    <integer name="max_depth" value="{d['integrator']['max_depth']}"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="{_f(sensor['fov'])}"/>
    <transform name="to_world"><matrix value="{mtx}"/></transform>
    <film type="hdrfilm">
      <integer name="width" value="{sensor['film']['width']}"/>
      <integer name="height" value="{sensor['film']['height']}"/>
    </film>
    <sampler type="{sensor['sampler']['type']}">
      <integer name="sample_count" value="{sensor['sampler']['sample_count']}"/>
    </sampler>
  </sensor>
  <shape type="ply" id="terrain">
    <string name="filename" value="{name}.ply"/>
    <bsdf type="diffuse"/>
  </shape>
  <emitter type="directional" id="sun">
    <vector name="direction" value="{', '.join(map(_f, sun['direction']))}"/>
    <rgb name="irradiance" value="{', '.join(map(_f, np.atleast_1d(sun['irradiance']['value'])))}"/>
  </emitter>
  <emitter type="constant" id="env">
    <rgb name="radiance" value="{', '.join(map(_f, np.atleast_1d(env['radiance']['value'])))}"/>
  </emitter>
</scene>
"""
    path = os.path.join(dirpath, f"{name}.xml")
    with open(path, "w") as f:
        f.write(xml)
    return path


def _sensor_xml(kind: str, width: int, height: int, sampler: str,
                rfilter: str, crop) -> str:
    """A Cornell file's sensor: `kind` in XML_SENSORS, or "batch" (a
    perspective and an orthographic sub-sensor side by side)."""
    film = (f'<integer name="width" value="{width}"/>'
            f'<integer name="height" value="{height}"/>')
    if crop:
        film += "".join(
            f'<integer name="{k}" value="{v}"/>' for k, v in zip(
                ("crop_width", "crop_height", "crop_offset_x",
                 "crop_offset_y"), crop))
    body = (f'<film type="hdrfilm">{film}<rfilter type="{rfilter}"/></film>'
            f'<sampler type="{sampler}">'
            '<integer name="sample_count" value="$spp"/></sampler>')
    if kind == "batch":
        body = "".join(f'<sensor type="{k}">{XML_SENSORS[k]}</sensor>'
                       for k in ("perspective", "orthographic")) + body
    else:
        body = XML_SENSORS[kind] + body
    return f'  <sensor type="{kind}">{body}</sensor>'


def cornell_xml(mi, dirpath: str, width: int, height: int,
                max_depth: int = 8, spp: int = 16,
                sampler: str = "independent", sensor: str = "perspective",
                rfilter: str = "gaussian", crop=None,
                integrator: str = "path") -> str:
    """``mi.cornell_box`` as a user's scene file: its five walls as OBJ
    files in world space, the light a rectangle and the boxes cubes placed
    by XML transforms, the BSDFs by id and ``<ref>``, ``$spp`` and
    ``$integrator`` as ``<default>``s; `sensor` in XML_SENSORS or
    "batch", `crop` (crop_width, crop_height, crop_offset_x,
    crop_offset_y) or None. `mi` is a package (the port or the JAX one),
    whose cornell_box places the walls. Returns the XML file's path."""
    d = mi.cornell_box(8, 8)
    shapes = []
    for wall, bsdf in CORNELL_WALLS.items():
        v = d[wall]["to_world"].transform_point(np.asarray(RECT_V))
        lines = [f"v {_f(x)} {_f(y)} {_f(z)}" for x, y, z in v]
        lines += ["vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1",
                  "f 1/1 2/2 3/3", "f 3/3 4/4 1/1"]
        with open(os.path.join(dirpath, f"{wall}.obj"), "w") as f:
            f.write("\n".join(lines) + "\n")
        shapes.append(f'  <shape type="obj" id="{wall}"><string '
                      f'name="filename" value="{wall}.obj"/>'
                      f'<ref id="{bsdf}"/></shape>')
    bsdfs = "\n".join(
        f'  <bsdf type="diffuse" id="{k}"><rgb name="reflectance" value="'
        + ", ".join(map(_f, d[k]["reflectance"]["value"])) + '"/></bsdf>'
        for k in ("white", "green", "red"))
    radiance = ", ".join(map(_f, d["light"]["emitter"]["radiance"]["value"]))
    xml = f"""<scene version="3.0.0">
  <default name="spp" value="{spp}"/>
  <default name="integrator" value="{integrator}"/>
  <integrator type="$integrator">
    <integer name="max_depth" value="{max_depth}"/>
  </integrator>
{_sensor_xml(sensor, width, height, sampler, rfilter, crop)}
{bsdfs}
  <shape type="rectangle" id="light">
    <transform name="to_world"><scale value="0.23, 0.19, 0.19"/>
      <rotate x="1" angle="90"/><translate value="0, 0.99, 0.01"/>
    </transform>
    <ref id="white"/>
    <emitter type="area"><rgb name="radiance" value="{radiance}"/></emitter>
  </shape>
{chr(10).join(shapes)}
  <shape type="cube" id="small-box">
    <transform name="to_world"><scale value="0.3"/>
      <rotate y="1" angle="-17"/><translate value="0.335, -0.7, 0.38"/>
    </transform>
    <ref id="white"/>
  </shape>
  <shape type="cube" id="large-box">
    <transform name="to_world"><scale value="0.3, 0.61, 0.3"/>
      <rotate y="1" angle="18.25"/><translate value="-0.33, -0.4, -0.28"/>
    </transform>
    <ref id="white"/>
  </shape>
</scene>
"""
    name = f"cornell_{sampler}_{sensor}_{rfilter}_{width}x{height}.xml"
    path = os.path.join(dirpath, name)
    with open(path, "w") as f:
        f.write(xml)
    return path


# the textures phase: texture and environment image sizes
TEX_SIDE = 1024            # the textured Cornell's floor and normal map
TERRAIN_TEX_SIDE = 2048    # the textured terrain's reflectance
ENV_SIZE = (1024, 2048)    # the terrain's envmap, height x width
TEXTURE_FILES = ("floor.exr", "normals.png", "diffuse.png", "opacity.pfm")
WHITE = [0.885809, 0.698859, 0.666422]


def write_cornell_textures(dirpath: str, side: int = TEX_SIDE,
                           seed: int = 7):
    """The textured Cornell's image files, made from a seed and written by
    the port's own writers: ``floor.exr`` (side^2 float RGB tiles with
    noise), ``normals.png`` (side^2 8-bit RGB), ``diffuse.png`` ((side/2)^2
    8-bit RGB, sRGB-encoded by ``write_image``) and ``opacity.pfm``
    ((side/4)^2 RGB, gray values: a gray PFM reads as one channel, which
    no texture takes)."""
    from mitsuba3_tpu_torch.utils import image_io
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side] * (8.0 / side)
    tiles = ((np.floor(yy) + np.floor(xx)) % 2)[..., None]
    floor = (0.25 + 0.5 * tiles * np.array([0.9, 0.7, 0.5])
             + 0.1 * rng.random((side, side, 3)))
    image_io.write_image(os.path.join(dirpath, "floor.exr"), floor)
    normals = np.concatenate([rng.integers(96, 160, (side, side, 2)),
                              rng.integers(200, 256, (side, side, 1))], -1)
    image_io.write_png(os.path.join(dirpath, "normals.png"),
                       normals.astype(np.uint8))
    image_io.write_image(os.path.join(dirpath, "diffuse.png"),
                         rng.random((side // 2, side // 2, 3)))
    q = side // 4
    opacity = np.clip(np.hypot(*(np.mgrid[0:q, 0:q] / q - 0.5)) * 2.2, 0, 1)
    image_io.write_image(os.path.join(dirpath, "opacity.pfm"),
                         np.repeat(opacity[..., None], 3, -1))


def textured_cornell_dict(mi, root: str, width: int, height: int,
                          max_depth: int = 8, spp: int = 16) -> dict:
    """``mi.cornell_box`` with four surfaces textured from the files of
    write_cornell_textures under `root` ("" for names relative to a scene
    file): the floor a mipmapped ``.exr`` bitmap; the back wall a
    checkerboard; the large box a normalmap (``normals.png``, raw) around a
    roughplastic whose diffuse reflectance is ``diffuse.png``
    (sRGB-decoded, mirror wrap); the small box a mask whose opacity is
    ``opacity.pfm`` (clamp wrap, nearest filter) around a diffuse. Every
    wrap mode and filter occurs. `mi` is a package (the port or the JAX
    one)."""
    d = mi.cornell_box(width, height, spp=spp, max_depth=max_depth)

    def f(name):
        return os.path.join(root, name)

    d["floor"]["bsdf"] = {"type": "diffuse", "reflectance": {
        "type": "bitmap", "filename": f("floor.exr"), "mipmap": True}}
    d["back"]["bsdf"] = {"type": "diffuse", "reflectance": {
        "type": "checkerboard", "color0": 0.75, "color1": 0.2,
        "to_uv": mi.ScalarTransform4f().scale([3.0, 3.0, 1.0])}}
    d["large-box"]["bsdf"] = {
        "type": "normalmap",
        "normalmap": {"type": "bitmap", "filename": f("normals.png"),
                      "raw": True},
        "bsdf": {"type": "roughplastic", "alpha": 0.2,
                 "diffuse_reflectance": {
                     "type": "bitmap", "filename": f("diffuse.png"),
                     "wrap_mode": "mirror"}}}
    d["small-box"]["bsdf"] = {
        "type": "mask",
        "opacity": {"type": "bitmap", "filename": f("opacity.pfm"),
                    "wrap_mode": "clamp", "filter_type": "nearest"},
        "bsdf": {"type": "diffuse",
                 "reflectance": {"type": "rgb", "value": WHITE}}}
    return d


def textured_cornell_xml(mi, dirpath: str, width: int, height: int,
                         max_depth: int = 8, spp: int = 16) -> str:
    """textured_cornell_dict with the ``prb`` integrator, written as a
    scene file by the port's ``write_file`` into `dirpath`, beside the
    texture files, which it names relative to itself. Returns the XML
    file's path."""
    from mitsuba3_tpu_torch.utils import xml as xml_mod
    d = _prb_dict(textured_cornell_dict(mi, "", width, height, max_depth,
                                        spp))
    path = os.path.join(dirpath, f"textured_cornell_{width}x{height}.xml")
    xml_mod.write_file(d, path)
    return path


def write_terrain_textures(dirpath: str, side: int = TERRAIN_TEX_SIDE,
                           env_size=ENV_SIZE, seed: int = 11):
    """The textured terrain's images: ``terrain.exr`` (side^2 float RGB:
    greens and browns with noise) and ``sky.hdr`` (an RGBE lat-long map,
    env_size = (height, width): a blue gradient with a bright sun region
    around the directional sun's direction)."""
    from mitsuba3_tpu_torch.utils import image_io
    rng = np.random.default_rng(seed)
    t = rng.random((side, side, 1))
    tex = (np.array([0.18, 0.35, 0.12]) * (1 - t)
           + np.array([0.45, 0.33, 0.2]) * t
           + 0.05 * rng.random((side, side, 3)))
    image_io.write_image(os.path.join(dirpath, "terrain.exr"), tex)
    h, w = env_size
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    # uv_to_dir: (sin t sin p, cos t, -sin t cos p), y up in the map
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    d = np.stack(np.broadcast_arrays(st * np.sin(phi), ct,
                                     -st * np.cos(phi)), -1)
    sun = -np.array([0.3, 0.3, -1.0]) / np.linalg.norm([0.3, 0.3, -1.0])
    sky = (np.array([0.35, 0.5, 0.8]) * (0.4 + 0.6 * np.abs(ct))[..., None]
           * np.ones((h, w, 1)))
    sky = sky + 50.0 * (d @ sun > 0.995)[..., None]
    image_io.write_image(os.path.join(dirpath, "sky.hdr"), sky)


def textured_terrain_dict(make_dict, transform, root: str, **kw) -> dict:
    """`make_dict(transform, **kw)` (terrain64k_dict or small_terrain_dict)
    with planar uvs from x and y, the reflectance ``terrain.exr`` under
    `root` (mipmapped, to_uv a scale of 4) and an envmap ``sky.hdr`` in
    place of the constant environment; the sun stays."""
    d = make_dict(transform, **kw)
    v = np.asarray(d["terrain"]["vertices"], np.float64)
    lo, hi = v[:, :2].min(0), v[:, :2].max(0)
    d["terrain"] = dict(d["terrain"], uvs=(v[:, :2] - lo) / (hi - lo),
                        bsdf={"type": "diffuse", "reflectance": {
                            "type": "bitmap",
                            "filename": os.path.join(root, "terrain.exr"),
                            "mipmap": True,
                            "to_uv": transform().scale([4.0, 4.0, 1.0])}})
    d["env"] = {"type": "envmap",
                "filename": os.path.join(root, "sky.hdr")}
    return d


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def _check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _cuda_ms(fn, reps: int, warm: bool = True):
    """Mean milliseconds of fn() over `reps` launches (CUDA events, after
    one warm-up call unless `warm` is False)."""
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, key: str, reps: int = 1, warm: bool = True):
    """(device ms, launches) of the CUDA kernels whose name holds `key`
    over `reps` calls of fn() under torch.profiler (CUDA activity only),
    after one warm-up call unless `warm` is False."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and key in e.key]
    return (sum(e.device_time_total for e in events) / 1e3,
            sum(e.count for e in events))


def _bound(ops: float, nbytes: float):
    """(bound_ms, bound_by, ops_ms, bytes_ms): the least time for `ops`
    fp32 operations and `nbytes` bytes of traffic at the card's peaks."""
    ops_ms = ops / PEAK_FP32_OPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    by = "operations" if ops_ms >= bytes_ms else "bytes"
    return max(ops_ms, bytes_ms), by, ops_ms, bytes_ms


def _row(name, tpu, source, replaces, mode, err, k_ms, p_ms, ops, nbytes,
         card, **extra):
    """One kernel's entry of the `kernels` line, printed as a comment."""
    bound_ms, by, ops_ms, bytes_ms = _bound(ops, nbytes)
    print(f"# {tpu} {name}: kernel {k_ms:.4f} ms, plain {p_ms:.2f} ms, "
          f"bound {bound_ms:.4f} ms by {by} (ops {ops:.4g} -> {ops_ms:.4f} "
          f"ms, bytes {nbytes:.4g} -> {bytes_ms:.4f} ms), "
          f"{k_ms / bound_ms:.1f}x the bound [{card}]")
    return {"name": name, "mode": mode, "route": "cuda",
            "source": f"mitsuba3_tpu_torch/csrc/{source}",
            "replaces": replaces, "tpu_kernel": tpu, "launches": None,
            "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None, "library_note": LIBRARY_NOTE, **extra}


def _hold_t(tag, kt, pt, hit, kp=None, pp=None):
    """Kernel t within rtol 1e-5 of the plain t on `hit` lanes; with prim,
    prim equal on >= 99.9 % of them and, where it differs, the kernel's t
    no larger. Returns (max |dt|, prim match share)."""
    import torch
    err = (kt[hit] - pt[hit]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    _check(bool(torch.all(err <= 1e-5 * pt[hit].abs())),
           f"{tag}: t differs beyond rtol 1e-5 (max abs err {max_err:.3g})")
    frac = 1.0
    if kp is not None:
        same = kp[hit] == pp[hit]
        frac = float(same.float().mean()) if same.numel() else 1.0
        _check(frac >= 0.999, f"{tag}: prim matches on only {frac:.5f} of "
               f"hit lanes")
        _check(bool(torch.all(kt[hit][~same] <= pt[hit][~same] + 1e-4)),
               f"{tag}: where prim differs the kernel's t is larger")
    print(f"# {tag}: {int(hit.sum())} hit lanes, max |dt| {max_err:.3g}, "
          f"prim match {frac:.6f}")
    return max_err, frac


def _hold_equal(tag, kernel_out, plain_out, names):
    """Each named output of a kernel bit-equal to its plain version's."""
    import torch
    for name, k, p in zip(names, kernel_out, plain_out):
        _check(torch.equal(k, p), f"{tag}: {name} differs from the plain "
               f"version on {int((k != p).sum())} of {k.numel()} lanes")
    print(f"# {tag}: {', '.join(names)} bit-equal to the plain version")


def _primary_rays(scene):
    """The 1,048,576 primary rays of the terrain64k camera (one pass)."""
    from mitsuba3_tpu_torch.render import integrator as ri
    sppc, _ = ri.plan_passes(scene, 4, 1 << 20)
    return ri._gen_camera_rays(scene, ri.pass_seed(0, 0), sppc, 0, 4)[1]


def _bounce_rays(scene):
    """The second round of the terrain64k camera's pass: the primary rays
    that hit, continued in the direction their BSDF samples (the glossy
    terrain's roughplastic lobe), as the path integrator spawns them."""
    import torch
    from mitsuba3_tpu_torch import bsdfs
    from mitsuba3_tpu_torch.core.struct import take_lanes
    from mitsuba3_tpu_torch.core.vec import Vec2, Vec3
    from mitsuba3_tpu_torch.render.records import Ray

    ray = _primary_rays(scene)
    pi = scene.ray_intersect_preliminary(ray)
    si, attrs = scene.compute_surface_interaction(ray, pi)
    hit = torch.nonzero(si.is_valid()).squeeze(1)
    n = si.t.shape[0]
    si = take_lanes(si, hit, n)
    gen = torch.Generator(device=scene.device).manual_seed(0)
    u = torch.rand((3, hit.shape[0]), generator=gen, device=scene.device)
    bs, _ = bsdfs.sample(scene, attrs["bsdf"][hit], si, u[0],
                         Vec2(u[1], u[2]))
    d = si.to_world(bs.wo)
    return Ray.make(si.offset_p(d), Vec3(d.x.contiguous(), d.y.contiguous(),
                                         d.z.contiguous()))


def _k1_tests(tris, r0, nr, n_pairs: int):
    """Ray-triangle tests one K1 launch needs, as a device scalar: every
    real pair of a sub-block tests every real triangle (id >= 0) of the
    rows of its window; the padding pairs, all in the last sub-block, need
    none."""
    import torch
    real = torch.cat([torch.zeros(1, dtype=torch.int64, device=nr.device),
                      (tris[:, 9] >= 0).sum(dim=1).cumsum(0)])
    win = real[(r0 + nr).long()] - real[r0.long()]
    return K * win.sum() - (r0.shape[0] * K - n_pairs) * win[-1]


def _k1_bytes(tris, n_pad: int, n_sub: int, want_uv: bool):
    """Bytes one K1 launch must move: the slab table, the pairs' rays in,
    t (and prim, u, v) out, and the windows."""
    return tris.numel() * 4 + n_pad * (24 + (16 if want_uv else 4)) \
        + n_sub * 8


def _k1_row(card: str, tag: str, mode: str, tris, rays, r0, nr,
            n_pairs: int, **extra):
    """K1 in `mode` on one launch's inputs (the slab table, the pair rays,
    the sub-blocks' windows) held bit-equal to its plain version, BIG (no
    hit) on the same pairs, and timed against it: the kernels row named
    ``cellserve_serve.{mode}{tag}``, with `extra` in it."""
    from mitsuba3_tpu_torch.ops import cellserve as cs
    want_uv = mode == "closest"
    kout = cs.serve_blocks(tris, rays, r0, nr, want_uv)
    pout = cs.serve_blocks_plain(tris, rays, r0, nr, want_uv)
    # the comparison call above is the plain version's warm-up
    p_ms = _cuda_ms(lambda: cs.serve_blocks_plain(tris, rays, r0, nr,
                                                  want_uv), 2, warm=False)
    (kt, kp, _, _), (pt, pp, _, _) = kout, pout
    big_k, big_p = kt >= cs.BIG, pt >= cs.BIG
    _check(bool((big_k == big_p).all()),
           f"K1 {mode}{tag}: BIG (no hit) differs on "
           f"{int((big_k != big_p).sum())} pairs")
    err, _ = _hold_t(f"K1 {mode}{tag}", kt, pt, ~big_p,
                     *((kp, pp) if want_uv else ()))
    _hold_equal(f"K1 {mode}{tag}", kout, pout,
                ("t", "prim", "u", "v") if want_uv else ("t",))
    k_ms = _cuda_ms(lambda: cs.serve_blocks(tris, rays, r0, nr, want_uv), 20)
    tests = int(_k1_tests(tris, r0, nr, n_pairs))
    return _row(
        f"cellserve_serve.{mode}{tag}", "K1", "cellserve_serve.cu",
        "mitsuba3_tpu/ops/cellserve.py:348", mode, err, k_ms, p_ms,
        tests * OPS_PER_TEST, _k1_bytes(tris, rays.shape[1], r0.shape[0],
                                        want_uv), card,
        pairs=n_pairs, tests=tests, sub_blocks=int(r0.shape[0]), **extra)


def phase_kernels(mi, card: str, make_dict=None, tag: str = "",
                  rays_of=None, accel_of=None):
    """K1 against its plain version on one full-width round (the primary
    rays of one pass, or the rays ``rays_of(scene)`` gives) of a main path
    through cellserve: terrain64k by default, or the scene `make_dict`
    makes (its rows' names end in `tag`), on its accel or on the cellserve
    ``accel_of(scene)`` gives (an instanced prototype's)."""
    import torch
    from mitsuba3_tpu_torch.ops import cellserve as cs

    scene = mi.load_dict((make_dict or terrain64k_dict)(mi.ScalarTransform4f))
    acc = scene.accel if accel_of is None else accel_of(scene)
    ray = (rays_of or _primary_rays)(scene)
    n = ray.o.x.shape[0]
    og, dg = cs._grid_ray(acc, ray.o, ray.d)
    t_in, t_out, inv = cs._clip(acc, og, dg, ray.maxt)
    active = t_in <= t_out
    slots, _, _ = cs._pairgen(acc, og, dg, inv, t_in, t_out, active,
                              torch.zeros_like(t_in))
    pair, rays, r0, nr = cs.sort_pairs(acc, slots, ray.o, ray.d)
    n_pairs = pair.shape[0]
    n_sub = r0.shape[0]
    sum_nr = int(nr.sum())
    print(f"# kernels{tag}: {n} lanes, {n_pairs} pairs, {n_sub} sub-blocks, "
          f"sum(nr) = {sum_nr} rows, slab table {acc.tris.shape[0]} rows "
          f"({acc.tris.numel() * 4 / 1e6:.1f} MB), res {acc.res}")

    rows = [_k1_row(card, tag, mode, acc.tris, rays, r0, nr, n_pairs,
                    accel="cells" + tag, sum_nr=sum_nr)
            for mode in ("closest", "anyhit")]
    del scene
    torch.cuda.empty_cache()
    return rows


class _K1Meter:
    """Inside ``with``, every K1 launch of the cellserve queries is timed
    by CUDA events around ``serve_blocks`` and its ray-triangle tests are
    counted (``_k1_tests``, on the device; read after the run), and each
    query (``_trace``) records how many rounds, K1 launches, it took.
    ``summary()`` gives per mode the launches, device ms and bound ms,
    and the queries' rounds. With `keep_largest`, ``largest[mode]`` holds
    the inputs (tris, rays, r0, nr, pairs) of the mode's launch with the
    most sub-blocks, for _k1_row."""

    def __init__(self, keep_largest: bool = False):
        self.keep_largest = keep_largest
        self.largest = {}

    def __enter__(self):
        import torch
        from mitsuba3_tpu_torch.ops import cellserve as cs
        self.cs, self.launches, self.queries = cs, [], []
        self.saved = (cs.sort_pairs, cs.serve_blocks, cs._trace)
        real_sort, real_serve, real_trace = self.saved
        last = {}

        def sort_pairs(acc, slots, o, d):
            out = real_sort(acc, slots, o, d)
            last["pairs"] = out[0].shape[0]
            return out

        def serve_blocks(tris, rays, r0, nr, want_uv):
            if r0.shape[0] == 0:      # no sub-block: no launch
                return real_serve(tris, rays, r0, nr, want_uv)
            mode = "closest" if want_uv else "anyhit"
            if self.keep_largest and (
                    mode not in self.largest
                    or r0.shape[0] > self.largest[mode][2].shape[0]):
                self.largest[mode] = (tris, rays, r0, nr, last["pairs"])
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = real_serve(tris, rays, r0, nr, want_uv)
            ev[1].record()
            self.launches.append((
                mode, ev,
                _k1_tests(tris, r0, nr, last["pairs"]),
                _k1_bytes(tris, rays.shape[1], r0.shape[0], want_uv)))
            return out

        def trace(acc, o, d, maxt, active, closest):
            before = len(self.launches)
            out = real_trace(acc, o, d, maxt, active, closest)
            self.queries.append(("closest" if closest else "anyhit",
                                 len(self.launches) - before))
            return out

        cs.sort_pairs, cs.serve_blocks, cs._trace = (sort_pairs,
                                                     serve_blocks, trace)
        return self

    def __exit__(self, *exc):
        self.cs.sort_pairs, self.cs.serve_blocks, self.cs._trace = self.saved

    def summary(self):
        import torch
        torch.cuda.synchronize()
        out = {}
        for mode in ("closest", "anyhit"):
            runs = [r for r in self.launches if r[0] == mode]
            rounds = [k for m, k in self.queries if m == mode]
            tests = sum(int(r[2]) for r in runs)
            out[mode] = {
                "launches": len(runs),
                "device_ms": sum(r[1][0].elapsed_time(r[1][1])
                                 for r in runs),
                "bound_ms": sum(_bound(int(r[2]) * OPS_PER_TEST, r[3])[0]
                                for r in runs),
                "tests": tests, "queries": len(rounds),
                "rounds_per_query": len(runs) / max(len(rounds), 1),
                "max_rounds": max(rounds, default=0)}
        return out


class _K4Meter:
    """Inside ``with``, every K4 launch (``bvh_tiled.run_round``) is counted
    per mode with the ray-triangle tests its data needs, by K4's own cull:
    the plain version runs first on the launch's inputs with ``stats``
    (a slot is taken only while its entry is at or below the tile's worst
    t, and in any-hit mode a ray stops at its first hit), K4_METER_TILES
    tiles a step; and its bytes (the slab table, the slots, the rays in
    and out). It doubles a render's work: meter a render that is not
    timed. ``summary()`` gives per mode the launches, the tests and the
    summed bound ms."""

    def __init__(self):
        self.launches = []

    def __enter__(self):
        from mitsuba3_tpu_torch.ops import bvh_tiled as bt
        self.bt = bt
        self.saved = bt.run_round, bt.PLAIN_TILES
        real = self.saved[0]

        def run_round(leaf_ids, entries, tris, o3, d3, t, prim, u, v,
                      closest):
            args = (leaf_ids, entries, tris, o3, d3, t, prim, u, v)
            if leaf_ids.shape[0] == 0:      # no tile: no launch
                return real(*args, closest)
            work = {}
            bt.run_round_plain(*args, closest, stats=work)
            nbytes = (tris.numel() * 4 + leaf_ids.numel() * 8
                      + t.shape[0] * (24 + 16 + (16 if closest else 8)))
            self.launches.append(("closest" if closest else "anyhit",
                                  work.get("tests", 0), nbytes))
            return real(*args, closest)

        bt.run_round, bt.PLAIN_TILES = run_round, K4_METER_TILES
        return self

    def __exit__(self, *exc):
        self.bt.run_round, self.bt.PLAIN_TILES = self.saved

    def summary(self):
        out = {}
        for mode in ("closest", "anyhit"):
            runs = [r for r in self.launches if r[0] == mode]
            out[mode] = {
                "launches": len(runs),
                "tests": sum(r[1] for r in runs),
                "bound_ms": sum(_bound(r[1] * OPS_PER_TEST, r[2])[0]
                                for r in runs)}
        return out


# tiles a step of the K4 meter's plain version: [256, 128, 1024] f32
# temporaries of 128 MiB (bvh_tiled.PLAIN_TILES is 16)
K4_METER_TILES = 256


@contextlib.contextmanager
def _accel(name):
    """MI3T_ACCEL=name inside, restored after."""
    old = os.environ.get("MI3T_ACCEL")
    os.environ["MI3T_ACCEL"] = name
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MI3T_ACCEL")
        else:
            os.environ["MI3T_ACCEL"] = old


def _hold_cull(tag, name, acc, f, lk, card):
    """K2 against cull_plain on one cull of the rays f with cursors lk:
    keys bit-equal; timed. Returns (its kernel row named `name`, the
    keys)."""
    import torch
    from mitsuba3_tpu_torch.ops import bvh_serve as bs

    npad = f.shape[1]
    kb = bs.cull(acc, f, lk)
    work = {}
    pb = bs.cull_plain(acc, f, lk, stats=work)
    torch.cuda.synchronize()
    _check(torch.equal(kb, pb), f"{tag}: keys differ on "
           f"{int((kb != pb).sum())} of {kb.numel()}")
    n_chunks = acc.m_pad // bs.LC
    print(f"# {tag}: keys bit-equal; {int((lk != bs.NONE).sum())} of {npad} "
          f"cursors not NONE, {int((pb[0] != bs.NONE).sum())} rays request "
          f"a leaf; {work['chunks_taken']} of {n_chunks * npad // bs.RCHUNK}"
          f" (block, chunk) and {work['warps_taken']} of "
          f"{n_chunks * npad // 32} (warp, chunk) pairs taken; "
          f"{work['sup_tests']} chunk-box and {work['box_tests']} leaf-box "
          f"tests needed")
    k_ms = _cuda_ms(lambda: bs.cull(acc, f, lk), 20)
    p_ms = _cuda_ms(lambda: bs.cull_plain(acc, f, lk), 2)
    ops = work["sup_tests"] * OPS_PER_SUP + work["box_tests"] * OPS_PER_BOX
    nbytes = (acc.bounds.numel() + acc.sup.numel()) * 4 \
        + npad * (32 + 4 * acc.topk)
    return _row(name, "K2", "bvh_serve_cull.cu",
                "mitsuba3_tpu/ops/bvh_serve.py:112", "cull", 0.0, k_ms, p_ms,
                ops, nbytes, card, accel="serve", **work), pb


def phase_kernels_serve(mi, card: str):
    """K2 (the first cull, and a late one) and K3 (the first block serve
    after the leaf sort) of a bvh_serve query on the terrain64k primary
    rays, against their plain versions. The late cull is the first after
    the round loop (the kernels' own; one round at least) has left at
    most LATE_LIVE of the width live, with the finished rays' NONE
    cursors."""
    import torch
    from mitsuba3_tpu_torch.ops import bvh_serve as bs

    with _accel("serve"):
        scene = mi.load_dict(terrain64k_dict(mi.ScalarTransform4f))
    acc = scene.accel
    ray = _primary_rays(scene)
    f, i = bs.initial_state(ray.o, ray.d, ray.maxt)
    npad = f.shape[1]
    print(f"# kernels (serve): {npad} lanes, {acc.n_leaves} leaves "
          f"(m_pad {acc.m_pad}), slab table {acc.tris.numel() * 4 / 1e6:.1f}"
          f" MB, topk {acc.topk}")
    # K2: the first cull
    row, pb = _hold_cull("K2", "bvh_serve_cull", acc, f, i[bs.LK], card)
    rows = [row]
    live = (pb[0] != bs.NONE) & (i[bs.RID] >= 0)

    # K3: the first block serve, after the sort by requested leaf
    fs, _, leaf_all, _, _ = bs.sort_requests(acc, f, i, pb, live)
    blk = bs.block_ids(acc, leaf_all)
    kout = bs.serve_blocks(acc, blk, fs, leaf_all)
    work = {}
    pout = bs.serve_blocks_plain(acc, blk, fs, leaf_all, stats=work)
    torch.cuda.synchronize()
    _hold_equal("K3", kout, pout, ("t", "prim", "u", "v", "srv"))
    hit = pout[0] < bs.BIG
    err = float((kout[0][hit] - pout[0][hit]).abs().max()) \
        if bool(hit.any()) else 0.0
    tests = work["tests"]
    k_ms = _cuda_ms(lambda: bs.serve_blocks(acc, blk, fs, leaf_all), 20)
    p_ms = _cuda_ms(lambda: bs.serve_blocks_plain(acc, blk, fs, leaf_all), 2)
    nbytes = (acc.tris.numel() * 4 + blk.numel() * 4
              + npad * (28 + 4 * acc.topk + 20))
    print(f"# K3: {int((pout[4] != 0).sum())} rays served, {int(hit.sum())} "
          f"hit, {tests} ray-triangle tests needed")
    rows.append(_row("bvh_serve_serve", "K3", "bvh_serve_serve.cu",
                     "mitsuba3_tpu/ops/bvh_serve.py:273", "serve", err, k_ms,
                     p_ms, tests * (OPS_PER_TEST + 1), nbytes, card,
                     accel="serve", tests=tests))

    # K2: a late cull, after closest-hit rounds at full width
    best, live = bs._cull_state(acc, f, i)
    n_live, rounds = int(live.sum()), 0
    while rounds == 0 or n_live > LATE_LIVE * npad:
        _check(rounds < 100, f"K2 late: {n_live} rays still live after "
               f"{rounds} rounds")
        f, i = bs._round_once(acc, f, i, best, live, n_live, True)
        best, live = bs._cull_state(acc, f, i)
        n_live, rounds = int(live.sum()), rounds + 1
    print(f"# K2 late: after {rounds} rounds {n_live} of {npad} rays live")
    row, _ = _hold_cull("K2 late", "bvh_serve_cull.late", acc, f, i[bs.LK],
                        card)
    rows.append(dict(row, rounds=rounds, live=n_live))
    del scene
    torch.cuda.empty_cache()
    return rows


def phase_kernels_tiled(mi, card: str):
    """K4: the first 16-slot round of a bvh_tiled query on the terrain64k
    primary rays, closest and any-hit, against its plain version."""
    import torch
    from mitsuba3_tpu_torch.ops import bvh_tiled as bt

    with _accel("tiled"):
        scene = mi.load_dict(terrain64k_dict(mi.ScalarTransform4f))
    acc = scene.accel
    ray = _primary_rays(scene)
    maxt = torch.clamp(ray.maxt, max=3e38)
    (ox, oy, oz, dx, dy, dz, mt_s), _ = bt._pack_sorted(acc, ray.o, ray.d,
                                                         maxt)
    ids_s, ents_s = bt._sort_leaf_lists(
        bt._tile_leaf_lists(acc, ox, oy, oz, dx, dy, dz, mt_s))
    npad = mt_s.shape[0]
    n_tiles = npad // bt.TILE
    args = (ids_s[:, :bt.LB_USE].contiguous(),
            ents_s[:, :bt.LB_USE].contiguous(), acc.tris,
            torch.stack([ox, oy, oz]), torch.stack([dx, dy, dz]), mt_s,
            torch.full((npad,), -1, dtype=torch.int32, device=mt_s.device),
            torch.zeros_like(mt_s), torch.zeros_like(mt_s))
    print(f"# kernels (tiled): {npad} lanes in {n_tiles} tiles, "
          f"{acc.n_leaves} leaves, {int((ids_s >= 0).sum())} tile-leaf "
          f"overlaps, slab table {acc.tris.numel() * 4 / 1e6:.1f} MB")
    rows = []
    for closest, mode in ((True, "closest"), (False, "anyhit")):
        kout = bt.run_round(*args, closest)
        work = {}
        pout = bt.run_round_plain(*args, closest, stats=work)
        torch.cuda.synchronize()
        (kt, kp, _, _), (pt, pp, _, _) = kout, pout
        _check(torch.equal(kp >= 0, pp >= 0), f"K4 {mode}: hit sets differ")
        hit = pp >= 0
        if closest:
            err, _ = _hold_t(f"K4 {mode}", kt, pt, hit, kp, pp)
            miss = ~hit
            _check(torch.equal(kt[miss], pt[miss]),
                   f"K4 {mode}: t differs where nothing was hit")
            _hold_equal(f"K4 {mode}", kout, pout, ("t", "prim", "u", "v"))
        else:
            _check(torch.equal(kt, pt) and torch.equal(kp, pp),
                   f"K4 {mode}: results differ")
            err = 0.0
            print(f"# K4 {mode}: {int(hit.sum())} occluded lanes, equal")
        slots, tests = work["slots"], work["tests"]
        k_ms = _cuda_ms(lambda: bt.run_round(*args, closest), 20)
        p_ms = _cuda_ms(lambda: bt.run_round_plain(*args, closest), 2)
        out_b = 16 if closest else 8
        nbytes = (acc.tris.numel() * 4 + n_tiles * bt.LB_USE * 8
                  + npad * (24 + 16 + out_b))
        print(f"# K4 {mode}: {slots} of {n_tiles * bt.LB_USE} (tile, slot) "
              f"pairs taken, {tests} ray-triangle tests needed")
        rows.append(_row(f"bvh_tiled_mt.{mode}", "K4", "bvh_tiled_mt.cu",
                         "mitsuba3_tpu/ops/bvh_tiled.py:243", mode, err,
                         k_ms, p_ms, tests * OPS_PER_TEST, nbytes, card,
                         accel="tiled", slots_taken=slots, tests=tests))
    del scene
    torch.cuda.empty_cache()
    return rows


def _bvh_rays(kind: str):
    """bench_bvh's 2^19 rays of `kind` on the card: (o, d, maxt 1e30)."""
    import torch
    from mitsuba3_tpu_torch.core.vec import Vec3

    def vec(a):
        t = torch.as_tensor(a, device="cuda")
        return Vec3(*(t[:, i].contiguous() for i in range(3)))

    o, d = make_rays(BVH_RAYS, 1, kind)
    return vec(o), vec(d), torch.full((BVH_RAYS,), 1e30, device="cuda")


def _hold_closest(tag, kout, pout):
    """A closest-hit kernel's (t, prim, u, v) bit-equal to its plain
    version's, after _hold_hits' checks (which print max |dt| and the prim
    match share). Returns max |dt| on the hit lanes (0 when equal)."""
    err = _hold_hits(tag, kout[0], kout[1], pout[0], pout[1], True)
    _hold_equal(tag, kout, pout, ("t", "prim", "u", "v"))
    return err


def _hold_hits(tag, kt, ks, pt, ps, closest: bool):
    """A kernel's (t, slot or prim) against its plain version's: hit sets
    equal; closest: t within rtol 1e-5 and prim by _hold_t's rule, t equal
    where nothing was hit; any-hit: equal. Returns max |dt|."""
    import torch
    hit = ps >= 0
    _check(torch.equal(ks >= 0, hit), f"{tag}: hit sets differ on "
           f"{int(((ks >= 0) != hit).sum())} lanes")
    if closest:
        err, _ = _hold_t(tag, kt, pt, hit, ks, ps)
        _check(torch.equal(kt[~hit], pt[~hit]),
               f"{tag}: t differs where nothing was hit")
        return err
    _check(torch.equal(kt, pt) and torch.equal(ks, ps),
           f"{tag}: results differ")
    print(f"# {tag}: {int(hit.sum())} occluded lanes, equal")
    return 0.0


def _makespan(tile_ops, slots: int) -> float:
    """The largest work of one of `slots` resident CTAs when the tiles, in
    launch order, each go to the CTA slot that frees first."""
    load = [0.0] * slots
    heapq.heapify(load)
    for ops in tile_ops:
        heapq.heappush(load, heapq.heappop(load) + ops)
    return max(load)


def _tile_spread(tag, work, ctas_per_sm: int):
    """Replaces K5's per-tile counts in `work` by the most and the mean
    tests of a tile, and prints them with the tiles' work makespan over
    the resident CTAs: a model, not a measurement, of the time the launch
    needs at the card's peak when each of SMs x `ctas_per_sm` slots issues
    1 / slots of it and the tiles go, in launch order or the heaviest
    first, to the slot that frees first."""
    import torch
    from mitsuba3_tpu_torch.ops.attic import bvh_pallas as bp
    tests = work.pop("tile_tests")
    nodes = work.pop("tile_nodes")
    top, mean = max(tests), sum(tests) / len(tests)
    work.update(tile_tests_max=top, tile_tests_mean=mean)
    slots = torch.cuda.get_device_properties(0).multi_processor_count \
        * ctas_per_sm
    ops = [n * bp.TILE * OPS_PER_NODE + t * OPS_PER_TEST
           for n, t in zip(nodes, tests)]
    rate = PEAK_FP32_OPS / slots / 1e3
    span = _makespan(ops, slots) / rate
    lpt = _makespan(sorted(ops, reverse=True), slots) / rate
    print(f"# {tag}: per-tile ray-triangle tests max {top}, mean {mean:.0f} "
          f"({top / mean:.2f}x the mean); {ctas_per_sm} CTAs per SM, "
          f"{slots} resident: modelled work makespan {span:.4f} ms at the "
          f"peak ({lpt:.4f} ms with the heaviest tiles first)")


def _k5_ctas_per_sm(closest: bool) -> int:
    """CTAs per SM of the loaded K5 build's kernel in this mode."""
    from mitsuba3_tpu_torch.ops import native
    n = native.load("bvh_pallas_traverse").bvh_pallas_traverse_ctas_per_sm(
        int(closest))
    _check(n > 0, f"K5: occupancy query failed (cudaError_t {-n})")
    return n


def phase_kernels_attic(card: str, kernels=("K5", "K6", "K7", "K8"),
                        plain: dict | None = None, k8_device=None):
    """K5-K8 against their plain versions at full width on bench_bvh's
    terrain queries: K5 as intersect_bvh and occluded_bvh pack the primary
    and the bounce rays, and as the sorted queries pack the bounce rays;
    K6 as the first cull of a bvh_queue query on the primary rays, K7 as
    its first serve after the sort and the schedule on either kind, K8 as
    the first round's serve of a bvh2 query on the bounce rays. A row that
    names `queries` counts its launches over those timed queries only.
    `kernels` picks the rows; a dict `plain` keeps K5's and K7's plain
    outputs, their work and times by row, and is read before computing
    them again (tools/kernel_variants.py holds several builds to one).
    K8's row takes its device time from `k8_device` (phase_k8_device's
    result)."""
    import torch
    from mitsuba3_tpu_torch.ops import bvh_serve as bs
    from mitsuba3_tpu_torch.ops.attic import bvh_pallas as bp
    from mitsuba3_tpu_torch.ops.attic import bvh_queue as bq

    tris = make_terrain(BVH_SIDE)
    o, d, maxt = _bvh_rays("primary")
    rows = []
    plain = {} if plain is None else plain

    def held(tag, run):
        """(plain outputs, work, plain ms) of a row, from `plain` or run;
        K5's per-tile counts become their spread (_tile_spread) once, with
        the occupancy of the build loaded then (the shipped one: the tool
        holds it first)."""
        if tag not in plain:
            work = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(work)
            torch.cuda.synchronize()
            plain[tag] = (out, work, (time.perf_counter() - t0) * 1e3)
            if "tile_tests" in work:
                _tile_spread(tag, work,
                             _k5_ctas_per_sm(tag.startswith("K5 closest")))
        return plain[tag]

    # K5: the packet walk, closest and any-hit; on the primary rays as
    # intersect_bvh and occluded_bvh pack them, on the bounce rays also
    # as the sorted queries pack them
    packs = []
    if "K5" in kernels:
        acc = bp.build(*tris, device="cuda")
        print(f"# kernels (bvh_pallas): {acc.node_bounds.shape[0]} nodes, "
              f"{acc.n_leaves} leaves")
        packs = [("", ("pallas", "pallas_sorted"), "primary",
                  bp.pack_rays(o, d, torch.clamp(maxt, max=3e38)))]
        ob, db, maxt_b = _bvh_rays("bounce")
        mt_b = torch.clamp(maxt_b, max=3e38)
        packs.append((".bounce", ("pallas",), "bounce",
                      bp.pack_rays(ob, db, mt_b)))
        packs.append((".bounce_sorted", ("pallas_sorted",), "bounce",
                      bp.pack_rays(*bp._sorted(acc, ob, db, mt_b)[:3])))
    for suffix, accels, kind, full in packs:
        for closest, mode in ((True, "closest"), (False, "anyhit")):
            tag = f"K5 {mode}{suffix.replace('.', ' ')}"
            # the primary closest row is held at full width, the others on
            # their first K5_HELD_RAYS rays (whole tiles: the tiles walk
            # independently), which takes their plain versions ~110 s less
            sub = not (closest and not suffix)
            o3, d3, mt = ((a[..., :K5_HELD_RAYS].contiguous()
                           for a in full) if sub else full)
            npad = mt.shape[0]
            kout = bp.traverse(acc, o3, d3, mt, closest)
            if sub:
                k_full = _cuda_ms(lambda: bp.traverse(acc, *full, closest),
                                  10)
                kfull = bp.traverse(acc, *full, closest)
                _check(all(torch.equal(a[:npad], b)
                           for a, b in zip(kfull, kout)),
                       f"{tag}: the full-width kernel's first {npad} lanes "
                       f"differ from the kernel's on them alone")
            pout, work, p_ms = held(tag, lambda w: bp.traverse_plain(
                acc, o3, d3, mt, closest, stats=w))
            if closest:
                err = _hold_closest(tag, kout, pout)
            else:
                err = _hold_hits(tag, kout[0], kout[1], pout[0], pout[1],
                                 False)
            k_ms = _cuda_ms(lambda: bp.traverse(acc, o3, d3, mt, closest),
                            10)
            print(f"# {tag}: {npad} lanes in {npad // bp.TILE} tiles, "
                  f"{work['nodes']} (tile, node) visits, {work['leaves']} "
                  f"(tile, leaf) tests, {work['tests']} ray-triangle tests "
                  f"needed")
            nbytes = ((acc.node_bounds.numel() + acc.node_meta.numel()
                       + acc.tris.numel()) * 4
                      + npad * (28 + (16 if closest else 8)))
            rows.append(_row(
                f"bvh_pallas_traverse.{mode}{suffix}", "K5",
                "bvh_pallas_traverse.cu",
                "mitsuba3_tpu/ops/attic/bvh_pallas.py:158", mode, err, k_ms,
                p_ms, work["box_tests"] * OPS_PER_NODE
                + work["tests"] * OPS_PER_TEST, nbytes, card, accel="pallas",
                rays=kind, queries=[[a, kind] for a in accels], **work))
            if sub:
                rows[-1].update(
                    kernel_ms=k_full, held_rays=npad,
                    note=f"ms, plain_ms and bound_ms are for the first "
                         f"{npad} rays, where the kernel is held against "
                         f"its plain version; kernel_ms is the kernel's "
                         f"time at the full width of {full[2].shape[0]}")
    packs = acc = None

    # K6: the first cull of a bvh_queue query
    if {"K6", "K7"} & set(kernels):
        acc = bq.build(*tris, device="cuda")
    if "K6" in kernels:
        f, i = bq.initial_state(o, d, maxt)
        npad = f.shape[1]
        lk = (i[bs.LK] & bq.MASK31).contiguous()
        kq = bq.cull_topk(acc, f, lk)
        work = {}
        pq = bq.cull_topk_plain(acc, f, lk, stats=work)
        torch.cuda.synchronize()
        _check(torch.equal(kq, pq), f"K6: keys differ on "
               f"{int((kq != pq).sum())} of {kq.numel()}")
        print(f"# K6: keys bit-equal, {int((pq[0] != bs.NONE).sum())} rays "
              f"queue a leaf, {int((pq[-1] != bs.NONE).sum())} fill all "
              f"{bq.KQ}; {work['chunks_taken']} (block, chunk) pairs taken; "
              f"{work['sup_tests']} chunk-box and {work['box_tests']} "
              f"leaf-box tests needed")
        k_ms = _cuda_ms(lambda: bq.cull_topk(acc, f, lk), 20)
        p_ms = _cuda_ms(lambda: bq.cull_topk_plain(acc, f, lk), 2)
        rows.append(_row(
            "bvh_queue_cull", "K6", "bvh_serve_cull.cu",
            "mitsuba3_tpu/ops/attic/bvh_queue.py:60", "cull", 0.0, k_ms,
            p_ms, work["sup_tests"] * OPS_PER_SUP
            + work["box_tests"] * OPS_PER_BOX,
            (acc.bounds.numel() + acc.sup.numel()) * 4
            + npad * (32 + 4 * bq.KQ), card, accel="queue", **work))

    # K7: the first serve, after the sort by queue head and the schedule,
    # on the primary and on the bounce rays
    for kind in ("primary", "bounce") if "K7" in kernels else ():
        ok, dk, mk = (o, d, maxt) if kind == "primary" else _bvh_rays(kind)
        f, i = bq.initial_state(ok, dk, mk)
        npad = f.shape[1]
        fs, is_ = bq.sort_by_head(acc, f, bq.fresh_cull(acc, f, i))
        lids = bq.simulate(is_[bq.Q0:], fs[bs.TB])[0]
        tag = "K7" if kind == "primary" else "K7 bounce"
        kout = bq.serve_multi(acc, lids, fs)
        pout, work, _ = held(tag, lambda w: bq.serve_multi_plain(
            acc, lids, fs, stats=w))
        err = _hold_closest(tag, kout, pout)
        print(f"# {tag}: {work['slots']} of {lids.numel()} (block, slot) "
              f"pairs taken, {work['tests']} ray-triangle tests needed")
        k_ms = _cuda_ms(lambda: bq.serve_multi(acc, lids, fs), 20)
        p_ms = _cuda_ms(lambda: bq.serve_multi_plain(acc, lids, fs), 2)
        rows.append(_row(
            "bvh_queue_serve" + ("" if kind == "primary" else ".bounce"),
            "K7", "bvh_queue_serve.cu",
            "mitsuba3_tpu/ops/attic/bvh_queue.py:211", "serve", err, k_ms,
            p_ms, work["tests"] * (OPS_PER_TEST + 1),
            (acc.tris.numel() + lids.numel()) * 4 + npad * (28 + 16), card,
            accel="queue", rays=kind, queries=[["queue", kind]], **work))
        del f, i, fs, is_
    del acc

    # K8: the first round's serve of a bvh2 query on the bounce rays (on the
    # primary rays every lane of that round wants a padding supernode of the
    # cull, so the kernel would test nothing)
    if "K8" in kernels:
        rows.append(_k8_row(tris, card, k8_device["bounce row"],
                            k8_device["attempts"]))
    torch.cuda.empty_cache()
    return rows


def _k8_row(tris, card: str, device, attempts: int):
    """K8's row: the first bvh2 round's serve on the bounce rays. `device`
    is (device ms, launches) of 20 launches of it, measured where the
    profiler misses none (phase_k8_device), in the `attempts`-th process
    that tried; the row carries that count as `profiler_attempts`."""
    import torch
    from mitsuba3_tpu_torch.ops.attic import bvh2 as b2
    acc = b2.build(*tris, device="cuda")
    o, d, maxt = _bvh_rays("bounce")
    ids, rays, want = b2.first_round(acc, o, d, maxt)
    kout = b2.serve(acc, ids, rays, want)
    work = {}
    pout = b2.serve_plain(acc, ids, rays, want, stats=work)
    torch.cuda.synchronize()
    err = _hold_closest("K8 bounce", kout, pout)
    _check(work["tests"] > 0, "K8: the bounce round serves no supernode")
    real = ids[(ids != b2.NONE_ID) & (ids < acc.n_nodes)]
    n_ids = int(torch.unique(real).numel())
    print(f"# K8 bounce: {ids.shape[0]} chunks, {int(real.numel())} served "
          f"ids from the table ({n_ids} distinct), "
          f"{int(((ids != b2.NONE_ID) & (ids >= acc.n_nodes)).sum())} "
          f"padding ids; {work['lanes']} lanes served, {work['tests']} "
          f"ray-triangle tests needed")
    # 20 launches timed two ways: the CUDA-event span of the wrapper's calls
    # (its host work included, which the card waits on when a launch is
    # this short) and, in `device`, the kernel's device time
    issue_ms = _cuda_ms(lambda: b2.serve(acc, ids, rays, want), 20)
    dev_ms, n = device
    _check(n == 20, f"K8: the profiler saw {n} of 20 launches of "
           f"{K8_KERNEL}")
    k_ms = dev_ms / n
    p_ms = _cuda_ms(lambda: b2.serve_plain(acc, ids, rays, want), 2)
    print(f"# K8 bounce: kernel {k_ms:.4f} ms a launch by device time, "
          f"{issue_ms:.4f} ms a call by the CUDA-event span of 20 calls "
          f"[{card}]")
    nbytes = (n_ids * 10 * b2.LEAF * 4
              + (ids.numel() + rays.numel() + want.numel()) * 4
              + want.numel() * 16)
    return _row(
        "bvh2_serve", "K8", "bvh2_serve.cu",
        "mitsuba3_tpu/ops/attic/bvh2.py:207", "serve", err, k_ms, p_ms,
        work["tests"] * (OPS_PER_TEST + 1), nbytes, card, accel="bvh2",
        rays="bounce", issue_ms=issue_ms, profiler_attempts=attempts,
        **work)


def k8_device_main():
    """``chip_smoke.py --k8-device-ms``: K8's device times on bench_bvh's
    terrain in a process whose one profiler session comes after all its
    other work: 20 launches on the first bvh2 round of the bounce rays
    (after one warm-up launch), then each bvh2 query's launches (closest
    and any-hit on the BVH2_QUERY_RAYS) recorded and replayed, back to
    back. The session's K8 kernels, in launch order, are split by the
    launch counts; one session, because torch.profiler dropped kernels in
    sessions that followed another in the same process. Prints one JSON
    line, {"bounce row": [ms, launches], "<rays> <query>": [ms,
    launches], ...}."""
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mitsuba3_tpu_torch.ops.attic import bvh2
    acc = bvh2.build(*make_terrain(BVH_SIDE), device="cuda")
    runs = {}
    row = bvh2.first_round(acc, *_bvh_rays("bounce"))
    for kind in BVH2_QUERY_RAYS:
        o, d, maxt = _bvh_rays(kind)
        for q, fn in (("closest", bvh2.intersect_bvh),
                      ("anyhit", bvh2.occluded_bvh)):
            runs[f"{kind} {q}"] = _k8_recorded(fn, acc, o, d, maxt)[1]
    runs = {"bounce row": [row] * 20, **runs}
    bvh2.serve(acc, *row)                                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for launched in runs.values():
            for args in launched:
                bvh2.serve(acc, *args)
        torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.device_time_total)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and K8_KERNEL in e.key)
    n_all = sum(len(v) for v in runs.values())
    _check(len(kernels) == n_all, f"K8: the profiler saw {len(kernels)} of "
           f"{n_all} launches")
    out, i = {}, 0
    for key, launched in runs.items():
        n = len(launched)
        out[key] = [sum(us for _, us in kernels[i:i + n]) / 1e3, n]
        i += n
    print(json.dumps(out))
    return 0


K8_DEVICE_ATTEMPTS = 2    # processes at most (~50 s each)
# the rays bvh2's queries run on: a full-width bvh2 query is host-bound at
# ~13 s, so its bounce-ray queries are left out to keep the script in its
# time limit (K8's row still serves the first bvh2 round of the bounce rays)
BVH2_QUERY_RAYS = ("primary",)


def phase_k8_device(card: str) -> dict:
    """K8's device times (k8_device_main) from a process of their own. On
    the H100, torch.profiler kept fewer of K8's launches in each session
    that followed another session and a large unprofiled workload in the
    same process (34 of 34, then 32, 30, ..., 16, then 2 of 20), so this
    script, whose renders are profiled first, leaves them to a fresh
    process. Even there a session has missed one launch of 153 (and 31
    of 32 once), so a process whose profiler missed a launch is run
    again, in a fresh process, up to K8_DEVICE_ATTEMPTS times: the times
    always come from a session that saw every launch. Returns {name:
    (device ms, launches)} and, under "attempts", the number of processes
    run."""
    t0 = time.perf_counter()
    for attempt in range(1, K8_DEVICE_ATTEMPTS + 1):
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--k8-device-ms"], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        missed = "the profiler saw" in run.stdout + run.stderr
        if run.returncode == 0 or not missed:
            break
        print(f"# K8 device times: attempt {attempt}: "
              f"{(run.stdout + run.stderr).strip().splitlines()[-1]}")
    _check(run.returncode == 0, f"K8 device times: exit {run.returncode}:"
           f"\n{run.stdout[-2000:]}{run.stderr[-2000:]}")
    dev = json.loads(run.stdout.strip().splitlines()[-1])
    for key, (ms, n) in dev.items():
        print(f"# K8 device time, {key}: {ms:.4f} ms in {n} launches "
              f"[{card}]")
    print(f"# K8 device times: {time.perf_counter() - t0:.1f} s in "
          f"{attempt} process(es) of their own")
    return {**dev, "attempts": attempt}


# attic accel -> its query variants (suffix, closest hit, any hit)
ATTIC_QUERIES = {
    "pallas": (("", "intersect_bvh", "occluded_bvh"),
               ("_sorted", "intersect_bvh_sorted", "occluded_bvh_sorted")),
    "queue": (("", "intersect_bvh", "occluded_bvh"),),
    "bvh2": (("", "intersect_bvh", "occluded_bvh"),),
}


def _timed_query(counters, fn, *args, record=None, warm=None):
    """(result, wall s, launches) of one call after one warm-up call: the
    host clock around the call, ending in torch.cuda.synchronize();
    `counters` (a module's LAUNCHES) are set to 0 just before the call and
    read just after it. A list `record` gets the arguments of K8's
    launches in the warm-up call (_k8_recorded). The warm-up takes the
    arguments `warm` where given, else `args`."""
    import torch
    if record is None:
        fn(*(warm or args))
    else:
        record.extend(_k8_recorded(fn, *(warm or args))[1])
    torch.cuda.synchronize()
    for k in counters:
        counters[k] = 0
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(counters)


def _k8_recorded(fn, *args):
    """(fn(*args), [(ids, rays, want)] of each K8 launch in the call,
    cloned): bvh2's rounds call `bvh2.serve` through the module, so the
    recorder stands in for it during the call."""
    from mitsuba3_tpu_torch.ops.attic import bvh2
    launched = []
    serve = bvh2.serve

    def recording(acc, ids, rays, want):
        launched.append((ids.clone(), rays.clone(), want.clone()))
        return serve(acc, ids, rays, want)

    bvh2.serve = recording
    try:
        return fn(*args), launched
    finally:
        bvh2.serve = serve


def _k8_replay_ms(acc, launched):
    """(device ms, launches) of K8 over the recorded launches of a query,
    launched again back to back under the profiler: the same inputs, so
    the same work, as in the query."""
    from mitsuba3_tpu_torch.ops.attic import bvh2
    return _device_ms(lambda: [bvh2.serve(acc, *a) for a in launched],
                      K8_KERNEL, warm=False)


def _hold_oracle(tag, closest, anyhit, acc, res, ref):
    """bench_bvh.verify's checks of a closest-hit result `res` on the first
    HOLD_RAYS rays against the dense oracle `ref`. Returns the prim match
    share."""
    import torch
    t, p, v = res[0][:HOLD_RAYS], res[1][:HOLD_RAYS], res[3][:HOLD_RAYS]
    so, sd, smt, t_n, p_n, v_n, occ_n = ref
    _check(torch.equal(v, v_n), f"{tag}: valid differs from the oracle on "
           f"{int((v != v_n).sum())} of {HOLD_RAYS} rays")
    sel = v_n
    same = p[sel] == p_n[sel]
    frac = float(same.float().mean()) if same.numel() else 1.0
    _check(frac >= 0.999, f"{tag}: prim matches the oracle on only {frac}")
    _check(torch.allclose(t[sel][same], t_n[sel][same], rtol=1e-4,
                          atol=1e-4), f"{tag}: t differs from the oracle")
    _check(bool((t[sel][~same] <= t_n[sel][~same] + 1e-3).all()),
           f"{tag}: a hit farther than the oracle's")
    short = torch.where(v_n, t_n * 0.9, 1e30)
    _check(not bool(anyhit(acc, so, sd, short)[sel].any()),
           f"{tag}: occlusion reported short of the nearest hit")
    occ = anyhit(acc, so, sd, torch.full_like(smt, 20.0))
    occ_frac = float((occ == occ_n).float().mean())
    _check(occ_frac > 0.9999, f"{tag}: any-hit at maxt 20 matches the "
           f"oracle on only {occ_frac}")
    act = torch.arange(HOLD_RAYS, device=smt.device) % 2 == 0
    _check(not bool(closest(acc, so, sd, smt, active=act)[3][~act].any()),
           f"{tag}: an inactive lane hit")
    return frac


def phase_attic_queries(card: str, k8_device: dict):
    """bench_bvh's terrain queries (make_terrain(182), 2^19 primary and
    2^19 bounce rays, maxt 1e30) through bvh_pallas, bvh_pallas sorted,
    bvh_queue and bvh2 (on BVH2_QUERY_RAYS), closest and any-hit: each
    timed once after a warm-up (bvh2's on the first HOLD_RAYS rays),
    held to the dense
    oracle on the first HOLD_RAYS rays (bench_bvh.verify's checks) and
    to bvh_tiled (K4) at full width; the bvh2 records get K8's device ms
    from `k8_device` (phase_k8_device).
    Returns (each module's kernel launches over its timed query set,
    query records)."""
    import torch
    from mitsuba3_tpu_torch.core.vec import Vec3
    from mitsuba3_tpu_torch.ops import bvh_tiled as bt
    from mitsuba3_tpu_torch.ops import intersect as isx
    from mitsuba3_tpu_torch.ops.attic import bvh2, bvh_pallas, bvh_queue

    p0, e1, e2 = make_terrain(BVH_SIDE)
    # the oracle's 256-triangle chunks, padded with zero triangles as
    # bench_bvh pads them
    pad = np.zeros(((-p0.shape[0]) % 256, 3), np.float32)

    def vec(a):
        t = torch.as_tensor(np.concatenate([a, pad]), device="cuda")
        return Vec3(*(t[:, i].contiguous() for i in range(3)))

    tri_vecs = [vec(a) for a in (p0, e1, e2)]
    accs, builds = {}, {}
    mods = {"pallas": bvh_pallas, "queue": bvh_queue, "bvh2": bvh2}
    for name, mod in (("tiled", bt), *mods.items()):
        t0 = time.perf_counter()
        accs[name] = mod.build(p0, e1, e2, device="cuda")
        torch.cuda.synchronize()
        builds[name] = time.perf_counter() - t0
    print(f"# attic queries: {p0.shape[0]} triangles; builds "
          + ", ".join(f"{k} {v:.2f} s" for k, v in builds.items()))

    refs = {}
    for kind in ("primary", "bounce"):
        o, d, maxt = _bvh_rays(kind)
        so = Vec3(o.x[:HOLD_RAYS], o.y[:HOLD_RAYS], o.z[:HOLD_RAYS])
        sd = Vec3(d.x[:HOLD_RAYS], d.y[:HOLD_RAYS], d.z[:HOLD_RAYS])
        smt = maxt[:HOLD_RAYS]
        t_n, p_n, _, v_n = isx.intersect_naive(so, sd, smt, *tri_vecs)
        occ_n = isx.occluded_naive(so, sd, torch.full_like(smt, 20.0),
                                   *tri_vecs)
        tiled = (bt.intersect_bvh(accs["tiled"], o, d, maxt),
                 bt.occluded_bvh(accs["tiled"], o, d, maxt))
        refs[kind] = (o, d, maxt, (so, sd, smt, t_n, p_n, v_n, occ_n), tiled)
        print(f"# {kind}: oracle hit share {float(v_n.float().mean()):.4f} "
              f"on the first {HOLD_RAYS} rays; bvh_tiled hit share "
              f"{float(tiled[0][3].float().mean()):.4f}, occluded "
              f"{float(tiled[1].float().mean()):.4f}")
    del accs["tiled"]

    launches, records = {}, []
    for name, variants in ATTIC_QUERIES.items():
        mod, acc = mods[name], accs[name]
        launches[name] = dict.fromkeys(mod.LAUNCHES, 0)
        for kind in BVH2_QUERY_RAYS if name == "bvh2" else refs:
            o, d, maxt, oracle, (tref, occ_ref) = refs[kind]
            for suffix, cname, aname in variants:
                tag = f"{name}{suffix} {kind}"
                closest, anyhit = getattr(mod, cname), getattr(mod, aname)
                # bvh2's host-bound query takes ~13 s a call at full
                # width: its warm-up runs on the oracle's first HOLD_RAYS
                warm = (acc, *oracle[:3]) if name == "bvh2" else None
                res, wall_c, n_c = _timed_query(mod.LAUNCHES, closest, acc,
                                                o, d, maxt, warm=warm)
                occ, wall_a, n_a = _timed_query(mod.LAUNCHES, anyhit, acc,
                                                o, d, maxt, warm=warm)
                for k in launches[name]:
                    launches[name][k] += n_c[k] + n_a[k]
                frac = _hold_oracle(tag, closest, anyhit, acc, res, oracle)
                v, p = res[3], res[1]
                v_eq = float((v == tref[3]).float().mean())
                both = v & tref[3]
                p_eq = float((p[both] == tref[1][both]).float().mean())
                o_eq = float((occ == occ_ref).float().mean())
                _check(v_eq >= 0.9999 and o_eq >= 0.9999 and p_eq >= 0.999,
                       f"{tag}: against bvh_tiled, hit sets match on "
                       f"{v_eq}, occlusion on {o_eq}, prim on {p_eq}")
                rec = {"accel": name + suffix, "rays": kind,
                       "n_rays": BVH_RAYS, "closest_s": wall_c,
                       "anyhit_s": wall_a,
                       "closest_mrays_per_s": BVH_RAYS / wall_c / 1e6,
                       "anyhit_mrays_per_s": BVH_RAYS / wall_a / 1e6,
                       "hit_share": float(v.float().mean()),
                       "occluded_share": float(occ.float().mean()),
                       "oracle_prim_match": frac, "tiled_valid_match": v_eq,
                       "tiled_prim_match": p_eq, "tiled_occ_match": o_eq,
                       "closest_launches": n_c, "anyhit_launches": n_a,
                       "build_s": builds[name]}
                for q in ("closest", "anyhit") if name == "bvh2" else ():
                    ms, n = k8_device[f"{kind} {q}"]
                    _check(n == rec[f"{q}_launches"]["serve"],
                           f"{tag} {q}: K8 launched {n} times in "
                           f"phase_k8_device's query, "
                           f"{rec[f'{q}_launches']['serve']} in this one")
                    rec[f"{q}_k8_device_ms"] = ms
                    print(f"# query {tag} {q}: K8 {ms:.4f} device ms in {n} "
                          f"launches [{card}]")
                records.append(rec)
                print(f"# query {tag}: closest {rec['closest_mrays_per_s']:.3f}"
                      f" Mrays/s ({wall_c * 1e3:.1f} ms, hit share "
                      f"{rec['hit_share']:.4f}, launches {n_c}), any-hit "
                      f"{rec['anyhit_mrays_per_s']:.3f} Mrays/s "
                      f"({wall_a * 1e3:.1f} ms, launches {n_a}); oracle prim "
                      f"match {frac:.5f};"
                      f" vs bvh_tiled: valid {v_eq:.6f}, prim {p_eq:.6f}, "
                      f"occluded {o_eq:.6f} [{card}]")
        print(f"# {name}: launches over its timed queries {launches[name]}")
        _check(all(n > 0 for n in launches[name].values()),
               f"{name}: the queries did not launch every kernel: "
               f"{launches[name]}")
        del accs[name]
        torch.cuda.empty_cache()
    return launches, records


# accel -> (launch counters, profiler labels of its kernels by mode)
def _accel_kernels(accel):
    from mitsuba3_tpu_torch.ops import bvh_serve, bvh_tiled, cellserve
    return {"cells": (cellserve.LAUNCHES,
                      {"K1 closest": "serve_kernel<true>",
                       "K1 any-hit": "serve_kernel<false>"}),
            "serve": (bvh_serve.LAUNCHES, {"K2": "cull_kernel<",
                                           "K3": "serve_kernel<"}),
            "tiled": (bvh_tiled.LAUNCHES,
                      {"K4 closest": "mt_kernel<true>",
                       "K4 any-hit": "mt_kernel<false>"})}[accel]


def phase_render(mi, card: str, accel: str, ref=None):
    """The terrain64k forward render through the public entry points with
    MI3T_ACCEL=accel ("auto" is cellserve). `ref` is the cellserve image
    of the timed render's seed, which the image mean is held against.
    Returns (launches, render numbers, timed image)."""
    import torch

    counters, labels = _accel_kernels("cells" if accel == "auto" else accel)
    d = terrain64k_dict(mi.ScalarTransform4f)
    with _accel(accel):
        t0 = time.perf_counter()
        scene = mi.load_dict(d)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0

    for k in counters:
        counters[k] = 0
    img, rays0 = mi.render_with_stats(scene, seed=0, spp=4,
                                      max_wavefront=1 << 20)
    torch.cuda.synchronize()
    launches = dict(counters)
    _check(all(v > 0 for v in launches.values()),
           f"{accel}: the render did not launch every kernel: {launches}")
    _check(tuple(img.shape) == (512, 512, 3), f"image shape {img.shape}")
    _check(bool(torch.isfinite(img).all()), "image has non-finite values")
    _check(float(img.abs().max()) > 0.0, "image is all zero")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img1, rays = mi.render_with_stats(scene, seed=1, spp=4,
                                      max_wavefront=1 << 20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _check(bool(torch.isfinite(img1).all()), "timed image not finite")
    out = {"accel": accel, "rays": rays, "wall_s": wall,
           "mrays_per_s": rays / wall / 1e6, "scene_build_s": build_s,
           "peak_bytes": peak, "mean": float(img1.mean())}
    line = (f"# render terrain64k 512x512 4spp, MI3T_ACCEL={accel}: {rays} "
            f"rays in {wall:.3f} s = {rays / wall / 1e6:.3f} Mrays/s, scene "
            f"build {build_s:.2f} s, peak memory {peak / 2**30:.2f} GiB, "
            f"mean {out['mean']:.6f} (first render {rays0} rays), launches "
            f"{launches}")
    if ref is not None:
        a, b = img1.cpu().numpy(), ref.cpu().numpy()
        close = float(np.isclose(a, b, rtol=1e-3, atol=1e-3).mean())
        rel = abs(float(a.mean()) / float(b.mean()) - 1.0)
        out.update(close_to_cells=close, mean_rel_to_cells=rel)
        line += (f"; vs cellserve: mean {float(b.mean()):.6f} (rel "
                 f"{rel:.2e}), {close:.5f} of values close")
        _check(rel <= 0.01, f"{accel}: image mean {a.mean()} is not within "
               f"1 % of the cellserve render's {b.mean()}")
    print(line + f" [{card}]")
    out.update(_profile(lambda: mi.render_with_stats(
        scene, seed=2, spp=4, max_wavefront=1 << 20), wall, labels))
    del scene
    torch.cuda.empty_cache()
    return launches, out, img1


def _profile(run, wall_unprofiled: float, kernels: dict):
    """Device time by kernel over one call of `run` (a render, or a pass of
    a PRB step) under torch.profiler, recording CUDA activity only (a
    material pass launches up to ~190,000 kernels, and aggregating their
    host-side events too takes tens of seconds), summed from the trace's
    kernel events; the idle share is taken against the same work's
    unprofiled wall time, since the profiler slows the host. `kernels`
    maps a label to the substring of the CUDA kernel names it sums."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # device time and launches per kernel name, from the trace's own
    # events: key_averages() first builds a Python event per launch (~12 s
    # per 100,000 launches)
    per = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and e.duration_ns() > 0):
            us, n = per.get(e.name(), (0.0, 0))
            per[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    busy = sum(us for us, _ in per.values()) / 1e6
    print(f"# profile: device busy {busy:.4f} s in "
          f"{sum(n for _, n in per.values())} kernel launches; wall "
          f"{wall:.3f} s profiled (idle share {max(0.0, 1 - busy / wall):.3f}"
          f"), {wall_unprofiled:.3f} s unprofiled (idle share "
          f"{max(0.0, 1 - busy / wall_unprofiled):.3f})")
    groups = {label: [k for k in per if key in k]
              for label, key in kernels.items()}
    groups["other kernels"] = [k for k in per if not any(
        key in k for key in kernels.values())]
    by_label = {}
    for label, names in groups.items():
        ms = sum(per[k][0] for k in names) / 1e3
        n = sum(per[k][1] for k in names)
        by_label[label] = {"device_ms": ms, "launches": n}
        print(f"# profile: {label}: {ms:.2f} ms device in {n} launches")
    for k, (us, n) in sorted(per.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"#   {us / 1e3:10.2f} ms  {n:7d}x  {k[:90]}")
    return {"device_busy_s": busy, "profiled_wall_s": wall,
            "idle_share": max(0.0, 1 - busy / wall_unprofiled),
            "profiled_kernels": by_label}


def phase_agreement(mi, accel: str):
    """The small terrain on the card and on the CPU at the same seed."""
    with _accel(accel):
        d = small_terrain_dict(mi.ScalarTransform4f)
        img_g = mi.render(mi.load_dict(d), seed=5, spp=4).cpu().numpy()
        img_c = mi.render(mi.load_dict(d, device="cpu"), seed=5,
                          spp=4).numpy()
    close = float(np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean())
    print(f"# agreement MI3T_ACCEL={accel} (24x24, 4 spp): {close:.5f} of "
          f"values close, means {img_g.mean():.6f} (card) vs "
          f"{img_c.mean():.6f} (cpu)")
    _check(np.isfinite(img_g).all(), f"{accel}: card image not finite")
    _check(close > 0.995, f"{accel}: only {close:.5f} of values agree")
    _check(np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3),
           f"{accel}: image means disagree")


# ---------------------------------------------------------------------------
# PRB (bench.py's main path): Cornell fwd + PRB bwd, terrain64k PRB step
# ---------------------------------------------------------------------------

CORNELL_SPP = 64
GLOSSY_CORNELL_SPP = 8      # not 64: the script keeps to its time limit
TERRAIN_PRB_SPP = 4


def _prb_dict(d):
    """`d` with the ``prb`` integrator (bench.py:46)."""
    return dict(d, integrator=dict(d["integrator"], type="prb"))


def _grad_step(scene, names, seed: int, spp: int, passes=None, between=None):
    """bench.py's grad_step on the port: per pass, the image loss
    mean((develop(pass image) - 0)^2) (sRGB in the spectral variant)
    differentiated by PRB w.r.t. the θ
    tables `names`; gradients add up over passes. `passes` limits the
    passes run (all by default); `between(stage)` is called after each
    pass's forward ("fwd") and backward ("bwd"). Returns (last loss, rays
    of the forward passes, {name: gradient}, passes run)."""
    import torch
    from mitsuba3_tpu_torch.render import integrator as ri

    def leaf(v):
        return v.detach().clone().requires_grad_(True)

    sppc, n_passes = ri.plan_passes(scene, spp)
    n_passes = n_passes if passes is None else passes
    acc, rays, loss = None, 0, None
    for i in range(n_passes):
        # a tuple entry (the textures) gets a leaf per tensor
        theta = {k: tuple(map(leaf, v)) if isinstance(v, tuple) else leaf(v)
                 for k, v in ((k, getattr(scene, k)) for k in names)}
        flat = [t for v in theta.values()
                for t in (v if isinstance(v, tuple) else (v,))]
        img_i, wgt_i, rays_i = ri.render_pass(
            scene.replace(**theta), ri.pass_seed(seed, i), sppc, pass_idx=i,
            spp_total=spp, base_seed=seed)
        if between is not None:
            between("fwd")
        loss = torch.mean(ri.develop(scene, img_i, wgt_i) ** 2)
        grads = torch.autograd.grad(loss, flat)
        if between is not None:
            between("bwd")
        acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
        rays += rays_i
    it = iter(acc)
    acc = {k: tuple(next(it) for _ in v) if isinstance(v, tuple)
           else next(it) for k, v in theta.items()}
    return float(loss.detach()), rays, acc, n_passes


def _bwd_ratio(scene, side: int = 64):
    """bench.py:83-105: the replay's ray count over the primal's on a
    side^2 wavefront of pixel-centre rays (one sample each), all of θ
    differentiated, under the scene's PRB integrator (prb or
    prbvolpath)."""
    import torch
    from mitsuba3_tpu_torch import sensors
    from mitsuba3_tpu_torch.core.vec import Vec2, Vec3
    from mitsuba3_tpu_torch.integrators import get_integrator
    from mitsuba3_tpu_torch.render import sampler as sampler_mod

    mod = get_integrator(scene.integrator)
    n = side * side
    idx = torch.arange(n, dtype=torch.int64, device=scene.device)
    rng = sampler_mod.seed(7, torch.zeros_like(idx), idx, 1)
    px = ((idx % side).to(torch.float32) + 0.5) / side
    py = ((idx // side).to(torch.float32) + 0.5) / side
    ray = sensors.sample_ray(scene.sensor, Vec2(px, py))
    theta = {k: getattr(scene, k) for k in mod.DIFF_PARAM_NAMES
             if getattr(scene, k) is not None}
    L, _, n_fwd, _ = mod._loop(scene, rng, ray, scene.integrator, "primal")
    _, _, n_bwd, grads = mod._loop(scene, rng, ray, scene.integrator,
                                   "backward", dL=Vec3.ones(n, scene.device),
                                   L_in=L, theta=theta)
    return n_fwd, n_bwd


def _check_grads(tag, grads, nonzero):
    """Every gradient finite (a tuple entry: each of its tensors); those
    named in `nonzero` not all zero."""
    import torch
    flat = {f"{k}[{i}]" if isinstance(g, tuple) else k: t
            for k, g in grads.items()
            for i, t in enumerate(g if isinstance(g, tuple) else (g,))}
    for k, g in flat.items():
        _check(bool(torch.isfinite(g).all()), f"{tag}: {k} gradient has "
               f"non-finite values")
    for k in nonzero:
        _check(bool((grads[k] != 0).any()), f"{tag}: {k} gradient is all "
               f"zero")
    print(f"# {tag}: gradients finite; |g| max " + ", ".join(
        f"{k} {float(g.abs().max()):.4g}" for k, g in flat.items())
        + "".join(f"; {k}: {len(g)} tensors" for k, g in grads.items()
                  if isinstance(g, tuple)))


def _agree_images(tag, img_g, img_c):
    """A card image held against the CPU's: finite, > 99.5 % of values
    isclose 1e-3, means rtol 1e-3. Returns the close share."""
    close = float(np.isclose(img_g, img_c, rtol=1e-3, atol=1e-3).mean())
    print(f"# agreement {tag}: {close:.5f} of values close, means "
          f"{img_g.mean():.6f} (card) vs {img_c.mean():.6f} (cpu)")
    _check(np.isfinite(img_g).all() and img_g.shape == img_c.shape,
           f"{tag}: card image not finite or misshaped")
    _check(close > 0.995, f"{tag}: only {close:.5f} of values agree")
    _check(np.allclose(img_g.mean(), img_c.mean(), rtol=1e-3),
           f"{tag}: image means disagree")
    return close


def phase_cornell_prb(mi, card: str, make=None, tag: str = "cornell",
                      nonzero=(), spp: int = CORNELL_SPP):
    """bench.py's main path on the card: load_dict(cornell_box(512, 512,
    max_depth=8)) with prb (with the BSDFs ``make(mi, w, h, max_depth)``
    gives, when given), a one-pass warm-up and one timed grad_step at `spp`
    (gradients of bsdf_params, em_radiance, textures and env_data),
    Mrays/s counted as bench.py counts it, one profiled pass; then a 32^2
    render on the card against the CPU. `nonzero` lists (slot type,
    columns) of bsdf_params whose gradient must not be zero."""
    import torch

    make = make or (lambda m, w, h, depth: m.cornell_box(w, h,
                                                         max_depth=depth))
    names = ("bsdf_params", "em_radiance", "textures", "env_data")
    scene = mi.load_dict(_prb_dict(make(mi, 512, 512, 8)))
    _check(scene.accel is None and scene.faces.shape[0] == 40,
           f"{tag}: the Cornell box does not load through the dense branch")
    n_fwd, n_bwd = _bwd_ratio(scene)
    _check(n_fwd == n_bwd, f"replay issued {n_bwd} rays, primal {n_fwd}")
    bwd_ratio = n_bwd / max(n_fwd, 1)

    _grad_step(scene, names, 0, spp, passes=1)     # warm-up: a pass
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, rays, grads, n_passes = _grad_step(scene, names, 1, spp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _check_grads(f"{tag} prb", grads, ("bsdf_params", "em_radiance"))
    for t, cols in nonzero:
        g = grads["bsdf_params"][scene.bsdf_types.index(t), cols]
        _check(bool((g != 0).all()), f"{tag} prb: the bsdf_params gradient "
               f"of type {t}, columns {cols}, has a zero: {g.tolist()}")
    # the Cornell box has no environment and loads no texture
    _check(float(grads["env_data"].abs().max()) == 0.0
           and grads["textures"] == (),
           f"{tag} prb: env_data or textures gradient where none can be")
    mrays = (1.0 + bwd_ratio) * rays / wall / 1e6
    out = {"scene": f"{tag} 512x512 {spp}spp max_depth 8, prb",
           "bsdf_types": list(scene.bsdf_types),
           "forward_rays": rays, "bwd_ratio": bwd_ratio,
           "ratio_rays_64x64": [n_fwd, n_bwd], "wall_s": wall,
           "passes": n_passes, "mrays_per_s": mrays, "peak_bytes": peak,
           "loss": loss, "textures": "none loaded (empty tuple)"}
    print(f"# {tag} fwd+PRB bwd 512x512 {spp}spp: {rays} forward rays, "
          f"bwd_ratio {bwd_ratio:.6f} ({n_bwd}/{n_fwd} on 64x64), step "
          f"{wall:.3f} s in {n_passes} passes = {mrays:.3f} Mrays/s, peak "
          f"memory {peak / 2**30:.2f} GiB, last pass loss {loss:.6g} "
          f"[{card}]")
    out.update(_profile(lambda: _grad_step(scene, names, 2, spp,
                                           passes=1), wall / n_passes, {}))
    del scene, grads
    torch.cuda.empty_cache()

    # a 32^2 render (prb primal) on the card and on the CPU
    d = _prb_dict(make(mi, 32, 32, 8))
    img_g = mi.render(mi.load_dict(d), seed=5, spp=16).cpu().numpy()
    img_c = mi.render(mi.load_dict(d, device="cpu"), seed=5,
                      spp=16).numpy()
    out.update(agreement_close=_agree_images(f"{tag} (32x32, 16 spp)",
                                             img_g, img_c))
    return out


EVERY_BSDF_PATH_SPP = 8
EVERY_BSDF_PRB_SIDE = 128
EVERY_BSDF_PRB_SPP = 8       # the script keeps to its time limit


def phase_every_bsdf(mi, card: str):
    """The every-BSDF Cornell (every_bsdf_dict: 14 BSDF types, a
    twosided(mask(roughplastic)) floor, a null rectangle, principled,
    principledthin and measured panels) with the path
    integrator at 512^2, 8 spp, max_depth 8: a one-pass warm-up, one
    timed render (Mrays/s as bench.py counts a forward render, peak
    memory), one profiled pass; a PRB step at 128^2, 16 spp (no warm-up
    of its own; gradients
    of bsdf_params and em_radiance finite, wall and peak memory); 32^2
    renders on the card against the CPU, per pixel: the scene at
    max_depth 4, and at max_depth 8 with a diffuse small box
    (every_bsdf_diffuse_box_dict)."""
    import torch
    from mitsuba3_tpu_torch.render import integrator as ri

    scene = mi.load_dict(every_bsdf_dict(mi, 512, 512, 8))
    _check(set(scene.bsdf_types) == set(range(11)) | {12, 15, 18}
           and scene.adapter_max_depth == 1,
           f"every-BSDF: types {scene.bsdf_types}, adapter depth "
           f"{scene.adapter_max_depth}")
    sppc, n_passes = ri.plan_passes(scene, EVERY_BSDF_PATH_SPP)
    mi.render_with_stats(scene, seed=0, spp=sppc)     # warm-up: one pass
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img, rays = mi.render_with_stats(scene, seed=1, spp=EVERY_BSDF_PATH_SPP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _check(tuple(img.shape) == (scene.film.height, scene.film.width, 3)
           and bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
           "every-BSDF: image misshaped, not finite or black")
    out = {"scene": f"every-BSDF cornell 512x512 {EVERY_BSDF_PATH_SPP}spp "
                    "max_depth 8, path",
           "bsdf_types": list(scene.bsdf_types), "rays": rays,
           "wall_s": wall, "mrays_per_s": rays / wall / 1e6,
           "peak_bytes": peak, "mean": float(img.mean())}
    print(f"# every-BSDF cornell path 512x512 {EVERY_BSDF_PATH_SPP}spp: "
          f"{rays} rays in "
          f"{wall:.3f} s = {rays / wall / 1e6:.3f} Mrays/s, peak memory "
          f"{peak / 2**30:.2f} GiB, mean {float(img.mean()):.6f} [{card}]")
    out.update(_profile(lambda: mi.render_with_stats(
        scene, seed=2, spp=sppc), wall / n_passes, {}))
    del scene, img
    torch.cuda.empty_cache()

    names = ("bsdf_params", "em_radiance")
    side = EVERY_BSDF_PRB_SIDE
    scene = mi.load_dict(_prb_dict(every_bsdf_dict(mi, side, side, 8)))
    n_fwd, n_bwd = _bwd_ratio(scene)
    _check(n_fwd == n_bwd, f"every-BSDF replay issued {n_bwd} rays, primal "
           f"{n_fwd}")
    # the step runs once, without a warm-up of its own (the render above
    # ran its forward operations): the script keeps to its time limit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, prb_rays, grads, n_passes = _grad_step(scene, names, 1,
                                                 EVERY_BSDF_PRB_SPP)
    torch.cuda.synchronize()
    prb_wall = time.perf_counter() - t0
    prb_peak = torch.cuda.max_memory_allocated()
    _check_grads("every-BSDF prb", grads, names)
    mrays = 2.0 * prb_rays / prb_wall / 1e6      # bwd_ratio 1 (checked)
    out["prb"] = {"scene": f"every-BSDF cornell {side}x{side} "
                           f"{EVERY_BSDF_PRB_SPP}spp max_depth 8, prb",
                  "forward_rays": prb_rays, "bwd_ratio": 1.0,
                  "ratio_rays_64x64": [n_fwd, n_bwd], "wall_s": prb_wall,
                  "passes": n_passes, "mrays_per_s": mrays,
                  "peak_bytes": prb_peak, "loss": loss}
    print(f"# every-BSDF cornell fwd+PRB bwd {side}x{side} "
          f"{EVERY_BSDF_PRB_SPP}spp: {prb_rays} forward rays, bwd_ratio 1 "
          f"({n_bwd}/{n_fwd} on 64x64), step {prb_wall:.3f} s in "
          f"{n_passes} passes = {mrays:.3f} Mrays/s, peak memory "
          f"{prb_peak / 2**30:.2f} GiB [{card}]")
    del scene, grads
    torch.cuda.empty_cache()

    # by max_depth 8 the small box's smooth glass turns a rounding
    # difference into different paths (ROADMAP queue 3), so that depth is
    # held per pixel with a diffuse small box
    for key, make, depth in (("agreement_close", every_bsdf_dict, 4),
                             ("agreement_depth8_close",
                              every_bsdf_diffuse_box_dict, 8)):
        d = make(mi, 32, 32, depth)
        out[key] = _agree_images(
            f"{make.__name__} (32x32, 16 spp, max_depth {depth})",
            mi.render(mi.load_dict(d), seed=5, spp=16).cpu().numpy(),
            mi.render(mi.load_dict(d, device="cpu"), seed=5,
                      spp=16).numpy())
    return out


def phase_terrain_prb(mi, card: str):
    """bench.py's terrain64k (512^2, 4 spp, max_depth 4) with prb through
    cellserve: a one-pass warm-up, one timed and one profiled grad_step
    (gradients of bsdf_params, env_data and de_params). K1 must launch,
    closest and any-hit, in the primal and in the replay of every pass.
    Then the small terrain's step on the card against the CPU."""
    import torch
    from mitsuba3_tpu_torch.ops import cellserve

    names = ("bsdf_params", "env_data", "de_params")
    scene = mi.load_dict(_prb_dict(terrain64k_dict(mi.ScalarTransform4f)))
    _check(isinstance(scene.accel, cellserve.CellServe),
           "terrain64k does not load through cellserve")
    counters, labels = _accel_kernels("cells")
    n_fwd, n_bwd = _bwd_ratio(scene)
    _check(n_fwd == n_bwd, f"terrain replay issued {n_bwd} rays, primal "
           f"{n_fwd}")
    bwd_ratio = n_bwd / max(n_fwd, 1)
    _grad_step(scene, names, 0, TERRAIN_PRB_SPP, passes=1)  # warm-up: a pass

    per_stage = {"fwd": dict.fromkeys(counters, 0),
                 "bwd": dict.fromkeys(counters, 0)}

    def between(stage):
        for k in counters:
            per_stage[stage][k] += counters[k]
            counters[k] = 0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in counters:
        counters[k] = 0
    with _K1Meter() as meter:
        t0 = time.perf_counter()
        loss, rays, grads, n_passes = _grad_step(scene, names, 1,
                                                 TERRAIN_PRB_SPP,
                                                 between=between)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    k1 = meter.summary()
    peak = torch.cuda.max_memory_allocated()
    for stage in ("fwd", "bwd"):
        _check(all(per_stage[stage][k] >= n_passes for k in counters),
               f"terrain prb: K1 did not launch in every pass's "
               f"{'primal' if stage == 'fwd' else 'replay'}: {per_stage}")
    _check(per_stage["fwd"] == per_stage["bwd"],
           f"terrain prb: the replay launched K1 otherwise than the primal: "
           f"{per_stage}")
    _check_grads("terrain64k prb", grads, names)
    mrays = (1.0 + bwd_ratio) * rays / wall / 1e6
    out = {"scene": "terrain64k 512x512 4spp max_depth 4, prb, cellserve",
           "forward_rays": rays, "bwd_ratio": bwd_ratio, "wall_s": wall,
           "passes": n_passes, "mrays_per_s": mrays, "peak_bytes": peak,
           "loss": loss, "k1_launches": {"primal": per_stage["fwd"],
                                         "replay": per_stage["bwd"]},
           "k1": k1}
    print(f"# terrain64k fwd+PRB bwd 512x512 4spp: {rays} forward rays, "
          f"bwd_ratio {bwd_ratio:.6f}, step {wall:.3f} s in {n_passes} "
          f"passes = {mrays:.3f} Mrays/s, peak memory {peak / 2**30:.2f} "
          f"GiB; K1 launches primal {per_stage['fwd']}, replay "
          f"{per_stage['bwd']}; K1 per step (CUDA events) closest "
          f"{k1['closest']['device_ms']:.2f} ms, bound "
          f"{k1['closest']['bound_ms']:.2f} ms, any-hit "
          f"{k1['anyhit']['device_ms']:.2f} ms, bound "
          f"{k1['anyhit']['bound_ms']:.2f} ms [{card}]")
    prof = _profile(lambda: _grad_step(scene, names, 2, TERRAIN_PRB_SPP,
                                       passes=1), wall / n_passes, labels)
    for label in labels:
        _check(prof["profiled_kernels"][label]["launches"] > 0,
               f"terrain prb: the profiled pass ran no {label}")
    prof["k1_device_ms_per_step"] = {
        label: prof["profiled_kernels"][label]["device_ms"] * n_passes
        for label in labels}
    out.update(prof)
    del scene, grads
    torch.cuda.empty_cache()

    # the small terrain's PRB step on the card against the CPU
    d = _prb_dict(small_terrain_dict(mi.ScalarTransform4f, width=16))
    with _accel("cells"):       # auto is bvh_xla on a CPU device
        g_card = _grad_step(mi.load_dict(d), names, 5, 4)[2]
        g_cpu = _grad_step(mi.load_dict(d, device="cpu"), names, 5, 4)[2]
    for k in names:
        a, b = g_card[k].cpu(), g_cpu[k]
        tol = 1e-2 * float(b.abs().max())
        err = float((a - b).abs().max())
        print(f"# agreement terrain prb (16x16, 4 spp) {k}: max |card - "
              f"cpu| {err:.4g}, tolerance {tol:.4g} (1e-2 of max |cpu|)")
        _check(err <= tol, f"terrain prb: {k} gradients disagree")
    return out



GLOSSY_TERRAIN_BSDF = {"type": "roughplastic", "alpha": 0.3,
                       "distribution": "ggx"}


def glossy(make_dict):
    """`make_dict` (a terrain scene maker) with its terrain's BSDF replaced
    by a GGX roughplastic of alpha 0.3."""
    def make(transform, **kw):
        d = make_dict(transform, **kw)
        d["terrain"]["bsdf"] = dict(GLOSSY_TERRAIN_BSDF)
        return d
    return make


def phase_glossy_terrain(mi, card: str):
    """terrain64k with a roughplastic (GGX, alpha 0.3) BSDF through
    cellserve, 512^2, 4 spp, max_depth 4, forward: one warm-up render,
    one timed with K1's launches counted, the same again with each K1
    launch timed by CUDA events (``_K1Meter``), one profiled (K1's device
    ms per mode, the idle share); then the small terrain with the same
    BSDF on the card against the CPU. Returns (K1 launches, numbers)."""
    import torch
    from mitsuba3_tpu_torch.ops import cellserve

    t0 = time.perf_counter()
    scene = mi.load_dict(glossy(terrain64k_dict)(mi.ScalarTransform4f))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    _check(isinstance(scene.accel, cellserve.CellServe)
           and scene.bsdf_types == (8,),
           "glossy terrain64k does not load as one roughplastic under "
           "cellserve")
    mi.render_with_stats(scene, seed=0, spp=4, max_wavefront=1 << 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in cellserve.LAUNCHES:
        cellserve.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    img, rays = mi.render_with_stats(scene, seed=1, spp=4,
                                     max_wavefront=1 << 20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cellserve.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _check(all(v > 0 for v in launches.values()),
           f"glossy terrain: the render did not launch K1 in both modes: "
           f"{launches}")
    # the same render again with each K1 launch timed (the events and the
    # test counts cost host time, so the timed render above runs bare)
    for k in cellserve.LAUNCHES:
        cellserve.LAUNCHES[k] = 0
    with _K1Meter() as meter:
        mi.render_with_stats(scene, seed=1, spp=4, max_wavefront=1 << 20)
    k1 = meter.summary()
    _check(all(k1[m]["launches"] == launches[m] == cellserve.LAUNCHES[m]
               for m in launches),
           f"glossy terrain: K1 meter {k1} disagrees with {launches}")
    _check(tuple(img.shape) == (scene.film.height, scene.film.width, 3)
           and bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
           "glossy terrain: image misshaped, not finite or black")
    mrays = rays / wall / 1e6
    out = {"scene": "terrain64k 512x512 4spp max_depth 4, roughplastic "
                    "GGX alpha 0.3, cellserve", "rays": rays,
           "wall_s": wall, "mrays_per_s": mrays, "scene_build_s": build_s,
           "peak_bytes": peak, "mean": float(img.mean()), "k1": k1,
           "k1_launches": launches}
    print(f"# render glossy terrain64k 512x512 4spp: {rays} rays in "
          f"{wall:.3f} s = {mrays:.3f} Mrays/s, scene build {build_s:.2f} "
          f"s, peak memory {peak / 2**30:.2f} GiB, mean "
          f"{float(img.mean()):.6f} [{card}]")
    for mode, v in k1.items():
        print(f"# glossy terrain K1 {mode}: {v['launches']} launches for "
              f"{v['queries']} queries, {v['device_ms']:.2f} device ms "
              f"(CUDA events), bound {v['bound_ms']:.2f} ms [{card}]")
    _, labels = _accel_kernels("cells")
    out.update(_profile(lambda: mi.render_with_stats(
        scene, seed=2, spp=4, max_wavefront=1 << 20), wall, labels))
    del scene, img
    torch.cuda.empty_cache()

    d = glossy(small_terrain_dict)(mi.ScalarTransform4f)
    with _accel("cells"):       # auto is bvh_xla on a CPU device
        img_g = mi.render(mi.load_dict(d), seed=5, spp=4).cpu().numpy()
        img_c = mi.render(mi.load_dict(d, device="cpu"), seed=5,
                          spp=4).numpy()
    out.update(agreement_close=_agree_images(
        "glossy small terrain (24x24, 4 spp)", img_g, img_c))
    return launches, out


# ---------------------------------------------------------------------------
# interior120k (bench.py's third scene) and the inverse-rendering loops
# ---------------------------------------------------------------------------

INTERIOR_TRIS = 120000
LOOP_STEPS = 3
CORNELL_TARGET_SPP = 64
CORNELL_LOOP_SPP = 16
TERRAIN_LOOP_LR = 0.02


def phase_interior(mi, card: str):
    """bench.py:192-252 on the card: load_dict of the interior120k scene
    (cellserve), one warm-up render and three timed ones (seeds 1-3) at
    256^2, 4 spp, Mrays/s as bench.py counts it, K1's launches, device ms
    and bound and the straggler rounds per query over the timed renders,
    one profiled render; the image held against a MI3T_ACCEL=tiled render
    of the same seed (both accels are exact)."""
    import torch
    from mitsuba3_tpu_torch.ops import cellserve

    d = interior_dict(mi.ScalarTransform4f, INTERIOR_TRIS)
    t0 = time.perf_counter()
    scene = mi.load_dict(d)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    _check(isinstance(scene.accel, cellserve.CellServe)
           and scene.delta_emitter_types == (0,),
           "interior120k does not load as cellserve with one point light")
    n_faces = int((scene.face_shape >= 0).sum())
    mi.render_with_stats(scene, seed=0, spp=4, max_wavefront=1 << 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in cellserve.LAUNCHES:
        cellserve.LAUNCHES[k] = 0
    rays = 0
    with _K1Meter() as meter:
        t0 = time.perf_counter()
        for seed in (1, 2, 3):
            img, r = mi.render_with_stats(scene, seed=seed, spp=4,
                                          max_wavefront=1 << 20)
            rays += r
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(cellserve.LAUNCHES)
    k1 = meter.summary()
    peak = torch.cuda.max_memory_allocated()
    _check(all(v > 0 for v in launches.values()),
           f"interior: the renders did not launch K1 in both modes: "
           f"{launches}")
    _check(all(k1[m]["launches"] == launches[m] for m in launches),
           f"interior: K1 meter {k1} disagrees with the counts {launches}")
    w = d["sensor"]["film"]["width"]
    _check(tuple(img.shape) == (w, w, 3)
           and bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
           "interior: image misshaped, not finite or black")
    with _accel("tiled"):
        ref = mi.render(mi.load_dict(d), seed=3, spp=4,
                        max_wavefront=1 << 20)
    rel = abs(float(img.mean()) / float(ref.mean()) - 1.0)
    _check(rel <= 0.01, f"interior: image mean {float(img.mean())} not "
           f"within 1 % of the bvh_tiled render's {float(ref.mean())}")
    mrays = rays / wall / 1e6
    out = {"scene": "interior120k 256x256 4spp max_depth 4, point light, "
                    "cellserve", "faces": n_faces, "rays": rays,
           "wall_s": wall, "renders": 3, "mrays_per_s": mrays,
           "scene_build_s": build_s, "peak_bytes": peak,
           "mean": float(img.mean()), "mean_rel_to_tiled": rel,
           "k1": k1, "k1_launches": launches}
    print(f"# render interior120k ({n_faces} faces) 256x256 4spp, 3 renders:"
          f" {rays} rays in {wall:.3f} s = {mrays:.3f} Mrays/s, scene build "
          f"{build_s:.2f} s, peak memory {peak / 2**30:.2f} GiB, mean "
          f"{float(img.mean()):.6f} (tiled {float(ref.mean()):.6f}, rel "
          f"{rel:.2e}) [{card}]")
    for mode, v in k1.items():
        print(f"# interior K1 {mode}: {v['launches']} launches for "
              f"{v['queries']} queries ({v['rounds_per_query']:.2f} rounds "
              f"per query, at most {v['max_rounds']}), {v['device_ms']:.2f} "
              f"device ms, bound {v['bound_ms']:.2f} ms [{card}]")
    _, labels = _accel_kernels("cells")
    out.update(_profile(lambda: mi.render_with_stats(
        scene, seed=4, spp=4, max_wavefront=1 << 20), wall / 3, labels))
    del scene
    torch.cuda.empty_cache()
    return launches, out


def phase_cornell_loop(mi, card: str):
    """examples/02_inverse_rendering.py at bench.py's Cornell width: a
    64 spp target of cornell_box(512, 512, max_depth=8) under prb, the
    albedo (bsdf_params[:, 0:3]) offset by +0.25 and clipped to
    [0.05, 0.95], three Adam steps (lr 0.05) at 16 spp through traverse
    and update(). The albedo error and the loss at a fixed seed must
    fall."""
    import torch

    scene = mi.load_dict(_prb_dict(mi.cornell_box(512, 512, max_depth=8)))
    t0 = time.perf_counter()
    target = mi.render(scene, seed=7, spp=CORNELL_TARGET_SPP)
    torch.cuda.synchronize()
    target_s = time.perf_counter() - t0
    params = mi.traverse(scene)
    rows = params["bsdf_params"]
    true_albedo = rows[:, 0:3].clone()
    x0 = torch.clamp(true_albedo + 0.25, 0.05, 0.95)

    def loss_of(albedo, seed):
        params["bsdf_params"] = torch.cat([albedo, rows[:, 3:]], dim=1)
        img = mi.render(params.update(), seed=seed, spp=CORNELL_LOOP_SPP)
        return torch.mean((img - target) ** 2)

    with torch.no_grad():
        loss0 = float(loss_of(x0, 999))
    opt = mi.ad.Adam(lr=0.05, params={"albedo": x0})
    steps = []
    for it in range(LOOP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = opt["albedo"].clone().requires_grad_(True)
        loss = loss_of(x, it)
        (g,) = torch.autograd.grad(loss, [x])
        opt.step({"albedo": g})
        torch.cuda.synchronize()
        steps.append({"step_s": time.perf_counter() - t0,
                      "loss": float(loss.detach())})
        _check(bool(torch.isfinite(g).all()) and bool((g != 0).any()),
               f"cornell loop: step {it} albedo gradient not finite or zero")
    with torch.no_grad():
        loss1 = float(loss_of(opt["albedo"], 999))
    err0 = float((x0 - true_albedo).abs().mean())
    err1 = float((opt["albedo"] - true_albedo).abs().mean())
    print(f"# cornell loop 512x512 prb: {CORNELL_TARGET_SPP} spp target "
          f"{target_s:.3f} s; 3 Adam steps at {CORNELL_LOOP_SPP} "
          f"spp: seconds per step "
          f"{', '.join(f'{st['step_s']:.3f}' for st in steps)}; albedo "
          f"error {err0:.4f} -> {err1:.4f}; loss at seed 999 {loss0:.6g} ->"
          f" {loss1:.6g} [{card}]")
    _check(err1 < err0, f"cornell loop: albedo error {err0} -> {err1}")
    _check(loss1 < loss0, f"cornell loop: loss {loss0} -> {loss1}")
    del scene, params
    torch.cuda.empty_cache()
    return {"scene": "cornell 512x512 max_depth 8, prb, Adam lr 0.05",
            "target_spp": CORNELL_TARGET_SPP, "target_s": target_s,
            "spp": CORNELL_LOOP_SPP,
            "steps": steps, "albedo_err": [err0, err1],
            "loss_seed999": [loss0, loss1]}


def _bump(v):
    """Heights lifted by a smooth bump of 0.5 at the terrain's centre."""
    v = v.copy()
    v[:, 2] += (0.5 * np.exp(-(v[:, 0] ** 2 + v[:, 1] ** 2) / 8.0)).astype(
        np.float32)
    return v


def phase_terrain_loop(mi, card: str):
    """A vertex-optimisation loop on bench.py's terrain64k (prb, 512^2,
    4 spp, 2 passes of 524,288 lanes, cellserve): the target rendered
    from the mesh as built, the heights lifted by a smooth bump, then
    three Adam steps on LargeSteps differential coordinates (lambda 19,
    uniform), each ending in params["vertices"] = ls.from_differential(u)
    and update(), which rebuilds the accel on the host. Each rebuild must
    equal a fresh load_dict of the edited mesh array by array, the
    vertices' gradients be finite and nonzero, and K1 launch as often in
    each replay as in its primal."""
    import torch
    from mitsuba3_tpu_torch.ops import cellserve

    d = _prb_dict(terrain64k_dict(mi.ScalarTransform4f))
    scene = mi.load_dict(d)
    target = mi.render(scene, seed=9, spp=TERRAIN_PRB_SPP)
    faces = d["terrain"]["faces"]
    params = mi.traverse(scene)
    lifted = torch.as_tensor(_bump(scene.vertices.cpu().numpy()),
                             device=scene.device)
    ls = mi.ad.LargeSteps(lifted, faces, lambda_=19.0, method="uniform")
    opt = mi.ad.Adam(lr=TERRAIN_LOOP_LR,
                     params={"u": ls.to_differential(lifted)})

    def set_vertices():
        """params["vertices"] = ls.from_differential(u), then update();
        returns (scene, the leaf u, CG iterations, rebuild s)."""
        u = opt["u"].clone().requires_grad_(True)
        params["vertices"] = ls.from_differential(u)
        iters = ls.cg_iterations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = params.update()
        torch.cuda.synchronize()
        return new, u, iters, time.perf_counter() - t0

    def hold_rebuild(new, tag):
        fresh_d = dict(d, terrain=dict(
            d["terrain"], vertices=new.vertices.detach().cpu().numpy()))
        fresh = mi.load_dict(fresh_d).accel
        for name in ("tris", "start", "occ", "lo", "inv_cell"):
            _check(torch.equal(getattr(new.accel, name),
                               getattr(fresh, name)),
                   f"terrain loop {tag}: rebuilt accel's {name} differs "
                   f"from a fresh load_dict's")
        for name in ("res", "n_tris", "pair_slots", "max_steps"):
            _check(getattr(new.accel, name) == getattr(fresh, name),
                   f"terrain loop {tag}: rebuilt accel's {name} differs")

    scene, u, iters, rebuild_s = set_vertices()
    hold_rebuild(scene, "start")
    steps = []
    for it in range(LOOP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _K1Meter() as meter:
            for k in cellserve.LAUNCHES:
                cellserve.LAUNCHES[k] = 0
            img = mi.render(scene, seed=it, spp=TERRAIN_PRB_SPP)
            primal = dict(cellserve.LAUNCHES)
            loss = torch.mean((img - target) ** 2)
            g_u, g_v = torch.autograd.grad(loss, [u, scene.vertices])
            replay = {k: cellserve.LAUNCHES[k] - primal[k] for k in primal}
        cg_bwd = ls.cg_iterations
        opt.step({"u": g_u})
        scene, u, cg_fwd, rebuild_s = set_vertices()
        step_s = time.perf_counter() - t0
        k1 = meter.summary()
        _check(all(v > 0 for v in primal.values()) and replay == primal,
               f"terrain loop step {it}: K1 launches primal {primal}, "
               f"replay {replay}")
        _check(bool(torch.isfinite(g_v).all()) and bool((g_v != 0).any()),
               f"terrain loop step {it}: vertex gradient not finite or zero")
        hold_rebuild(scene, f"step {it}")
        steps.append({"step_s": step_s, "rebuild_s": rebuild_s,
                      "cg_iterations": {"forward": cg_fwd,
                                        "backward": cg_bwd},
                      "loss": float(loss.detach()),
                      "k1_launches": {"primal": primal, "replay": replay},
                      "k1": k1, "grad_vertices_max": float(
                          g_v.abs().max())})
        print(f"# terrain loop step {it}: {step_s:.3f} s (rebuild "
              f"{rebuild_s:.3f} s on the host), CG iterations forward "
              f"{cg_fwd} / backward {cg_bwd}, loss {steps[-1]['loss']:.6g}, "
              f"|dL/dv| max {float(g_v.abs().max()):.4g}; K1 primal "
              f"{primal}, replay {replay}, device ms closest "
              f"{k1['closest']['device_ms']:.2f} (bound "
              f"{k1['closest']['bound_ms']:.2f}), any-hit "
              f"{k1['anyhit']['device_ms']:.2f} (bound "
              f"{k1['anyhit']['bound_ms']:.2f}) [{card}]")
    del scene, params
    torch.cuda.empty_cache()
    return {"scene": "terrain64k 512x512 4spp max_depth 4, prb, cellserve, "
                     f"Adam lr {TERRAIN_LOOP_LR} on LargeSteps (lambda 19, "
                     "uniform)",
            "vertices": int(ls.n), "steps": steps}


# ---------------------------------------------------------------------------
# Scene files: load_file of a user's XML with OBJ and PLY meshes
# ---------------------------------------------------------------------------

XML_CORNELL_SPP = 16        # not 64: the script keeps to its time limit
XML_PRB_SPP = 16
XML_PRB_CROP = (384, 384, 64, 64)   # crop_width, crop_height, offset x, y


def _hold_scene_equal(tag, a, b):
    """Every array and static field of Scene `a` bit-equal to `b`'s (the
    accel's arrays included, by convert.arrays_from_scene)."""
    from mitsuba3_tpu_torch import convert
    (aa, am), (ba, bm) = (convert.arrays_from_scene(s) for s in (a, b))
    _check(sorted(aa) == sorted(ba), f"{tag}: array names differ: "
           f"{sorted(set(aa) ^ set(ba))}")
    for k in aa:
        _check(aa[k].dtype == ba[k].dtype and np.array_equal(aa[k], ba[k]),
               f"{tag}: {k} differs")
    _check(am == bm, f"{tag}: static fields differ")
    print(f"# {tag}: {len(aa)} arrays (accel {am['accel']['kind']}) and the "
          f"static fields bit-equal")


def phase_scene_files(mi, card: str):
    """A user's own scene files on the card, written to a temporary
    directory: terrain64k as a binary PLY (double vertices) and an XML
    file, whose load_file scene must equal load_dict's array for array,
    rendered at 512^2, 4 spp through K1 (a warm-up, a timed and a
    profiled render); the Cornell box as XML with OBJ walls, rendered by
    `path` with the orthogonal sampler, a thinlens sensor and the lanczos
    filter at 512^2, XML_CORNELL_SPP spp, max_depth 8 (a one-pass
    warm-up, the timed render, a profiled pass), and a prb step at 16
    spp with multijitter, mitchell and a crop window (and a profiled
    pass) beside phase 6's independent Gaussian step at 16 spp; then
    each of XML_COMBOS at 32^2,
    16 spp, max_depth 4 and each of XML_METERS on a 4^2 film on the card
    against the CPU."""
    import tempfile

    import torch
    from mitsuba3_tpu_torch.ops import cellserve
    from mitsuba3_tpu_torch.render import integrator as ri
    from mitsuba3_tpu_torch.utils import xml as xml_mod

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = terrain64k_dict(mi.ScalarTransform4f)
        path = terrain_xml(tmp, d, "terrain64k")
        t0 = time.perf_counter()
        xml_mod.parse_file(path)
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = mi.load_dict(d)
        torch.cuda.synchronize()
        dict_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scene = mi.load_file(path)
        torch.cuda.synchronize()
        file_s = time.perf_counter() - t0
        _hold_scene_equal("XML terrain64k against load_dict", scene, ref)
        del ref
        mi.render_with_stats(scene, seed=0, spp=4, max_wavefront=1 << 20)
        for k in cellserve.LAUNCHES:
            cellserve.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, rays = mi.render_with_stats(scene, seed=1, spp=4,
                                         max_wavefront=1 << 20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cellserve.LAUNCHES)
        _check(all(v > 0 for v in launches.values()),
               f"XML terrain64k: K1 did not launch in both modes: {launches}")
        _check(tuple(img.shape) == (scene.film.height, scene.film.width, 3)
               and bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
               "XML terrain64k: image misshaped, not finite or black")
        out["terrain64k"] = {
            "rays": rays, "wall_s": wall, "mrays_per_s": rays / wall / 1e6,
            "parse_file_s": parse_s, "load_file_s": file_s,
            "load_dict_s": dict_s, "k1_launches": launches}
        print(f"# XML terrain64k 512x512 4spp: {rays} rays in {wall:.3f} s "
              f"= {rays / wall / 1e6:.3f} Mrays/s; parse_file {parse_s:.3f} "
              f"s, load_file {file_s:.3f} s, load_dict {dict_s:.3f} s; K1 "
              f"launches {launches} [{card}]")
        out["terrain64k"].update(_profile(lambda: mi.render_with_stats(
            scene, seed=2, spp=4, max_wavefront=1 << 20), wall,
            _accel_kernels("cells")[1]))
        del scene, img
        torch.cuda.empty_cache()

        path = cornell_xml(mi, tmp, 512, 512, 8, XML_CORNELL_SPP,
                           "orthogonal", "thinlens", "lanczos")
        scene = mi.load_file(path)
        _check((scene.sampler_type, scene.sensor_config.type,
                scene.film.rfilter, scene.accel) == (
                    "orthogonal", "thinlens", "lanczos", None),
               "XML Cornell: sampler, sensor or filter not as written")
        sppc, n_passes = ri.plan_passes(scene, XML_CORNELL_SPP)

        def one_pass(seed):
            return ri.render_pass(scene, ri.pass_seed(seed, 0), sppc,
                                  spp_total=XML_CORNELL_SPP, base_seed=seed)
        one_pass(0)                                  # warm-up: one pass
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img, rays = mi.render_with_stats(scene, seed=1, spp=XML_CORNELL_SPP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        _check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
               "XML Cornell: image not finite or black")
        out["cornell_path"] = {
            "scene": f"XML cornell 512x512 {XML_CORNELL_SPP}spp max_depth 8, "
                     "path, orthogonal, thinlens, lanczos",
            "rays": rays, "wall_s": wall, "passes": n_passes,
            "mrays_per_s": rays / wall / 1e6, "peak_bytes": peak,
            "mean": float(img.mean())}
        print(f"# XML cornell path orthogonal/thinlens/lanczos 512x512 "
              f"{XML_CORNELL_SPP}spp: {rays} rays in {wall:.3f} s "
              f"({n_passes} passes) = {rays / wall / 1e6:.3f} Mrays/s, peak "
              f"memory {peak / 2**30:.2f} GiB [{card}]")
        out["cornell_path"].update(_profile(lambda: one_pass(2),
                                            wall / n_passes, {}))
        del scene, img
        torch.cuda.empty_cache()

        names = ("bsdf_params", "em_radiance")
        steps = {}
        for tag, make, profiled in (
                ("multijitter/mitchell/crop", lambda: mi.load_file(
                    cornell_xml(mi, tmp, 512, 512, 8, XML_PRB_SPP,
                                "multijitter", "perspective", "mitchell",
                                XML_PRB_CROP, "prb")), True),
                ("independent/gaussian (phase 6)", lambda: mi.load_dict(
                    _prb_dict(mi.cornell_box(512, 512, max_depth=8))),
                 False)):
            scene = make()
            _grad_step(scene, names, 0, XML_PRB_SPP, passes=1)  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, rays, grads, n_passes = _grad_step(scene, names, 1,
                                                     XML_PRB_SPP)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            _check_grads(f"XML cornell prb {tag}", grads, names)
            steps[tag] = {"forward_rays": rays, "wall_s": wall,
                          "passes": n_passes,
                          "mrays_per_s": 2.0 * rays / wall / 1e6,
                          "film": [scene.film.width, scene.film.height]}
            print(f"# cornell fwd+PRB bwd {tag} {scene.film.width}x"
                  f"{scene.film.height} {XML_PRB_SPP}spp: {rays} forward "
                  f"rays, step {wall:.3f} s in {n_passes} passes = "
                  f"{2.0 * rays / wall / 1e6:.3f} Mrays/s (bwd_ratio 1) "
                  f"[{card}]")
            if profiled:       # phase 6 profiles the independent step
                steps[tag].update(_profile(lambda: _grad_step(
                    scene, names, 2, XML_PRB_SPP, passes=1), wall / n_passes,
                    {}))
            del scene, grads
            torch.cuda.empty_cache()
        out["cornell_prb"] = steps

        agree = {}
        cases = [(c, 32, 32) for c in XML_COMBOS] + [
            (("independent", m, "gaussian", None), 4, 4) for m in XML_METERS]
        for (sampler, sensor, rfilter, crop), w, h in cases:
            path = cornell_xml(mi, tmp, w, h, 4, 16, sampler, sensor, rfilter,
                               crop)
            tag = f"XML {sampler}/{sensor}/{rfilter} {w}x{h}" + (
                " crop" if crop else "")
            agree[tag] = _agree_images(
                f"{tag} (16 spp, max_depth 4)",
                mi.render(mi.load_file(path), seed=5).cpu().numpy(),
                mi.render(mi.load_file(path, device="cpu"),
                          seed=5).numpy())
        out["agreement_close"] = agree
    return out


TEXTURED_PRB_SPP = 8         # the script keeps to its time limit


def _check_texture_grads(tag, grads, n_textures: int):
    """`n_textures` texture gradients, each finite and not all zero."""
    import torch
    g = grads["textures"]
    _check(len(g) == n_textures, f"{tag}: {len(g)} texture gradients, "
           f"{n_textures} textures")
    for i, t in enumerate(g):
        _check(bool(torch.isfinite(t).all()) and bool((t != 0).any()),
               f"{tag}: texture {i}'s gradient is not finite or all zero")


def phase_textures(mi, card: str):
    """Textures and image files on the card, every file written by the
    port's writers into a temporary directory. (a) The textured Cornell
    (textured_cornell_dict: a mipmapped 1024^2 EXR floor, a checkerboard
    back wall, a normalmap from a 1024^2 PNG around a roughplastic with a
    512^2 PNG reflectance, a mask with a PFM opacity) as an XML file,
    whose load_file scene must equal load_dict's array for array; a PRB
    step at 512^2, 16 spp, max_depth 8 (8 passes) differentiating
    bsdf_params, em_radiance and textures (every texture's gradient
    finite and nonzero), a profiled pass; a 32^2 render on the card
    against the CPU. (b) terrain64k with planar uvs, a mipmapped 2048^2
    EXR reflectance (to_uv a scale of 4) and an envmap read from a
    2048x1024 RGBE file: a `path` render at 512^2, 4 spp through K1 (a
    warm-up, a timed and a profiled render), then a PRB step (2 passes)
    differentiating textures and env_data; the small terrain so textured
    on the card against the CPU."""
    import tempfile

    import torch
    from mitsuba3_tpu_torch.ops import cellserve

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_cornell_textures(tmp)
        write_terrain_textures(tmp)
        out["write_files_s"] = time.perf_counter() - t0

        # (a) the textured Cornell from an XML file
        path = textured_cornell_xml(mi, tmp, 512, 512, 8, TEXTURED_PRB_SPP)
        t0 = time.perf_counter()
        scene = mi.load_file(path)
        torch.cuda.synchronize()
        file_s = time.perf_counter() - t0
        _hold_scene_equal("textured Cornell XML against load_dict", scene,
                          mi.load_dict(_prb_dict(textured_cornell_dict(
                              mi, tmp, 512, 512, 8, TEXTURED_PRB_SPP))))
        _check(len(scene.textures) == 5
               and {m[:2] for m in scene.texture_meta} == {
                   ("repeat", "bilinear"), ("clamp", "nearest"),
                   ("mirror", "bilinear")}
               and [len(m) for m in scene.texture_mips].count(
                   TEX_SIDE.bit_length() - 1) == 1,
               f"textured Cornell: textures as loaded {scene.texture_meta}")
        names = ("bsdf_params", "em_radiance", "textures")
        _grad_step(scene, names, 0, TEXTURED_PRB_SPP, passes=1)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, rays, grads, n_passes = _grad_step(scene, names, 1,
                                                 TEXTURED_PRB_SPP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        _check_grads("textured cornell prb", grads, names[:2])
        _check_texture_grads("textured cornell prb", grads, 5)
        mrays = 2.0 * rays / wall / 1e6          # bwd_ratio 1 (phase 6)
        out["cornell"] = {
            "scene": f"textured cornell (XML) 512x512 {TEXTURED_PRB_SPP}spp "
                     "max_depth 8, prb",
            "bsdf_types": list(scene.bsdf_types), "load_file_s": file_s,
            "forward_rays": rays, "wall_s": wall, "passes": n_passes,
            "mrays_per_s": mrays, "peak_bytes": peak, "loss": loss}
        print(f"# textured cornell fwd+PRB bwd 512x512 {TEXTURED_PRB_SPP}spp:"
              f" {rays} forward rays, step {wall:.3f} s in {n_passes} passes"
              f" = {mrays:.3f} Mrays/s (bwd_ratio 1), peak memory "
              f"{peak / 2**30:.2f} GiB, load_file {file_s:.3f} s [{card}]")
        out["cornell"].update(_profile(lambda: _grad_step(
            scene, names, 2, TEXTURED_PRB_SPP, passes=1), wall / n_passes,
            {}))
        del scene, grads
        torch.cuda.empty_cache()
        path = textured_cornell_xml(mi, tmp, 32, 32, 8, 16)
        out["cornell"]["agreement_close"] = _agree_images(
            "textured cornell XML (32x32, 16 spp)",
            mi.render(mi.load_file(path), seed=5).cpu().numpy(),
            mi.render(mi.load_file(path, device="cpu"), seed=5).numpy())

        # (b) the textured terrain64k lit by an image
        counters, labels = _accel_kernels("cells")
        d = textured_terrain_dict(terrain64k_dict, mi.ScalarTransform4f, tmp)
        t0 = time.perf_counter()
        scene = mi.load_dict(d)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        _check(isinstance(scene.accel, cellserve.CellServe)
               and tuple(scene.env_data.shape) == ENV_SIZE + (3,)
               and tuple(scene.textures[0].shape) == (TERRAIN_TEX_SIDE,) * 2
               + (3,), "textured terrain64k: accel, envmap or texture not "
               "as written")
        mi.render_with_stats(scene, seed=0, spp=4, max_wavefront=1 << 20)
        for k in counters:
            counters[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img, rays = mi.render_with_stats(scene, seed=1, spp=4,
                                         max_wavefront=1 << 20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = dict(counters)
        _check(all(v > 0 for v in launches.values()),
               f"textured terrain64k: K1 did not launch in both modes: "
               f"{launches}")
        _check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
               "textured terrain64k: image not finite or black")
        out["terrain"] = {
            "scene": "terrain64k, 2048^2 EXR texture (mipmap), 2048x1024 "
                     "RGBE envmap, 512x512 4spp max_depth 4, path, cellserve",
            "rays": rays, "wall_s": wall, "mrays_per_s": rays / wall / 1e6,
            "peak_bytes": peak, "load_dict_s": load_s,
            "k1_launches": launches, "mean": float(img.mean())}
        print(f"# textured terrain64k 512x512 4spp: {rays} rays in "
              f"{wall:.3f} s = {rays / wall / 1e6:.3f} Mrays/s, peak memory "
              f"{peak / 2**30:.2f} GiB, load_dict {load_s:.3f} s; K1 "
              f"launches {launches} [{card}]")
        prof = _profile(lambda: mi.render_with_stats(
            scene, seed=2, spp=4, max_wavefront=1 << 20), wall, labels)
        for label in labels:
            _check(prof["profiled_kernels"][label]["launches"] > 0,
                   f"textured terrain64k: the profiled render ran no {label}")
        out["terrain"].update(prof)
        del scene, img
        torch.cuda.empty_cache()

        names = ("textures", "env_data")
        scene = mi.load_dict(_prb_dict(d))
        _grad_step(scene, names, 0, TERRAIN_PRB_SPP, passes=1)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, rays, grads, n_passes = _grad_step(scene, names, 1,
                                                 TERRAIN_PRB_SPP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        _check_grads("textured terrain64k prb", grads, ("env_data",))
        _check_texture_grads("textured terrain64k prb", grads, 1)
        mrays = 2.0 * rays / wall / 1e6
        out["terrain_prb"] = {
            "scene": "textured terrain64k 512x512 4spp max_depth 4, prb",
            "forward_rays": rays, "wall_s": wall, "passes": n_passes,
            "mrays_per_s": mrays, "peak_bytes": peak, "loss": loss}
        print(f"# textured terrain64k fwd+PRB bwd 512x512 4spp: {rays} "
              f"forward rays, step {wall:.3f} s in {n_passes} passes = "
              f"{mrays:.3f} Mrays/s (bwd_ratio 1), peak memory "
              f"{peak / 2**30:.2f} GiB [{card}]")
        del scene, grads
        torch.cuda.empty_cache()

        d = textured_terrain_dict(small_terrain_dict, mi.ScalarTransform4f,
                                  tmp)
        with _accel("cells"):   # auto is bvh_xla on a CPU device
            out["terrain"]["agreement_close"] = _agree_images(
                "textured small terrain (24x24, 4 spp)",
                mi.render(mi.load_dict(d), seed=5).cpu().numpy(),
                mi.render(mi.load_dict(d, device="cpu"), seed=5).numpy())
    return out


MEDIA_FOG_SPP = 8           # the fog Cornell's PRB step, 512^2
MEDIA_SMOKE_SIDE = 256      # the smoke's density grid, side^3
MEDIA_SMOKE_SPP = 4
MEDIA_CHECK_SIDE = 32       # card against CPU
MEDIA_GRADS = ("medium_params", "bsdf_params", "em_radiance")


def _media_fog_prb(mi, card: str):
    """The fog Cornell (tests/test_regression.py's fog cube in bench.py's
    Cornell box) at 512^2, MEDIA_FOG_SPP spp, max_depth 6 under
    prbvolpath: a one-pass warm-up, one timed grad_step (gradients of the
    medium rows, the BSDF rows and the emitter radiance), Mrays/s as
    bench.py counts it, one profiled pass."""
    import torch

    scene = mi.load_dict(fog_cornell_dict(mi, 512, 512, 6, "prbvolpath"))
    _check(scene.accel is None and scene.medium_types == (0,)
           and scene.faces.shape[0] == 48,
           "fog cornell: not the dense Cornell box with one homogeneous "
           "medium")
    t0 = time.perf_counter()
    n_fwd, n_bwd = _bwd_ratio(scene)
    _check(n_fwd == n_bwd, f"fog replay issued {n_bwd} rays, primal {n_fwd}")
    t1 = time.perf_counter()
    _grad_step(scene, MEDIA_GRADS, 0, MEDIA_FOG_SPP, passes=1)    # warm-up
    torch.cuda.synchronize()
    print(f"# media fog cornell: bwd_ratio on 64x64 {t1 - t0:.1f} s, "
          f"warm-up pass {time.perf_counter() - t1:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, rays, grads, n_passes = _grad_step(scene, MEDIA_GRADS, 1,
                                             MEDIA_FOG_SPP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _check_grads("fog cornell prbvolpath", grads, MEDIA_GRADS)
    g_med = grads["medium_params"][0, 0:6]
    _check(bool((g_med != 0).all()), f"fog cornell prbvolpath: a zero "
           f"sigma_t or albedo gradient: {g_med.tolist()}")
    bwd_ratio = n_bwd / max(n_fwd, 1)
    mrays = (1.0 + bwd_ratio) * rays / wall / 1e6
    out = {"scene": f"fog cornell 512x512 {MEDIA_FOG_SPP}spp max_depth 6, "
                    "prbvolpath", "forward_rays": rays,
           "bwd_ratio": bwd_ratio, "ratio_rays_64x64": [n_fwd, n_bwd],
           "wall_s": wall, "passes": n_passes, "mrays_per_s": mrays,
           "peak_bytes": peak, "loss": loss,
           "medium_grad": g_med.tolist()}
    print(f"# media fog cornell fwd+PRB bwd 512x512 {MEDIA_FOG_SPP}spp: "
          f"{rays} forward rays, bwd_ratio {bwd_ratio:.6f}, step {wall:.3f}"
          f" s in {n_passes} passes = {mrays:.3f} Mrays/s, peak memory "
          f"{peak / 2**30:.2f} GiB [{card}]")
    out.update(_profile(lambda: _grad_step(scene, MEDIA_GRADS, 2,
                                           MEDIA_FOG_SPP, passes=1),
                        wall / n_passes, {}))
    return out


def _media_foggy_interior(mi, card: str):
    """interior120k with the camera in a homogeneous medium under volpath
    (max_depth 4): a warm-up and two timed 256^2, 4 spp renders through
    cellserve, K1's launches counted from zero just before them, its
    device ms and bound by CUDA events (_K1Meter)."""
    import torch
    from mitsuba3_tpu_torch.ops import cellserve

    d = foggy_interior_dict(mi.ScalarTransform4f, INTERIOR_TRIS)
    scene = mi.load_dict(d)
    _check(isinstance(scene.accel, cellserve.CellServe)
           and scene.sensor_medium == 0,
           "foggy interior: not cellserve with the camera in a medium")
    mi.render_with_stats(scene, seed=0, spp=4, max_wavefront=1 << 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in cellserve.LAUNCHES:
        cellserve.LAUNCHES[k] = 0
    rays = 0
    with _K1Meter() as meter:
        t0 = time.perf_counter()
        for seed in (1, 2):
            img, r = mi.render_with_stats(scene, seed=seed, spp=4,
                                          max_wavefront=1 << 20)
            rays += r
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(cellserve.LAUNCHES)
    k1 = meter.summary()
    peak = torch.cuda.max_memory_allocated()
    _check(launches["closest"] > 0, f"foggy interior: K1 closest was not "
           f"launched: {launches}")
    _check(all(k1[m]["launches"] == launches[m] for m in launches),
           f"foggy interior: K1 meter {k1} disagrees with {launches}")
    w = d["sensor"]["film"]["width"]
    _check(tuple(img.shape) == (w, w, 3) and bool(torch.isfinite(img).all())
           and float(img.mean()) > 0,
           "foggy interior: image misshaped, not finite or black")
    mrays = rays / wall / 1e6
    print(f"# media foggy interior120k 256x256 4spp volpath, 2 renders: "
          f"{rays} rays in {wall:.3f} s = {mrays:.3f} Mrays/s, peak memory "
          f"{peak / 2**30:.2f} GiB, mean {float(img.mean()):.6f} [{card}]")
    for mode, v in k1.items():
        print(f"# media foggy interior K1 {mode}: {v['launches']} launches "
              f"for {v['queries']} queries, {v['device_ms']:.2f} device ms,"
              f" bound {v['bound_ms']:.3f} ms (2 renders) [{card}]")
    if launches["anyhit"]:
        print(f"# media foggy interior: K1 any-hit launched "
              f"{launches['anyhit']} times")
    return {"scene": "foggy interior120k 256x256 4spp max_depth 4, volpath "
                     "(camera medium sigma_t 0.1, albedo 0.8, hg 0.3), "
                     "cellserve", "rays": rays, "renders": 2,
            "wall_s": wall, "mrays_per_s": mrays, "peak_bytes": peak,
            "mean": float(img.mean()), "k1": k1, "k1_launches": launches}


def _media_smoke(mi, card: str):
    """examples/03_volumetric.py's smoke at 512^2, MEDIA_SMOKE_SPP spp,
    max_depth 8, its density on a MEDIA_SMOKE_SIDE^3 grid, loaded once and
    rendered under volpath, then volpathmis (the scene's integrator
    replaced): a warm-up and a timed render each (the grid's cell table
    built once for both: a wrapper counts media.build_cells), a profiled
    volpath render."""
    import torch
    from mitsuba3_tpu_torch import media
    from mitsuba3_tpu_torch.integrators import config_from_dict

    out = {}
    builds = []
    real_build = media.build_cells

    def counted(g):
        builds.append(tuple(g.shape))
        return real_build(g)

    media.build_cells = counted
    try:
        t0 = time.perf_counter()
        d = smoke_dict(mi, 512, MEDIA_SMOKE_SIDE, spp=MEDIA_SMOKE_SPP)
        smoke = mi.load_dict(d)
        torch.cuda.synchronize()
        print(f"# media smoke: dict and load_dict "
              f"{time.perf_counter() - t0:.1f} s")
        for itype in ("volpath", "volpathmis"):
            scene = smoke.replace(integrator=config_from_dict(
                dict(d["integrator"], type=itype)))
            mi.render(scene, seed=0, spp=1)                # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            img, rays = mi.render_with_stats(scene, seed=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            w = scene.film.width
            _check(tuple(img.shape) == (w, w, 3)
                   and bool(torch.isfinite(img).all())
                   and float(img.mean()) > 0,
                   f"smoke {itype}: image misshaped, not finite or black")
            out[itype] = {"wall_s": wall, "rays": rays,
                          "mrays_per_s": rays / wall / 1e6,
                          "peak_bytes": peak, "mean": float(img.mean())}
            print(f"# media smoke {MEDIA_SMOKE_SIDE}^3 512x512 "
                  f"{MEDIA_SMOKE_SPP}spp {itype}: {rays} rays in {wall:.3f} "
                  f"s = {rays / wall / 1e6:.3f} Mrays/s, peak memory "
                  f"{peak / 2**30:.2f} GiB, mean {float(img.mean()):.6f} "
                  f"[{card}]")
            if itype == "volpath":
                out[itype].update(_profile(lambda: mi.render(scene, seed=2),
                                           wall, {}))
        del smoke, scene
        torch.cuda.empty_cache()
    finally:
        media.build_cells = real_build
    side = MEDIA_SMOKE_SIDE
    _check(builds == [(side, side, side)],
           f"smoke: cell tables built {builds}, not once for the grid")
    out["cell_table_builds"] = len(builds)
    out["cell_table_bytes"] = (side - 1) ** 3 * 8 * 4
    return out


def _media_agreement(mi):
    """Card against CPU at MEDIA_CHECK_SIDE^2: the fog Cornell (volpath,
    4 spp; and its prbvolpath gradients at 16^2, 4 spp within 1e-3 of
    the CPU's largest entry), the smoke on a 16^3 grid (volpath) and
    make_interior(9000) with the camera medium through cellserve
    (volpath); the CPU runs the plain versions, so K1 is held against its
    plain version on media traffic."""
    import torch

    side = MEDIA_CHECK_SIDE
    out = {}
    for tag, d, spp in (
            ("fog cornell volpath", fog_cornell_dict(mi, side, side, 6), 4),
            ("smoke 16^3 volpath", smoke_dict(mi, side, 16), 4),
            ("foggy interior 9000 volpath",
             foggy_interior_dict(mi.ScalarTransform4f, 9000, side), 4)):
        with _accel("cells"):
            img_g = mi.render(mi.load_dict(d), seed=5, spp=spp)
            img_c = mi.render(mi.load_dict(d, device="cpu"), seed=5, spp=spp)
        out[tag] = _agree_images(f"{tag} ({side}x{side}, {spp} spp)",
                                 img_g.cpu().numpy(), img_c.numpy())
    d = fog_cornell_dict(mi, 16, 16, 4, "prbvolpath")
    g = {}
    for dev in ("cuda", "cpu"):
        g[dev] = _grad_step(mi.load_dict(d, device=dev), MEDIA_GRADS, 3,
                            4)[2]
    for k in MEDIA_GRADS:
        a, b = g["cuda"][k].cpu(), g["cpu"][k]
        scale = float(b.abs().max())
        _check(bool(torch.isfinite(a).all()) and torch.allclose(
            a, b, rtol=0, atol=1e-3 * scale + 1e-12),
            f"fog cornell prbvolpath: the card's {k} gradient differs from "
            f"the CPU's by {float((a - b).abs().max())} (max {scale})")
    out["fog cornell prbvolpath grads"] = "within 1e-3 of max"
    return out


def phase_media(mi, card: str):
    """Participating media on the card (nothing falls back to the CPU):
    the fog Cornell's fwd + PRB bwd step, the foggy interior120k through
    K1, the smoke under volpath and volpathmis, then four scenes on the
    card against the CPU."""
    out = {}
    for name, part in (("fog_cornell", _media_fog_prb),
                       ("foggy_interior", _media_foggy_interior),
                       ("smoke", _media_smoke),
                       ("agreement", lambda m, _: _media_agreement(m))):
        t0 = time.perf_counter()
        out[name] = part(mi, card)
        print(f"# media {name}: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Integrators and lights: direct, aov, depth, moment, the light tracer;
# sphere, directionalarea and projector lights, sunsky
# ---------------------------------------------------------------------------

ALL_AOVS = ("dd:depth,p:position,uv:uv,gn:geo_normal,sn:sh_normal,"
            "a:albedo,pi:prim_index,si:shape_index")
CORNELL_RADIANCE = [18.387, 13.9873, 6.75357]
INTEG_CORNELL_SPP = 64      # the moment and path renders, 512^2
PTRACER_SPP = 16            # 8 passes of 2^19 light paths at 512^2
PTRACER_RTOL = 0.08         # tests/test_render.py:106
LIGHTS_SPP = 16             # the light scenes' path renders
# the sphere-lit Cornell's PRB step: not 16, which took 57.4 s (its 4,002
# faces keep the dense test, 7.2 s a pass); the phase keeps to its 90 s
SPHERE_PRB_SPP = 4
PROJECTOR_SIDE = 512        # the projector's bitmap irradiance, side^2
INTEG_CHECK_SIDE = 32       # card against CPU
Z_SCENES = ("cornell_diffuse", "cornell_glossy", "fog_cube")
Z_SPP, Z_REF_SPP, Z_SEED = 256, 1024, 3   # tests/test_regression.py


def sphere_cornell_dict(mi, width: int, height: int, max_depth: int,
                        integrator: str = "path"):
    """``mi.cornell_box`` with its ceiling light replaced by an emitting
    sphere (radius 0.18 below the ceiling, the ceiling light's radiance):
    a tessellated sphere whose NEE samples its cone."""
    d = mi.cornell_box(width, height, max_depth=max_depth)
    d["integrator"] = {"type": integrator, "max_depth": max_depth}
    d["light"] = {"type": "sphere", "center": [0.0, 0.72, 0.0],
                  "radius": 0.18, "bsdf": {"type": "ref", "id": "white"},
                  "emitter": {"type": "area", "radiance": {
                      "type": "rgb", "value": CORNELL_RADIANCE}}}
    return d


def directionalarea_cornell_dict(mi, width: int, height: int,
                                 max_depth: int, integrator: str = "path"):
    """``mi.cornell_box`` whose ceiling light is a ``directionalarea``
    emitter (it lights only along its normal: the light tracer sees it,
    the path tracer does not), with a disk area light (tessellated) on the
    back wall."""
    d = mi.cornell_box(width, height, max_depth=max_depth)
    d["integrator"] = {"type": integrator, "max_depth": max_depth}
    d["light"] = dict(d["light"], emitter={
        "type": "directionalarea",
        "radiance": {"type": "rgb", "value": CORNELL_RADIANCE}})
    d["fill"] = {"type": "disk",
                 "to_world": mi.ScalarTransform4f().translate(
                     [0.0, 0.35, -0.99]).scale(0.25),
                 "emitter": {"type": "area", "radiance": {
                     "type": "rgb", "value": [6.0, 6.0, 6.0]}}}
    return d


def projector_irradiance(side: int) -> np.ndarray:
    """The projector's bitmap: a smooth color pattern with noise, from a
    seed."""
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:side, 0:side].astype(np.float32) / side
    img = np.stack([0.6 + 0.4 * np.sin(6.0 * x), 0.6 + 0.4 * np.cos(5.0 * y),
                    0.5 + 0.3 * np.sin(4.0 * (x + y))], -1)
    return (img + 0.1 * rng.uniform(size=img.shape)).astype(np.float32)


def projector_cornell_dict(mi, width: int, height: int, max_depth: int,
                           side: int, integrator: str = "path"):
    """``mi.cornell_box`` lit by a projector under its ceiling (60 degree
    fov, scale 30) casting a side^2 bitmap onto the floor, in place of the
    ceiling light."""
    d = mi.cornell_box(width, height, max_depth=max_depth)
    d["integrator"] = {"type": integrator, "max_depth": max_depth}
    del d["light"]
    d["projector"] = {
        "type": "projector", "fov": 60.0, "scale": 30.0,
        "irradiance": {"type": "bitmap", "data": projector_irradiance(side)},
        "to_world": mi.ScalarTransform4f().look_at(
            origin=[0.0, 0.95, 0.2], target=[0.0, -1.0, 0.0],
            up=[0.0, 0.0, 1.0])}
    return d


def sunsky_dict(make_dict, transform, timed: bool = False, **kw):
    """`make_dict(transform, **kw)` (a terrain) with its constant
    environment replaced by ``sunsky`` (turbidity 3) or ``timed_sunsky``
    (10:30 on the defaults' day and place), beside its directional sun."""
    d = make_dict(transform, **kw)
    d["env"] = ({"type": "timed_sunsky", "hour": 10.5, "scale": 2.0}
                if timed else {"type": "sunsky", "turbidity": 3.0,
                               "scale": 2.0})
    return d


def z_scene_dict(mi, name: str):
    """tests/test_regression.py's three Z-test scenes (32^2) as dicts of
    package `mi`."""
    if name == "cornell_diffuse":
        return mi.cornell_box(32, 32, max_depth=4)
    if name == "cornell_glossy":
        return glossy_cornell_dict(mi, 32, 32, 4)
    return fog_cornell_dict(mi, 32, 32, 6)


def moment_mean_var(mi, d: dict, spp: int, seed: int, device=None):
    """tests/test_regression.py:50-62 on the port: the scene under
    ``{"type": "moment", "nested": <its integrator>}``, rendered; returns
    (mean RGB, mean XYZ, per-pixel XYZ variance) as numpy arrays."""
    d = dict(d)
    d["integrator"] = {"type": "moment", "nested": d.get(
        "integrator", {"type": "path", "max_depth": 4})}
    img = mi.render(mi.load_dict(d, device=device), spp=spp,
                    seed=seed).cpu().numpy()
    mean_xyz = img[..., 3:6]
    return img[..., 0:3], mean_xyz, np.maximum(img[..., 6:9]
                                               - mean_xyz ** 2, 0.0)


def _filter_var_factor(radius: float = 2.0):
    """tests/test_regression.py's variance factor of the Gaussian filter's
    pixel means, with the port's filter."""
    import torch
    from mitsuba3_tpu_torch.render.film import rfilter_eval
    j = torch.as_tensor((np.arange(4096) + 0.5) / 4096.0, dtype=torch.float32)
    a = b = 0.0
    for dd in range(-int(np.ceil(radius)), int(np.ceil(radius)) + 1):
        w = rfilter_eval("gaussian", dd + 0.5 - j, radius, 0.5).numpy()
        a += w.mean()
        b += (w * w).mean()
    return (b / (a * a)) ** 2


def z_test(mean_a, var_a, n_a, mean_ref, var_ref, n_ref, significance=0.01):
    """tests/test_regression.py's per-pixel two-sample Z-test with Sidak
    correction (test_renders.py:159-232). Returns (failing pixels,
    pixels)."""
    from scipy.ndimage import maximum_filter
    from scipy.stats import norm
    c = _filter_var_factor()
    size = (3, 3, 1)
    var_a_n = maximum_filter(var_a, size=size)
    var_ref_n = maximum_filter(var_ref, size=size)
    spread_a = maximum_filter(mean_a, size=size) - mean_a
    spread_ref = maximum_filter(mean_ref, size=size) - mean_ref
    se = np.sqrt(c * ((var_a_n + spread_a ** 2) / n_a
                      + (var_ref_n + spread_ref ** 2) / n_ref) + 1e-10)
    p = 2.0 * (1.0 - norm.cdf(np.abs(mean_a - mean_ref) / se))
    alpha = 1.0 - (1.0 - significance) ** (1.0 / p.size)
    return int((p < alpha).sum()), int(p.size)


def _timed_render(mi, scene, seeds, spp, **kw):
    """Renders at `seeds` after a warm-up at seed 0: (last image, rays,
    wall s, peak bytes)."""
    import torch
    mi.render_with_stats(scene, seed=0, spp=spp, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rays = 0
    t0 = time.perf_counter()
    for seed in seeds:
        img, r = mi.render_with_stats(scene, seed=seed, spp=spp, **kw)
        rays += r
    torch.cuda.synchronize()
    return img, rays, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()


def _integ_direct_depth(mi, card: str):
    """`direct` on terrain64k (512^2, 4 spp, one emitter and one BSDF
    sample, cellserve): a warm-up, a timed and a profiled render, K1's
    closest and any-hit launches counted from zero, its device ms and
    bound by CUDA events; then `depth` on the same scene, whose hit pixels
    must equal an `aov` depth channel of the same seed."""
    import torch
    from mitsuba3_tpu_torch.integrators import config_from_dict
    from mitsuba3_tpu_torch.ops import cellserve

    d = dict(terrain64k_dict(mi.ScalarTransform4f),
             integrator={"type": "direct"})
    w = d["sensor"]["film"]["width"]
    scene = mi.load_dict(d)
    _check(isinstance(scene.accel, cellserve.CellServe),
           "direct terrain64k: not cellserve")
    mi.render_with_stats(scene, seed=0, spp=4, max_wavefront=1 << 20)
    torch.cuda.synchronize()
    for k in cellserve.LAUNCHES:
        cellserve.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    with _K1Meter() as meter:
        t0 = time.perf_counter()
        img, rays = mi.render_with_stats(scene, seed=1, spp=4,
                                         max_wavefront=1 << 20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(cellserve.LAUNCHES)
    k1 = meter.summary()
    peak = torch.cuda.max_memory_allocated()
    _check(launches["closest"] > 0 and launches["anyhit"] > 0,
           f"direct terrain64k: K1 not launched in both modes: {launches}")
    _check(all(k1[m]["launches"] == launches[m] for m in launches),
           f"direct terrain64k: K1 meter {k1} disagrees with {launches}")
    _check(tuple(img.shape) == (w, w, 3)
           and bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
           "direct terrain64k: image misshaped, not finite or black")
    mrays = rays / wall / 1e6
    print(f"# integrators direct terrain64k 512x512 4spp: {rays} rays in "
          f"{wall:.3f} s = {mrays:.3f} Mrays/s, peak memory "
          f"{peak / 2**30:.2f} GiB, mean {float(img.mean()):.6f} [{card}]")
    for mode, v in k1.items():
        print(f"# integrators direct K1 {mode}: {v['launches']} launches, "
              f"{v['device_ms']:.2f} device ms, bound {v['bound_ms']:.3f} ms"
              f" [{card}]")
    out = {"scene": "terrain64k 512x512 4spp, direct (1 emitter + 1 BSDF "
                    "sample), cellserve", "rays": rays, "wall_s": wall,
           "mrays_per_s": mrays, "peak_bytes": peak,
           "mean": float(img.mean()), "k1": k1, "k1_launches": launches}
    _, labels = _accel_kernels("cells")
    out.update(_profile(lambda: mi.render_with_stats(
        scene, seed=2, spp=4, max_wavefront=1 << 20), wall, labels))

    depth = scene.replace(integrator=config_from_dict({"type": "depth"}))
    aov = scene.replace(integrator=config_from_dict(
        {"type": "aov", "aovs": "dd:depth"}))
    t0 = time.perf_counter()
    img_d = mi.render(depth, seed=3, spp=4, max_wavefront=1 << 20)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    img_a = mi.render(aov, seed=3, spp=4, max_wavefront=1 << 20)
    hit = img_a[..., 0] > 0
    _check(bool(hit.any()) and all(bool(torch.equal(img_d[..., c][hit],
                                                    img_a[..., 0][hit]))
                                   for c in range(3)),
           "depth terrain64k: hit pixels differ from the aov depth channel")
    print(f"# integrators depth terrain64k 512x512 4spp: {wall_d:.3f} s, "
          f"{int(hit.sum())} hit pixels equal to the aov depth channel "
          f"[{card}]")
    out["depth"] = {"wall_s": wall_d, "hit_pixels": int(hit.sum()),
                    "equal_to_aov": True}
    del scene, depth, aov
    torch.cuda.empty_cache()
    return out


def _integ_aov(mi, card: str):
    """`aov` on interior120k: all eight AOVs and a nested `path`
    (max_depth 4), 20 channels, 256^2, 4 spp, cellserve: a warm-up and a
    timed render, K1's launches; the last three channels must equal a
    plain `path` render at the same seed (aov draws no random number)."""
    import torch
    from mitsuba3_tpu_torch.integrators import config_from_dict
    from mitsuba3_tpu_torch.ops import cellserve

    d = interior_dict(mi.ScalarTransform4f, INTERIOR_TRIS)
    d["integrator"] = {"type": "aov", "aovs": ALL_AOVS,
                       "integrator": {"type": "path", "max_depth": 4}}
    w = d["sensor"]["film"]["width"]
    scene = mi.load_dict(d)
    mi.render_with_stats(scene, seed=0, spp=4, max_wavefront=1 << 20)
    torch.cuda.synchronize()
    for k in cellserve.LAUNCHES:
        cellserve.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    img, rays = mi.render_with_stats(scene, seed=1, spp=4,
                                     max_wavefront=1 << 20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cellserve.LAUNCHES)
    _check(tuple(img.shape) == (w, w, 20)
           and bool(torch.isfinite(img).all()),
           f"aov interior120k: image {tuple(img.shape)} not {w}x{w}x20 or "
           f"not finite")
    _check(launches["closest"] > 0, f"aov interior120k: K1 closest not "
           f"launched: {launches}")
    path = mi.render(scene.replace(integrator=config_from_dict(
        {"type": "path", "max_depth": 4})), seed=1, spp=4,
        max_wavefront=1 << 20)
    diff = float((img[..., 17:] - path).abs().max())
    _check(bool(torch.equal(img[..., 17:], path)),
           f"aov interior120k: its RGB differs from path's by {diff}")
    print(f"# integrators aov interior120k 256x256 4spp (8 AOVs + path, 20 "
          f"channels): {rays} rays in {wall:.3f} s = "
          f"{rays / wall / 1e6:.3f} Mrays/s, K1 launches {launches}; RGB "
          f"equal to path's [{card}]")
    del scene
    torch.cuda.empty_cache()
    return {"scene": "interior120k 256x256 4spp, aov (8 AOVs) + path "
                     "max_depth 4, cellserve", "channels": 20, "rays": rays,
            "wall_s": wall, "mrays_per_s": rays / wall / 1e6,
            "k1_launches": launches, "rgb_equal_to_path": True}


def _integ_moment_ptracer(mi, card: str):
    """bench.py's Cornell (512^2, max_depth 8): `moment` around `path` at
    INTEG_CORNELL_SPP, whose RGB must equal the `path` render of the same
    seed; the three Z-tests of tests/test_regression.py through the
    port's moment against tests/data/ref_*.npz; the light tracer at
    PTRACER_SPP (wall, light paths/s, peak memory), its per-channel mean
    within PTRACER_RTOL of the path render's."""
    import torch

    d = mi.cornell_box(512, 512, max_depth=8)
    path = mi.load_dict(d)
    d_m = dict(d, integrator={"type": "moment", "nested": d["integrator"]})
    moment = mi.load_dict(d_m)
    t0 = time.perf_counter()
    img_m = mi.render(moment, seed=1, spp=INTEG_CORNELL_SPP)
    torch.cuda.synchronize()
    wall_m = time.perf_counter() - t0
    img_p = mi.render(path, seed=1, spp=INTEG_CORNELL_SPP)
    _check(tuple(img_m.shape) == tuple(img_p.shape[:2]) + (9,)
           and bool(torch.equal(img_m[..., :3], img_p)),
           f"moment cornell: RGB differs from path's by "
           f"{float((img_m[..., :3] - img_p).abs().max())}")
    print(f"# integrators moment cornell 512x512 {INTEG_CORNELL_SPP}spp: "
          f"{wall_m:.3f} s, RGB equal to path's [{card}]")
    out = {"moment": {"wall_s": wall_m, "rgb_equal_to_path": True}}

    z = {}
    data = os.path.join(ROOT, "tests", "data")
    for name in Z_SCENES:
        ref = np.load(os.path.join(data, f"ref_{name}.npz"))
        _, mean_xyz, var_xyz = moment_mean_var(
            mi, z_scene_dict(mi, name), Z_SPP, Z_SEED)
        fails, n_pix = z_test(mean_xyz, var_xyz, Z_SPP, ref["mean_xyz"],
                              ref["var_xyz"], Z_REF_SPP)
        _check(fails <= max(3, n_pix // 500),
               f"Z-test {name}: {fails} of {n_pix} pixels fail")
        z[name] = {"fails": fails, "pixels": n_pix}
    print(f"# integrators Z-tests through moment (32x32, {Z_SPP} spp, seed "
          f"{Z_SEED}): {z} [{card}]")
    out["z_tests"] = z

    pt = mi.load_dict(dict(d, integrator={"type": "ptracer",
                                          "max_depth": 8}))
    mi.render(pt, seed=0, spp=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img_t = mi.render(pt, seed=1, spp=PTRACER_SPP)
    torch.cuda.synchronize()
    wall_t = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    paths = img_t.shape[0] * img_t.shape[1] * PTRACER_SPP
    m_t = img_t.mean(dim=(0, 1)).cpu().numpy()
    m_p = img_p.mean(dim=(0, 1)).cpu().numpy()
    rel = np.abs(m_t / m_p - 1.0)
    _check(bool(torch.isfinite(img_t).all()) and bool((rel <= PTRACER_RTOL)
                                                      .all()),
           f"ptracer cornell: channel means {m_t} not within "
           f"{PTRACER_RTOL} of path's {m_p}")
    print(f"# integrators ptracer cornell 512x512 {PTRACER_SPP}spp "
          f"max_depth 8: {paths} light paths in {wall_t:.3f} s = "
          f"{paths / wall_t / 1e6:.3f} M paths/s, peak memory "
          f"{peak / 2**30:.2f} GiB; means {m_t} vs path's {m_p} (rel "
          f"{rel.max():.4f}) [{card}]")
    out["ptracer"] = {"light_paths": paths, "wall_s": wall_t,
                      "mpaths_per_s": paths / wall_t / 1e6,
                      "peak_bytes": peak, "mean": m_t.tolist(),
                      "path_mean": m_p.tolist(),
                      "max_rel_to_path": float(rel.max())}
    del path, moment, pt
    torch.cuda.empty_cache()
    return out


def _integ_lights(mi, card: str):
    """The sphere-lit Cornell's PRB step (512^2, SPHERE_PRB_SPP, no
    warm-up of its own; em_radiance's gradient finite and nonzero), `path`
    renders of the
    directionalarea and projector Cornells (512^2, LIGHTS_SPP; a
    PROJECTOR_SIDE^2 bitmap), terrain64k under sunsky and timed_sunsky
    (512^2, 4 spp, K1 launched in both modes)."""
    import torch
    from mitsuba3_tpu_torch.ops import cellserve

    out = {}
    scene = mi.load_dict(_prb_dict(sphere_cornell_dict(mi, 512, 512, 8)))
    _check(len(scene.em_sphere_slots) == 1, "sphere cornell: no sphere "
           "emitter slot")
    names = ("bsdf_params", "em_radiance")
    # the step runs once, without a warm-up of its own (the Cornell steps
    # before it ran its operations): the script keeps to its time limit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, rays, grads, n_passes = _grad_step(scene, names, 1,
                                             SPHERE_PRB_SPP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_grads("sphere cornell prb", grads, ("em_radiance",))
    print(f"# integrators sphere cornell PRB step 512x512 "
          f"{SPHERE_PRB_SPP}spp: {rays} forward rays, {wall:.3f} s in "
          f"{n_passes} passes [{card}]")
    out["sphere_cornell_prb"] = {
        "faces": int((scene.face_shape >= 0).sum()), "forward_rays": rays,
        "wall_s": wall, "passes": n_passes,
        "em_radiance_grad": grads["em_radiance"][0].tolist()}
    del scene
    for tag, d in (("directionalarea cornell", directionalarea_cornell_dict(
            mi, 512, 512, 8)), ("projector cornell", projector_cornell_dict(
            mi, 512, 512, 8, PROJECTOR_SIDE))):
        img, rays, wall, _ = _timed_render(mi, mi.load_dict(d), (1,),
                                           LIGHTS_SPP)
        _check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
               f"{tag}: image not finite or black")
        print(f"# integrators {tag} path 512x512 {LIGHTS_SPP}spp: {rays} "
              f"rays in {wall:.3f} s = {rays / wall / 1e6:.3f} Mrays/s, "
              f"mean {float(img.mean()):.6f} [{card}]")
        out[tag] = {"rays": rays, "wall_s": wall,
                    "mrays_per_s": rays / wall / 1e6,
                    "mean": float(img.mean())}
    for timed in (False, True):
        tag = "timed_sunsky" if timed else "sunsky"
        scene = mi.load_dict(sunsky_dict(terrain64k_dict,
                                         mi.ScalarTransform4f, timed))
        for k in cellserve.LAUNCHES:
            cellserve.LAUNCHES[k] = 0
        img, rays, wall, _ = _timed_render(mi, scene, (1,), 4,
                                           max_wavefront=1 << 20)
        launches = dict(cellserve.LAUNCHES)
        _check(all(v > 0 for v in launches.values()),
               f"{tag} terrain64k: K1 not launched in both modes: "
               f"{launches}")
        _check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
               f"{tag} terrain64k: image not finite or black")
        print(f"# integrators {tag} terrain64k 512x512 4spp: {rays} rays "
              f"in {wall:.3f} s = {rays / wall / 1e6:.3f} Mrays/s, env "
              f"{tuple(scene.env_data.shape)}, K1 launches {launches} "
              f"(warm-up and timed) [{card}]")
        out[f"{tag} terrain64k"] = {"rays": rays, "wall_s": wall,
                                    "mrays_per_s": rays / wall / 1e6,
                                    "k1_launches": launches}
        del scene
    torch.cuda.empty_cache()
    return out


def _integ_agreement(mi):
    """Card against CPU at INTEG_CHECK_SIDE^2 (4 spp, seed 5): direct,
    aov (every AOV and a nested path), moment and the light tracer on the
    Cornell box; the sphere, directionalarea (path and light tracer) and
    projector Cornells; the small terrain under sunsky and timed_sunsky.
    The light tracer's splat is atomic on the card, so its sums differ in
    rounding: every image is held to the same tolerance (isclose 1e-3 on
    > 99.5 % of values, means rtol 1e-3)."""
    side = INTEG_CHECK_SIDE
    T = mi.ScalarTransform4f

    def cornell(integrator):
        return dict(mi.cornell_box(side, side, max_depth=4),
                    integrator=integrator)

    cases = [
        ("direct cornell", cornell({"type": "direct"})),
        ("aov cornell", cornell({"type": "aov", "aovs": ALL_AOVS,
                                 "integrator": {"type": "path",
                                                "max_depth": 4}})),
        ("moment cornell", cornell({"type": "moment", "nested": {
            "type": "path", "max_depth": 4}})),
        ("ptracer cornell", cornell({"type": "ptracer", "max_depth": 4})),
        ("sphere cornell", sphere_cornell_dict(mi, side, side, 4)),
        ("directionalarea cornell", directionalarea_cornell_dict(
            mi, side, side, 4)),
        ("directionalarea cornell ptracer", directionalarea_cornell_dict(
            mi, side, side, 4, "ptracer")),
        ("projector cornell", projector_cornell_dict(mi, side, side, 4,
                                                     side)),
        ("sunsky small terrain", sunsky_dict(small_terrain_dict, T,
                                             width=side)),
        ("timed_sunsky small terrain", sunsky_dict(
            small_terrain_dict, T, True, width=side))]
    out = {}
    for tag, d in cases:
        with _accel("cells"):
            img_g = mi.render(mi.load_dict(d), seed=5, spp=4)
            img_c = mi.render(mi.load_dict(d, device="cpu"), seed=5, spp=4)
        out[tag] = _agree_images(f"{tag} ({side}x{side}, 4 spp)",
                                 img_g.cpu().numpy(), img_c.numpy())
    return out


def phase_integrators(mi, card: str):
    """The other integrators and the new lights on the card (nothing falls
    back to the CPU): direct and depth on terrain64k, aov on interior120k,
    moment, the Z-tests and the light tracer on the Cornell box, the
    sphere, directionalarea and projector Cornells and the sunsky
    terrains, then the card against the CPU."""
    out = {}
    for name, part in (("direct_depth", _integ_direct_depth),
                       ("aov", _integ_aov),
                       ("moment_ptracer", _integ_moment_ptracer),
                       ("lights", _integ_lights),
                       ("agreement", lambda m, _: _integ_agreement(m))):
        t0 = time.perf_counter()
        out[name] = part(mi, card)
        print(f"# integrators {name}: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Materials: principled, principledthin, measured, a user's BSDF and hair
# ---------------------------------------------------------------------------

MEASURED_RES = 64            # the measured tables' warp side
MAT_CORNELL_SPP = 8          # the materials Cornell's path render, 512^2
MAT_PRB_SPP = 4
MAT_CHECK_SIDE = 32          # card against CPU
HAIR_STRANDS = 1024
HAIR_POINTS = 17             # 16 segments a strand
HAIR_RADIUS = 0.004
HAIR_SIDES = 6
HAIR_PRB_SIDE = 128          # the script keeps to its time limit
PRINCIPLED_TERRAIN_BSDF = {"type": "principled", "metallic": 0.4,
                           "roughness": 0.35, "anisotropic": 0.3,
                           "clearcoat": 0.6, "sheen": 0.3}


def measured_fields(n_phi: int = 1, n_ti: int = 8, res: int = MEASURED_RES,
                    alpha: float = 0.35) -> dict:
    """An RGL-style measured table set made from a GGX lobe, as
    tests/test_measured.py's _ggx_tables and _aniso_tables make it: the
    vndf slice of each incident direction holds the visible-normal
    density in the (theta2u, phi2u) square, times that square's measure.
    One phi_i entry gives an isotropic set; more give an anisotropic one
    over phi_i in [-pi, 0] (symmetry reduction 2), whose roughness and
    stretch depend on the azimuth."""
    aniso = n_phi > 1
    phi_i = (np.linspace(-np.pi, 0.0, n_phi) if aniso
             else np.zeros(1)).astype(np.float32)
    theta_i = np.linspace(0.0, np.pi / 2 * 0.96, n_ti).astype(np.float32)
    u = (np.arange(res) + 0.5) / res
    theta_m = u ** 2 * (np.pi / 2)
    phi_m = (2 * u - 1) * np.pi
    st, ct = np.sin(theta_m), np.cos(theta_m)
    mx = np.cos(phi_m)[:, None] * st[None, :]
    my = np.sin(phi_m)[:, None] * st[None, :]
    mz = np.broadcast_to(ct[None, :], (res, res))
    jac_u = st[None, :] * (np.pi * u)[None, :] * (2 * np.pi)
    c2 = np.clip(mz, 1e-5, 1.0) ** 2
    vndf = np.zeros((n_phi, n_ti, res, res), np.float32)
    for p, pi_ in enumerate(phi_i):
        a = 0.25 + 0.2 * abs(np.sin(pi_)) if aniso else alpha
        d = 1.0 / (np.pi * a ** 2 * c2 ** 2 * (1 + (1 - c2) / c2 / a ** 2)
                   ** 2)
        if aniso:
            d = d * (1.0 + 0.6 * mx ** 2 - 0.3 * my ** 2 + 0.35)
        for i, ti in enumerate(theta_i):
            wi = (np.sin(ti) * np.cos(pi_), np.sin(ti) * np.sin(pi_),
                  np.cos(ti))
            cos_wi_m = np.maximum(wi[0] * mx + wi[1] * my + wi[2] * mz, 0)
            vndf[p, i] = d * cos_wi_m * jac_u + 1e-8
    sx, sy = np.meshgrid(u, u)
    rgb = np.zeros((n_phi, n_ti, 3, res, res), np.float32)
    for c, (a, b) in enumerate(((0.9, 0.1), (0.5, 0.4), (0.2, 0.7))):
        rgb[:, :, c] = a * (0.3 + 0.7 * sx) + b * sy
    ndf = (1.0 / (np.pi * alpha ** 2 * c2 ** 2 * (1 + (1 - c2) / c2
                                                  / alpha ** 2) ** 2))
    return {"phi_i": phi_i, "theta_i": theta_i, "vndf": vndf,
            "luminance": vndf * 0.8 + 0.05, "rgb": rgb,
            "ndf": (ndf + 1e-8).astype(np.float32),
            "sigma": (0.25 + 0.5 * np.outer(u, u)).astype(np.float32)}


def write_measured(dirpath: str, res: int = MEASURED_RES):
    """The materials Cornell's two .bsdf files, written by the port's own
    tensor_io: (isotropic path, anisotropic path); 8 theta_i slices, and
    4 x 8 (phi_i, theta_i) slices."""
    from mitsuba3_tpu_torch.utils import tensor_io
    paths = []
    for name, n_phi in (("iso.bsdf", 1), ("aniso.bsdf", 4)):
        paths.append(os.path.join(dirpath, name))
        tensor_io.write(paths[-1], **measured_fields(n_phi, 8, res))
    return tuple(paths)


def half_diffuse_module():
    """A user's BSDF written in torch on the port's records: Lambertian
    reflection of the row's [0:3] (half_diffuse_lower halves the spec's
    reflectance into it), sampled by the cosine warp, two-sided by the
    row's flag [16]: it renders as diffuse at half the reflectance."""
    import types

    import torch
    from mitsuba3_tpu_torch.core import math as m
    from mitsuba3_tpu_torch.core.vec import Vec3
    from mitsuba3_tpu_torch.core.warp import square_to_cosine_hemisphere
    from mitsuba3_tpu_torch.render.records import BSDFSample

    def side(params, si):
        return torch.where((params[16] > 0.5) & (si.wi.z < 0.0), -1.0, 1.0)

    def sample(scene, bsdf_idx, si, s1, s2):
        params = scene.gather_bsdf_params(bsdf_idx)
        sgn = side(params, si)
        active = si.wi.z * sgn > 0.0
        wo = square_to_cosine_hemisphere(s2)
        pdf = wo.z * m.InvPi
        bs = BSDFSample(
            wo=Vec3(wo.x, wo.y, wo.z * sgn),
            pdf=torch.where(active, pdf, 0.0), eta=torch.ones_like(pdf),
            sampled_type=torch.full_like(pdf, 0x0002, dtype=torch.int32),
            sampled_component=torch.zeros_like(pdf, dtype=torch.int32))
        return bs, Vec3(params[0], params[1], params[2]).mask(active)

    def eval_pdf(scene, bsdf_idx, si, wo):
        params = scene.gather_bsdf_params(bsdf_idx)
        sgn = side(params, si)
        cos_o = wo.z * sgn
        active = (si.wi.z * sgn > 0.0) & (cos_o > 0.0)
        factor = m.InvPi * torch.clamp(cos_o, min=0.0)
        value = Vec3(params[0], params[1], params[2]) * factor
        return value.mask(active), torch.where(active, factor, 0.0)

    return types.SimpleNamespace(FLAGS=0x0002 | 0x2000, sample=sample,
                                 eval_pdf=eval_pdf)


def half_diffuse_lower(spec) -> np.ndarray:
    """half_diffuse's row: half the spec's reflectance in [0:3]
    (tests/test_custom_plugins.py:40)."""
    r = spec.get("reflectance", {"type": "rgb", "value": 0.5})
    val = r["value"] if isinstance(r, dict) else r
    return 0.5 * np.broadcast_to(np.asarray(val, np.float32), (3,))


def register_half_diffuse(mt) -> int:
    """Register half_diffuse with the port `mt`; returns its type id."""
    return mt.register_bsdf("half_diffuse", half_diffuse_module(),
                            half_diffuse_lower)


def materials_cornell_dict(mi, width: int, height: int, max_depth: int,
                           iso, aniso):
    """bench.py's Cornell box in the slice's materials (`mi` the port or
    the JAX package, with half_diffuse registered): a principled floor
    (metallic, clearcoat, anisotropic), a principled left wall (sheen,
    flatness; a checkerboard base_color), a principledthin small box
    (spec_trans 0.6, diff_trans 0.5), a measured back wall (`iso`) and
    tall box (`aniso`), each a measured spec (a .bsdf filename or its
    tables), and a half_diffuse right wall."""
    d = mi.cornell_box(width, height, max_depth=max_depth)
    d["floor"]["bsdf"] = {
        "type": "principled", "metallic": 0.7, "roughness": 0.3,
        "anisotropic": 0.5, "clearcoat": 0.8, "clearcoat_gloss": 0.6,
        "base_color": {"type": "rgb", "value": [0.85, 0.75, 0.6]}}
    d["red-wall"]["bsdf"] = {
        "type": "principled", "roughness": 0.6, "sheen": 0.8,
        "sheen_tint": 0.5, "flatness": 0.7, "spec_tint": 0.3,
        "base_color": {"type": "checkerboard", "color0": [0.6, 0.05, 0.05],
                       "color1": [0.3, 0.3, 0.3]}}
    d["small-box"]["bsdf"] = {
        "type": "principledthin", "spec_trans": 0.6, "diff_trans": 0.5,
        "roughness": 0.4, "eta": 1.4,
        "base_color": {"type": "rgb", "value": [0.7, 0.8, 0.9]}}
    d["back"]["bsdf"] = {"type": "measured", **iso}
    d["large-box"]["bsdf"] = {"type": "measured", **aniso}
    d["green-wall"]["bsdf"] = {"type": "half_diffuse", "reflectance": {
        "type": "rgb", "value": [0.21, 0.75, 0.15]}}
    return d


def materials_cornell_xml(mt, dirpath: str, width: int, height: int,
                          max_depth: int) -> str:
    """The materials Cornell as a user's scene file: its two measured
    tables written as .bsdf files, the scene as XML by the port's
    ``write_file``. Returns the XML file's path."""
    from mitsuba3_tpu_torch.utils import xml as xml_mod
    iso, aniso = write_measured(dirpath)
    d = materials_cornell_dict(mt, width, height, max_depth,
                               {"filename": iso}, {"filename": aniso})
    path = os.path.join(dirpath, f"materials_cornell_{width}x{height}.xml")
    xml_mod.write_file(d, path)
    return path


def hair_strands(n_strands: int = HAIR_STRANDS,
                 n_points: int = HAIR_POINTS, seed: int = 3) -> np.ndarray:
    """[n_strands, n_points, 3] hair: roots on the upper part of a scalp
    sphere (radius 0.5), each strand leaving along its normal and drooping
    under gravity, with a little noise."""
    rng = np.random.default_rng(seed)
    phi = rng.uniform(0.0, 2 * np.pi, n_strands)
    y = rng.uniform(-0.2, 0.95, n_strands)
    r = np.sqrt(1.0 - y * y)
    normal = np.stack([r * np.cos(phi), y, r * np.sin(phi)], -1)
    length = rng.uniform(0.5, 0.8, n_strands)
    seg = length / (n_points - 1)
    pts = np.zeros((n_strands, n_points, 3))
    pts[:, 0] = 0.5 * normal
    d = normal.copy()
    for k in range(1, n_points):
        d = d + np.array([0.0, -0.18, 0.0]) + 0.05 * rng.standard_normal(
            (n_strands, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts[:, k] = pts[:, k - 1] + seg[:, None] * d
    return pts


def write_curve_file(path: str, strands, radius: float):
    """Strands as a curve text file (linearcurve.cpp: ``x y z radius``
    lines, a blank line between curves)."""
    with open(path, "w") as f:
        for s in strands:
            f.write("\n".join(f"{x!r} {y!r} {z!r} {radius!r}"
                              for x, y, z in s.tolist()) + "\n\n")
    return path


def hair_dict(mi, curve_path: str, width: int, bsdf: dict,
              curve: str = "linearcurve", n_sides: int = HAIR_SIDES,
              tessellate=None, spp: int = 4, max_depth: int = 8):
    """A hair ball (a curve file, `bsdf` on every strand) lit by a point
    light and a constant environment, seen by a 45-degree camera."""
    T = mi.ScalarTransform4f
    shape = {"type": curve, "filename": curve_path, "n_sides": n_sides,
             "bsdf": bsdf}
    if tessellate is not None:
        shape["tessellate"] = tessellate
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": max_depth},
        "sensor": {"type": "perspective", "fov": 45.0,
                   "to_world": T().look_at(origin=[0.0, 0.4, 2.6],
                                           target=[0.0, 0.0, 0.0],
                                           up=[0, 1, 0]),
                   "film": {"width": width, "height": width,
                            "rfilter": {"type": "box"}},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "hair": shape,
        "light": {"type": "point", "position": [1.5, 2.0, 2.0],
                  "intensity": {"type": "rgb", "value": [12.0, 11.0, 10.0]}},
        "env": {"type": "constant",
                "radiance": {"type": "rgb", "value": 0.15}}}


def principled_terrain_dict(make_dict, transform, root=None, **kw):
    """`make_dict(transform, **kw)` (terrain64k_dict or small_terrain_dict)
    in PRINCIPLED_TERRAIN_BSDF; with `root`, its base_color is
    ``terrain.exr`` under `root` (write_terrain_textures; mipmapped, to_uv
    a scale of 4, over planar uvs from x and y)."""
    d = make_dict(transform, **kw)
    bsdf = dict(PRINCIPLED_TERRAIN_BSDF)
    terrain = dict(d["terrain"], bsdf=bsdf)
    if root is not None:
        v = np.asarray(terrain["vertices"], np.float64)
        lo, hi = v[:, :2].min(0), v[:, :2].max(0)
        terrain["uvs"] = (v[:, :2] - lo) / (hi - lo)
        bsdf["base_color"] = {
            "type": "bitmap", "filename": os.path.join(root, "terrain.exr"),
            "mipmap": True, "to_uv": transform().scale([4.0, 4.0, 1.0])}
    d["terrain"] = terrain
    return d


HAIR_EUMELANIN = {"type": "hair", "eumelanin": 1.3}
HAIR_SIGMA_A = {"type": "hair", "sigma_a": {"type": "rgb",
                                            "value": [0.25, 0.45, 0.9]}}


def _mat_hair(mi, card: str, tmp: str):
    """The hair ball: HAIR_STRANDS strands of HAIR_POINTS points written as
    a linearcurve file and tessellated by the loader (16,384 cones are
    above the 512 that JAX makes analytic), in hair of eumelanin 1.3, lit
    by a point light and a constant environment: `path` at 512^2, 4 spp,
    max_depth 8 through cellserve; a timed render with K1's
    launches counted from zero (closest and any-hit must launch) and its
    device ms and bound by CUDA events (_K1Meter), and a profiled render;
    then a PRB step of the ball in hair of a sigma_a at HAIR_PRB_SIDE^2,
    4 spp (no warm-up of its own), whose sigma_a gradient must be finite
    and nonzero. (The sigma_a ball's own 512^2 render, which ran the same
    operations, is cut: the script keeps to its time limit.)"""
    import torch
    from mitsuba3_tpu_torch import bsdfs
    from mitsuba3_tpu_torch.ops import cellserve

    path = write_curve_file(os.path.join(tmp, "hair_ball.txt"),
                            hair_strands(HAIR_STRANDS, HAIR_POINTS),
                            HAIR_RADIUS)
    out = {}
    n_faces = HAIR_STRANDS * (HAIR_POINTS - 1) * HAIR_SIDES * 2
    name = "eumelanin"
    d = hair_dict(mi, path, 512, HAIR_EUMELANIN)
    w = d["sensor"]["film"]["width"]
    t0 = time.perf_counter()
    scene = mi.load_dict(d)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    faces = int((scene.face_shape >= 0).sum())
    _check(isinstance(scene.accel, cellserve.CellServe)
           and faces == n_faces and scene.bsdf_types == (bsdfs.HAIR,),
           f"hair ball: {faces} faces (not {n_faces}) or not cellserve")
    # no warm-up render: the renders before it ran its operations
    torch.cuda.reset_peak_memory_stats()
    for k in cellserve.LAUNCHES:
        cellserve.LAUNCHES[k] = 0
    with _K1Meter() as meter:
        t0 = time.perf_counter()
        img, rays = mi.render_with_stats(scene, seed=1, spp=4,
                                         max_wavefront=1 << 20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(cellserve.LAUNCHES)
    k1 = meter.summary()
    peak = torch.cuda.max_memory_allocated()
    _check(all(v > 0 for v in launches.values()),
           f"hair ball ({name}): K1 not launched in both modes: "
           f"{launches}")
    _check(all(k1[m]["launches"] == launches[m] for m in launches),
           f"hair ball: K1 meter {k1} disagrees with {launches}")
    _check(tuple(img.shape) == (w, w, 3)
           and bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
           f"hair ball ({name}): image misshaped, not finite or black")
    mrays = rays / wall / 1e6
    print(f"# materials hair ball ({name}) {faces} faces 512x512 4spp: "
          f"{rays} rays in {wall:.3f} s = {mrays:.3f} Mrays/s, peak "
          f"memory {peak / 2**30:.2f} GiB, load_dict {load_s:.2f} s, "
          f"mean {float(img.mean()):.6f} [{card}]")
    for mode, v in k1.items():
        print(f"# materials hair ball ({name}) K1 {mode}: "
              f"{v['launches']} launches for {v['queries']} queries, "
              f"{v['device_ms']:.2f} device ms, bound "
              f"{v['bound_ms']:.3f} ms [{card}]")
    out[name] = {"faces": faces, "rays": rays, "wall_s": wall,
                 "mrays_per_s": mrays, "peak_bytes": peak,
                 "load_dict_s": load_s, "mean": float(img.mean()),
                 "k1": k1, "k1_launches": launches}
    out[name].update(_profile(lambda: mi.render_with_stats(
        scene, seed=2, spp=4, max_wavefront=1 << 20), wall,
        _accel_kernels("cells")[1]))
    del scene, img
    torch.cuda.empty_cache()

    # the step runs once, without a warm-up of its own (the renders above
    # ran its forward operations): the phase keeps to its time
    d = _prb_dict(hair_dict(mi, path, HAIR_PRB_SIDE, HAIR_SIGMA_A))
    scene = mi.load_dict(d)
    names = ("bsdf_params",)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, rays, grads, n_passes = _grad_step(scene, names, 1, 4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_grads("hair ball prb", grads, names)
    g = grads["bsdf_params"][0, 4:7]
    _check(bool((g != 0).all()), f"hair ball prb: sigma_a gradient {g} has "
           f"a zero")
    print(f"# materials hair ball fwd+PRB bwd {HAIR_PRB_SIDE}x"
          f"{HAIR_PRB_SIDE} 4spp: {rays} forward rays, step {wall:.3f} s in "
          f"{n_passes} passes, sigma_a gradient {g.tolist()} [{card}]")
    out["prb"] = {"side": HAIR_PRB_SIDE, "forward_rays": rays,
                  "wall_s": wall, "passes": n_passes, "loss": loss,
                  "sigma_a_grad": g.tolist()}
    del scene, grads
    torch.cuda.empty_cache()
    return out


def _mat_terrain(mi, card: str, tmp: str):
    """terrain64k in PRINCIPLED_TERRAIN_BSDF with the mipmapped 2048^2
    EXR of write_terrain_textures as its base_color: a warm-up and a timed
    512^2, 4 spp render through cellserve with K1 launched in both modes,
    then a PRB step (4 spp, no warm-up of its own) whose principled row
    (metallic, roughness, clearcoat) and texture gradients must be finite
    and nonzero."""
    import torch
    from mitsuba3_tpu_torch import bsdfs
    from mitsuba3_tpu_torch.ops import cellserve

    write_terrain_textures(tmp)
    d = principled_terrain_dict(terrain64k_dict, mi.ScalarTransform4f, tmp)
    scene = mi.load_dict(d)
    _check(isinstance(scene.accel, cellserve.CellServe)
           and scene.bsdf_types == (bsdfs.PRINCIPLED,)
           and tuple(scene.textures[0].shape) == (TERRAIN_TEX_SIDE,) * 2
           + (3,), "principled terrain64k: not cellserve, principled and "
           "textured")
    mi.render_with_stats(scene, seed=0, spp=4, max_wavefront=1 << 20)
    for k in cellserve.LAUNCHES:
        cellserve.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, rays = mi.render_with_stats(scene, seed=1, spp=4,
                                     max_wavefront=1 << 20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cellserve.LAUNCHES)
    _check(all(v > 0 for v in launches.values()),
           f"principled terrain64k: K1 not launched in both modes: "
           f"{launches}")
    _check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
           "principled terrain64k: image not finite or black")
    print(f"# materials principled terrain64k 512x512 4spp: {rays} rays in "
          f"{wall:.3f} s = {rays / wall / 1e6:.3f} Mrays/s, K1 launches "
          f"{launches} [{card}]")
    out = {"render": {"rays": rays, "wall_s": wall,
                      "mrays_per_s": rays / wall / 1e6,
                      "k1_launches": launches, "mean": float(img.mean())}}
    del scene, img
    names = ("bsdf_params", "textures")
    scene = mi.load_dict(_prb_dict(d))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, rays, grads, n_passes = _grad_step(scene, names, 1,
                                             TERRAIN_PRB_SPP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_grads("principled terrain64k prb", grads, ("bsdf_params",))
    _check_texture_grads("principled terrain64k prb", grads, 1)
    g = grads["bsdf_params"][0, [4, 5, 11]]
    _check(bool((g != 0).all()), f"principled terrain64k prb: metallic, "
           f"roughness, clearcoat gradients {g.tolist()} have a zero")
    print(f"# materials principled terrain64k fwd+PRB bwd 512x512 "
          f"{TERRAIN_PRB_SPP}spp: {rays} forward rays, step {wall:.3f} s in "
          f"{n_passes} passes; metallic, roughness, clearcoat gradients "
          f"{g.tolist()} [{card}]")
    out["prb"] = {"forward_rays": rays, "wall_s": wall, "passes": n_passes,
                  "loss": loss, "principled_grad": g.tolist()}
    del scene, grads
    torch.cuda.empty_cache()
    return out


def _mat_cornell(mi, card: str, tmp: str):
    """The materials Cornell (materials_cornell_xml: its measured tables
    read from .bsdf files by load_file of an XML scene, half_diffuse
    registered in torch) at 512^2, max_depth 8: a `path` render at
    MAT_CORNELL_SPP spp, timed after a one-pass warm-up, and a profiled
    pass (launches of a pass); a PRB step at MAT_PRB_SPP spp (no warm-up
    of its own) whose principled and principledthin row gradients must be
    finite and nonzero."""
    import torch
    from mitsuba3_tpu_torch import bsdfs
    from mitsuba3_tpu_torch.render import integrator as ri

    register_half_diffuse(mi)
    scene = mi.load_file(materials_cornell_xml(mi, tmp, 512, 512, 8))
    _check(len(scene.measured_tables) == 2 and {
        bsdfs.PRINCIPLED, bsdfs.PRINCIPLED_THIN, bsdfs.MEASURED,
        bsdfs.custom_type("half_diffuse")[0]} <= set(scene.bsdf_types),
        "materials cornell: a material is missing")
    sppc, n_passes = ri.plan_passes(scene, MAT_CORNELL_SPP)
    ri.render_pass(scene, 0, sppc, 0, MAT_CORNELL_SPP, base_seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img, rays = mi.render_with_stats(scene, seed=1, spp=MAT_CORNELL_SPP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
           "materials cornell: image not finite or black")
    print(f"# materials cornell path 512x512 {MAT_CORNELL_SPP}spp: {rays} "
          f"rays in {wall:.3f} s = {rays / wall / 1e6:.3f} Mrays/s in "
          f"{n_passes} passes, peak memory {peak / 2**30:.2f} GiB [{card}]")
    out = {"path": {"rays": rays, "wall_s": wall, "passes": n_passes,
                    "mrays_per_s": rays / wall / 1e6, "peak_bytes": peak,
                    "mean": float(img.mean())}}
    out["path"].update(_profile(lambda: ri.render_pass(
        scene, 2, sppc, 0, MAT_CORNELL_SPP, base_seed=2),
        wall / n_passes, {}))
    del scene, img
    iso, aniso = (os.path.join(tmp, n) for n in ("iso.bsdf", "aniso.bsdf"))
    scene = mi.load_dict(_prb_dict(materials_cornell_dict(
        mi, 512, 512, 8, {"filename": iso}, {"filename": aniso})))
    names = ("bsdf_params", "em_radiance", "textures")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, rays, grads, n_passes = _grad_step(scene, names, 1, MAT_PRB_SPP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_grads("materials cornell prb", grads, ("bsdf_params",
                                                  "em_radiance"))
    g = grads["bsdf_params"]
    for t in (bsdfs.PRINCIPLED, bsdfs.PRINCIPLED_THIN):
        for i in (i for i, ti in enumerate(scene.bsdf_types) if ti == t):
            _check(bool((g[i, 4:7] != 0).any()), f"materials cornell prb: "
                   f"row {i} (type {t}) gradient {g[i, :16].tolist()} is "
                   f"zero in [4:7]")
    print(f"# materials cornell fwd+PRB bwd 512x512 {MAT_PRB_SPP}spp: "
          f"{rays} forward rays, step {wall:.3f} s in {n_passes} passes "
          f"[{card}]")
    out["prb"] = {"forward_rays": rays, "wall_s": wall, "passes": n_passes,
                  "loss": loss}
    del scene, grads
    torch.cuda.empty_cache()
    return out


def _mat_agreement(mi, tmp: str):
    """Card against CPU at MAT_CHECK_SIDE^2 (4 spp, seed 5): the materials
    Cornell (max_depth 4, tables from its .bsdf files), the small terrain
    in PRINCIPLED_TERRAIN_BSDF with its textured base_color, and a
    tessellated bsplinecurve hair scene of 12 strands; each held by
    _agree_images (> 99.5 % of values isclose 1e-3, means rtol 1e-3)."""
    side = MAT_CHECK_SIDE
    iso, aniso = (os.path.join(tmp, n) for n in ("iso.bsdf", "aniso.bsdf"))
    strands = write_curve_file(os.path.join(tmp, "strands.txt"),
                               hair_strands(12, 8, seed=4), 0.02)
    cases = [
        ("materials cornell", materials_cornell_dict(
            mi, side, side, 4, {"filename": iso}, {"filename": aniso})),
        ("principled small terrain", principled_terrain_dict(
            small_terrain_dict, mi.ScalarTransform4f, tmp, width=side)),
        ("bsplinecurve hair", hair_dict(
            mi, strands, side, HAIR_EUMELANIN, "bsplinecurve",
            tessellate=True, max_depth=4))]
    out = {}
    for tag, d in cases:
        with _accel("cells"):
            img_g = mi.render(mi.load_dict(d), seed=5, spp=4)
            img_c = mi.render(mi.load_dict(d, device="cpu"), seed=5, spp=4)
        out[tag] = _agree_images(f"{tag} ({side}x{side}, 4 spp)",
                                 img_g.cpu().numpy(), img_c.numpy())
    return out


def phase_materials(mi, card: str):
    """The slice's materials on the card (nothing falls back to the CPU):
    the hair ball through K1, principled terrain64k through K1, the
    materials Cornell, then the card against the CPU."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, part in (("hair", _mat_hair), ("terrain", _mat_terrain),
                           ("cornell", _mat_cornell),
                           ("agreement", lambda m, _, t: _mat_agreement(
                               m, t))):
            t0 = time.perf_counter()
            out[name] = part(mi, card, tmp)
            print(f"# materials {name}: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Shapes: analytic rows, instancing, SDF grids, merge and ellipsoidsmesh
# ---------------------------------------------------------------------------

SHAPES_COUNTS = (40, 12, 12)   # analytic spheres, cylinders, disks
SHAPES_CURVES = 5              # B-splines of 9 points: 80 cones each
SHAPES_TEX_SIDE = 256          # the textured sphere's bitmap, side^2
FIELD_TILES = 8                # prototype R: an 8 x 8 grid of instances
FIELD_SIDE = 129               # make_terrain(129): 32,768 faces
FIELD_SCATTER = 256            # prototype G (a cube and a sphere)
SDF_SIDE = 128                 # the blob's grid, side^3 (8 MiB)
CLOUD_SIZE = 2048              # ellipsoids: 80 faces each
SHAPES_CHECK_SIDE = 32         # card against CPU
FIELD_PRB_SIDE = 128           # the instanced field's PRB step (28 s at
#                                512, 14.5 s at 256)


def terrain_mesh(side: int, scale: float = 1.0, seed: int = 0):
    """make_terrain(side) as a mesh spec's (vertices, faces), scaled."""
    p0n, e1n, e2n = make_terrain(side, seed)
    v = np.concatenate([p0n, p0n + e1n, p0n + e2n], 0) * np.float32(scale)
    return v, np.arange(len(p0n) * 3).reshape(3, -1).T


def _ground_heights(d: dict, xy):
    """The height of the scene's terrain mesh under each (x, y): its
    nearest vertex's z."""
    v = np.asarray(d["terrain"]["vertices"])
    grid = v[np.unique(np.round(v[:, :2], 3), axis=0, return_index=True)[1]]
    k = np.argmin(((grid[None, :, :2] - xy[:, None]) ** 2).sum(-1), axis=1)
    return grid[k, 2]


def analytic_terrain_dict(make_dict, transform, counts=SHAPES_COUNTS,
                          n_curves: int = SHAPES_CURVES,
                          tex_side: int = SHAPES_TEX_SIDE, seed: int = 11,
                          **kw):
    """`make_dict(transform, **kw)` (terrain64k_dict or small_terrain_dict)
    with analytic shapes scattered on its terrain: `counts` spheres,
    cylinders and disks in diffuse, roughconductor and dielectric (the
    first sphere textured by a seeded bitmap) and `n_curves` B-spline
    cone sets above it, all made from `seed`."""
    d = make_dict(transform, **kw)
    rng = np.random.default_rng(seed)
    v = np.asarray(d["terrain"]["vertices"])
    half = 0.8 * float(np.abs(v[:, :2]).max())
    size = half / 12.0
    bsdfs = ({"type": "diffuse", "reflectance": {"type": "rgb",
                                                 "value": [0.7, 0.4, 0.3]}},
             {"type": "roughconductor", "alpha": 0.2},
             {"type": "dielectric"})
    n_total = sum(counts)
    xy = rng.uniform(-half, half, (n_total, 2))
    z = _ground_heights(d, xy)
    tex = rng.uniform(0.1, 0.9, (tex_side, tex_side, 3)).astype(np.float32)
    k = 0
    for kind, n in zip(("sphere", "cylinder", "disk"), counts):
        for i in range(n):
            r = size * rng.uniform(0.4, 1.0)
            c = [float(xy[k, 0]), float(xy[k, 1]), float(z[k]) + r]
            spec = {"type": kind, "bsdf": dict(bsdfs[k % 3])}
            if kind == "sphere":
                spec.update(center=c, radius=r)
                if i == 0:
                    spec["bsdf"] = {"type": "diffuse", "reflectance": {
                        "type": "bitmap", "data": tex, "mipmap": True}}
            elif kind == "cylinder":
                spec.update(radius=0.4 * r, p0=[c[0], c[1], c[2] - r],
                            p1=[c[0] + 0.3 * r, c[1], c[2] + 2 * r])
            else:
                spec["to_world"] = transform().translate(c).rotate(
                    [1, 0, 0], float(rng.uniform(-60, 60))).scale(r)
            d[f"{kind}_{i}"] = spec
            k += 1
    for i in range(n_curves):
        pts = np.cumsum(rng.normal(0, size, (9, 3)), axis=0)
        pts += [rng.uniform(-half, half), rng.uniform(-half, half),
                float(v[:, 2].max()) + size]
        radii = np.full((9, 1), 0.15 * size)
        d[f"curve_{i}"] = {"type": "bsplinecurve",
                           "control_points": np.concatenate(
                               [pts, radii], 1).tolist(),
                           "bsdf": dict(bsdfs[i % 2])}
    return d


def shapegroup_g(transform):
    """tests/test_instancing.py:28-41's shapegroup: a cube and a
    tessellated sphere, 3,980 faces."""
    return {"type": "shapegroup",
            "box": {"type": "cube", "to_world": transform().scale(0.25),
                    "bsdf": {"type": "diffuse", "reflectance": {
                        "type": "rgb", "value": [0.7, 0.3, 0.2]}}},
            "ball": {"type": "sphere", "to_world": transform().translate(
                [0, 0, 0.5]).scale(0.2),
                "bsdf": {"type": "diffuse", "reflectance": {
                    "type": "rgb", "value": [0.2, 0.5, 0.8]}}}}


def instanced_field_dict(transform, width: int = 512, spp: int = 4,
                         tiles: int = FIELD_TILES, side: int = FIELD_SIDE,
                         scatter: int = FIELD_SCATTER, seed: int = 7,
                         max_depth: int = 4):
    """An instanced field: prototype R, make_terrain(side) scaled into a
    unit tile, on a tiles x tiles grid of instances with a seeded
    z-rotation and a uniform scale of 0.6-1.4 (tests/test_instancing.py:
    45-54's transforms); prototype G (shapegroup_g) in `scatter`
    instances; a ground rectangle, a sun and a constant environment."""
    rng = np.random.default_rng(seed)
    v, f = terrain_mesh(side, 1.0 / 20.0)
    d = {"type": "scene",
         "integrator": {"type": "path", "max_depth": max_depth},
         "sensor": {"type": "perspective", "fov": 55.0,
                    "to_world": transform().look_at(
                        origin=[0, -9, 5], target=[0, 0, 0.3],
                        up=[0, 0, 1]),
                    "film": {"width": width, "height": width},
                    "sampler": {"type": "independent",
                                "sample_count": spp}},
         "ground": {"type": "rectangle", "to_world": transform().scale(6.0),
                    "bsdf": {"type": "diffuse"}},
         "proto_r": {"type": "shapegroup",
                     "tile": {"type": "mesh", "vertices": v, "faces": f,
                              "bsdf": {"type": "diffuse", "reflectance": {
                                  "type": "rgb", "value": [0.4, 0.6, 0.3]}}}},
         "proto_g": shapegroup_g(transform),
         **_lights()}
    step = 8.4 / tiles
    for i in range(tiles * tiles):
        x = -4.2 + step * (i % tiles + 0.5)
        y = -4.2 + step * (i // tiles + 0.5)
        d[f"tile_{i}"] = {"type": "instance", "to_world": transform()
                          .translate([x, y, 0.2])
                          .rotate([0, 0, 1], float(rng.uniform(0, 360)))
                          .scale(float(rng.uniform(0.6, 1.4))),
                          "ref": {"type": "ref", "id": "proto_r"}}
    for i in range(scatter):
        d[f"g_{i}"] = {"type": "instance", "to_world": transform()
                       .translate([float(rng.uniform(-4, 4)),
                                   float(rng.uniform(-4, 4)),
                                   float(rng.uniform(0.3, 1.5))])
                       .rotate([0, 0, 1], float(rng.uniform(0, 360)))
                       .scale(float(rng.uniform(0.6, 1.4))),
                       "ref": {"type": "ref", "id": "proto_g"}}
    return d


def sdf_blob_grid(side: int = SDF_SIDE, seed: int = 5) -> np.ndarray:
    """A seeded noisy sphere's signed distances on a side^3 grid of the
    unit cube (radius 0.3 about its center)."""
    ax = (np.arange(side) + 0.5) / side
    z, y, x = np.meshgrid(ax, ax, ax, indexing="ij")
    rng = np.random.default_rng(seed)
    bumps = sum(0.03 * np.sin(2 * np.pi * (k + 1) * (
        x * a + y * b + z * c) + ph) for k, (a, b, c, ph) in enumerate(
            rng.uniform(0, 1, (4, 4))))
    return (np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
            - 0.3 + bumps).astype(np.float32)


def sdf_terrain_dict(make_dict, transform, side: int = SDF_SIDE,
                     size: float = 8.0, **kw):
    """`make_dict(transform, **kw)` with sdf_blob_grid(side) on its
    terrain: the grid's unit cube scaled to `size` about the origin."""
    d = make_dict(transform, **kw)
    top = float(np.asarray(d["terrain"]["vertices"])[:, 2].max())
    d["blob"] = {"type": "sdfgrid", "grid": sdf_blob_grid(side),
                 "to_world": transform().translate(
                     [-size / 2, -size / 2, top - size / 2]).scale(size),
                 "bsdf": {"type": "diffuse", "reflectance": {
                     "type": "rgb", "value": [0.8, 0.3, 0.2]}}}
    return d


def ellipsoid_cloud_dict(transform, n: int = CLOUD_SIZE, width: int = 512,
                         spp: int = 4, seed: int = 9, max_depth: int = 4):
    """A merge of a ground rectangle and an ellipsoidsmesh of `n` seeded
    ellipsoids (80 faces each, its vertex-color BSDF by default) under a
    sun and a constant environment."""
    rng = np.random.default_rng(seed)
    return {
        "type": "scene",
        "integrator": {"type": "path", "max_depth": max_depth},
        "sensor": {"type": "perspective", "fov": 55.0,
                   "to_world": transform().look_at(
                       origin=[0, -9, 5], target=[0, 0, 1], up=[0, 0, 1]),
                   "film": {"width": width, "height": width},
                   "sampler": {"type": "independent", "sample_count": spp}},
        "cloud": {"type": "merge",
                  "ground": {"type": "rectangle",
                             "to_world": transform().scale(6.0),
                             "bsdf": {"type": "diffuse"}},
                  "shells": {"type": "ellipsoidsmesh",
                             "centers": np.stack([
                                 rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                                 rng.uniform(0.2, 3, n)], -1),
                             "scales": rng.uniform(0.03, 0.12, (n, 3)),
                             "quaternions": rng.normal(size=(n, 4)),
                             "colors": rng.uniform(0.1, 0.9, (n, 3))}},
        **_lights()}


def proto_first_round(scene, ray, proto: int = 0):
    """The first instance round of `ray` on the lanes whose candidate
    instance is of prototype `proto`: (their rays in prototype space, the
    query's maxt, the mask of those lanes over all of `ray`'s)."""
    import torch
    from mitsuba3_tpu_torch.render import instancing
    from mitsuba3_tpu_torch.render.records import Ray

    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    cap = torch.clamp(ray.maxt, max=instancing.BIG)
    tn, _, op, dp, pj = instancing._round_rays(
        scene.instances, ray.o, ray.d, instancing._guard_inv(ray.d), cap,
        torch.full((n,), -1.0, device=dev),
        torch.full((n,), -1, dtype=torch.int32, device=dev))
    mask = (tn < instancing.BIG) & (pj == proto)
    return Ray(o=op, d=dp, maxt=cap), mask


def _proto_rays(scene):
    """Prototype R's rays of the instanced field's first instance round
    over one full-width pass of primary rays (phase_kernels' rays)."""
    from mitsuba3_tpu_torch.core.struct import take_lanes
    ray, mask = proto_first_round(scene, _primary_rays(scene))
    return take_lanes(ray, mask.nonzero().squeeze(1), mask.shape[0])


class _BlockMeter:
    """Inside ``with``, the instance loop's rounds (``_round_rays`` calls)
    and queries are counted."""

    def __enter__(self):
        from mitsuba3_tpu_torch.render import instancing
        self.mod, self.rounds, self.queries = instancing, 0, 0
        self.saved = (instancing._round_rays, instancing.intersect_instances,
                      instancing.occluded_instances)
        real_round, real_closest, real_any = self.saved

        def round_rays(*args):
            self.rounds += 1
            return real_round(*args)

        def counted(real):
            def query(*args):
                self.queries += 1
                return real(*args)
            return query
        instancing._round_rays = round_rays
        instancing.intersect_instances = counted(real_closest)
        instancing.occluded_instances = counted(real_any)
        return self

    def __exit__(self, *exc):
        (self.mod._round_rays, self.mod.intersect_instances,
         self.mod.occluded_instances) = self.saved


def _block_peak(fn):
    """(peak bytes above the allocation at entry, result) of fn()."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, out


def _shapes_render(mi, card: str, tag: str, d: dict, prb_side=None,
                   profiled: bool = True):
    """`d` loaded on the card and rendered at its film size, 4 spp: a
    warm-up at 1 spp, a timed render with K1 launches counted from zero
    and its device ms and bound by CUDA events (_K1Meter), the instance
    loop's rounds per query, the peak memory and the peak working set of
    one full-width primary query of the analytic rows and of the
    instances, then, if `profiled`, a profiled render; with `prb_side`, a
    PRB step of bsdf_params at prb_side^2 (no warm-up of its own).
    Returns its numbers."""
    import torch
    from mitsuba3_tpu_torch.ops import analytic, cellserve

    t0 = time.perf_counter()
    scene = mi.load_dict(d)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    w = d["sensor"]["film"]["width"]
    mi.render_with_stats(scene, seed=0, spp=1, max_wavefront=1 << 20)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in cellserve.LAUNCHES:
        cellserve.LAUNCHES[k] = 0
    with _K1Meter() as meter, _BlockMeter() as blocks:
        t0 = time.perf_counter()
        img, rays = mi.render_with_stats(scene, seed=1, spp=4,
                                         max_wavefront=1 << 20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(cellserve.LAUNCHES)
    k1 = meter.summary()
    _check(all(v > 0 for v in launches.values()),
           f"{tag}: K1 not launched in both modes: {launches}")
    _check(all(k1[m]["launches"] == launches[m] for m in launches),
           f"{tag}: K1 meter {k1} disagrees with {launches}")
    _check(tuple(img.shape) == (w, w, 3) and bool(torch.isfinite(img).all())
           and float(img.mean()) > 0,
           f"{tag}: image misshaped, not finite or black")
    ray = _primary_rays(scene)
    an_peak = in_peak = 0
    if scene.analytic_prims is not None:
        an_peak = _block_peak(lambda: analytic.intersect_analytic(
            scene.analytic_prims, ray.o, ray.d, ray.maxt))[0]
    if scene.instances is not None:
        from mitsuba3_tpu_torch.render import instancing
        in_peak = _block_peak(lambda: instancing.intersect_instances(
            scene, ray.o, ray.d, ray.maxt,
            torch.ones_like(ray.maxt, dtype=torch.bool)))[0]
    mrays = rays / wall / 1e6
    out = {"rays": rays, "wall_s": wall, "mrays_per_s": mrays,
           "peak_bytes": peak, "analytic_query_peak_bytes": an_peak,
           "instance_query_peak_bytes": in_peak, "load_dict_s": load_s,
           "mean": float(img.mean()), "k1": k1, "k1_launches": launches,
           "faces": int(scene.faces.shape[0]),
           "analytic_rows": scene.n_analytic}
    print(f"# shapes {tag} {w}x{w} 4spp: {rays} rays in {wall:.3f} s = "
          f"{mrays:.3f} Mrays/s, peak memory {peak / 2**30:.2f} GiB (one "
          f"primary query: analytic rows {an_peak / 2**30:.3f} GiB, "
          f"instances {in_peak / 2**30:.3f} GiB), load_dict {load_s:.2f} "
          f"s, {out['faces']} stored faces, A = {scene.n_analytic} analytic "
          f"rows, mean {out['mean']:.6f} [{card}]")
    if blocks.queries:
        out["instance_rounds_per_query"] = blocks.rounds / blocks.queries
        out["instance_queries"] = blocks.queries
        print(f"# shapes {tag}: the instance loop ran {blocks.rounds} rounds "
              f"for {blocks.queries} queries = "
              f"{out['instance_rounds_per_query']:.2f} a query")
    for mode, v in k1.items():
        print(f"# shapes {tag} K1 {mode}: {v['launches']} launches for "
              f"{v['queries']} queries, {v['device_ms']:.2f} device ms, "
              f"bound {v['bound_ms']:.3f} ms [{card}]")
    if profiled:
        out.update(_profile(lambda: mi.render_with_stats(
            scene, seed=2, spp=4, max_wavefront=1 << 20), wall,
            _accel_kernels("cells")[1]))
    del scene, img
    torch.cuda.empty_cache()
    if prb_side:
        d = _prb_dict(d)
        d["sensor"] = dict(d["sensor"], film=dict(
            d["sensor"]["film"], width=prb_side, height=prb_side))
        scene = mi.load_dict(d)
        names = ("bsdf_params",)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, rays, grads, n_passes = _grad_step(scene, names, 1,
                                                 TERRAIN_PRB_SPP)
        torch.cuda.synchronize()
        step = time.perf_counter() - t0
        _check_grads(f"{tag} prb", grads, names)
        print(f"# shapes {tag} fwd+PRB bwd {prb_side}x{prb_side} "
              f"{TERRAIN_PRB_SPP}spp: {rays} forward rays, step {step:.3f} "
              f"s in {n_passes} passes [{card}]")
        out["prb"] = {"side": prb_side, "forward_rays": rays,
                      "wall_s": step, "passes": n_passes, "loss": loss}
        del scene, grads
        torch.cuda.empty_cache()
    return out


def _sdf_grid_grad(mi, card: str, side: int = 128):
    """d mean(image) / d(the SDF grid) of the blob on terrain64k at
    side^2, 4 spp, through a plain autograd path render: finite and
    nonzero (tests/test_analytic.py:217)."""
    import torch
    d = sdf_terrain_dict(terrain64k_dict, mi.ScalarTransform4f)
    d["sensor"]["film"].update(width=side, height=side)
    scene = mi.load_dict(d)
    grid = scene.sdf_grids[0].detach().clone().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = mi.render(scene.replace(sdf_grids=(grid,)), seed=3,
                     spp=4).mean()
    (g,) = torch.autograd.grad(loss, [grid])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check(bool(torch.isfinite(g).all()) and bool((g != 0).any()),
           "sdf blob: the grid gradient is not finite or all zero")
    print(f"# shapes sdf blob grid gradient {side}x{side} 4spp: {wall:.3f} "
          f"s, {int((g != 0).sum())} nonzero of {g.numel()} entries, |g| "
          f"max {float(g.abs().max()):.4g} [{card}]")
    return {"side": side, "wall_s": wall, "nonzero": int((g != 0).sum()),
            "max_abs": float(g.abs().max())}


def _cone_rows_agreement(mi, d: dict):
    """The analytic rows of `d` (its round cones among them) queried on the
    card and on the CPU with the same rays (one pass of its camera, made
    on the CPU): row ids and hits equal, t within rtol 1e-6, uv within
    1e-6. Returns the largest t difference."""
    import torch
    from mitsuba3_tpu_torch.core.vec import Vec3
    from mitsuba3_tpu_torch.ops import analytic
    from mitsuba3_tpu_torch.render import integrator as ri
    scene = mi.load_dict(d, device="cpu")
    sppc, _ = ri.plan_passes(scene, 4, 1 << 20)
    ray = ri._gen_camera_rays(scene, ri.pass_seed(5, 0), sppc, 0, 4)[1]
    out = {}
    for dev in ("cpu", "cuda"):
        def on(v):
            return Vec3(v.x.to(dev), v.y.to(dev), v.z.to(dev))
        t, aidx, uv, valid = analytic.intersect_analytic(
            scene.analytic_prims.to(dev), on(ray.o), on(ray.d),
            ray.maxt.to(dev))
        out[dev] = [x.cpu() for x in (t, aidx, uv.x, uv.y, valid)]
    (tc, ic, uc, vc, okc), (tg, ig, ug, vg, okg) = out["cpu"], out["cuda"]
    dt = float((tg - tc)[okc].abs().max()) if bool(okc.any()) else 0.0
    _check(torch.equal(ic, ig) and torch.equal(okc, okg)
           and bool(torch.allclose(tg[okc], tc[okc], rtol=1e-6))
           and bool(torch.allclose(ug[okc], uc[okc], atol=1e-6))
           and bool(torch.allclose(vg[okc], vc[okc], atol=1e-6)),
           "analytic rows: the card's query differs from the CPU's on the "
           "same rays")
    print(f"# agreement analytic rows ({scene.n_analytic}, the round cones "
          f"among them) on the same {ray.o.x.shape[0]} rays: {int(okc.sum())} "
          f"hits, ids equal, largest t difference {dt:.3g}")
    return dt


def _to_device(obj, dev):
    """`obj` (a tensor, a tuple or a record of them) with every tensor on
    `dev`."""
    import dataclasses
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple):
        return tuple(_to_device(x, dev) for x in obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), dev)
            for f in dataclasses.fields(obj)})
    return obj


@contextlib.contextmanager
def _cpu_camera_rays(scene_c):
    """Inside, a render of a card scene starts each pass from the camera
    rays and sampler states that the CPU scene `scene_c` (its twin) makes,
    moved to the card; a CPU render is unchanged."""
    from mitsuba3_tpu_torch.render import integrator as ri
    plain = ri._gen_camera_rays

    def from_cpu(scene, *args, **kw):
        if scene.device.type == "cpu":
            return plain(scene, *args, **kw)
        return _to_device(plain(scene_c, *args, **kw), scene.device)
    ri._gen_camera_rays = from_cpu
    try:
        yield
    finally:
        ri._gen_camera_rays = plain


def _shapes_agreement(mi):
    """Card against CPU at SHAPES_CHECK_SIDE^2 (4 spp, max_depth 2, seed 5)
    on the four scenes cut to CPU size, each held by _agree_images: the
    analytic shapes and the SDF blob on the small terrain (8,978 faces),
    the instanced field with 4 tiles of make_terrain(66) (its own
    cellserve) and 6 of prototype G, a cloud of 128 ellipsoids. The
    analytic terrain is rendered twice: with its round cones on the
    CPU's camera rays (a cone's grazing hits move by ~1e-4 for an ulp of
    the ray, and the card's camera rays are an ulp off the CPU's on ~40 %
    of lanes, tests/test_torch_shapes.py::
    test_round_cones_part_on_ulps_of_the_rays), so the bounce rays, the
    surface fields and the BSDFs of cone lanes are the card's own; and
    without its cones on the card's camera rays. The cone rows are also
    held by their query on the same rays (_cone_rows_agreement)."""
    T, side = mi.ScalarTransform4f, SHAPES_CHECK_SIDE
    full = analytic_terrain_dict(small_terrain_dict, T)
    cases = [
        ("analytic small terrain with cones, the CPU's camera rays", full,
         True),
        ("analytic small terrain, no cones", analytic_terrain_dict(
            small_terrain_dict, T, n_curves=0), False),
        ("instanced field", instanced_field_dict(T, tiles=2, side=66,
                                                 scatter=6), False),
        ("sdf blob", sdf_terrain_dict(small_terrain_dict, T, side=32,
                                      size=2.0), False),
        ("ellipsoid cloud", ellipsoid_cloud_dict(T, n=128), False)]
    for _, d, _ in cases:
        d["sensor"]["film"].update(width=side, height=side)
        d["integrator"] = dict(d["integrator"], max_depth=2)
    with _accel("cells"):
        out = {"cone rows, same rays": {
            "max_abs_dt": _cone_rows_agreement(mi, full)}}
        for tag, d, same_rays in cases:
            scene_c = mi.load_dict(d, device="cpu")
            with (_cpu_camera_rays(scene_c) if same_rays
                  else contextlib.nullcontext()):
                img_g = mi.render(mi.load_dict(d), seed=5, spp=4)
            img_c = mi.render(scene_c, seed=5, spp=4)
            g, c = img_g.cpu().numpy(), img_c.numpy()
            out[tag] = {"close": _agree_images(
                f"{tag} ({side}x{side}, 4 spp)", g, c),
                "max_abs_diff": float(np.abs(g - c).max())}
            print(f"# agreement {tag}: largest difference "
                  f"{out[tag]['max_abs_diff']:.3g}")
    return out


def phase_shapes(mi, card: str):
    """Implicit geometry on the card (nothing falls back to the CPU):
    terrain64k under 64 analytic shapes and 400 round cones (path and its
    PRB step, K1 in both modes), the instanced field (prototype R through
    its own cellserve, prototype G dense; path, and its PRB step at
    FIELD_PRB_SIDE^2), the SDF
    blob on terrain64k (path; the grid gradient at 128^2 by plain
    autograd), the ellipsoid cloud (a merge with 163,840 shell faces
    through K1), then the card against the CPU."""
    T = mi.ScalarTransform4f
    out = {}
    parts = (
        ("analytic terrain64k", lambda: _shapes_render(
            mi, card, "analytic terrain64k",
            analytic_terrain_dict(terrain64k_dict, T), prb_side=512)),
        # not profiled (456,909 launches, ~24 s under the profiler): the
        # script keeps to its time limit
        ("instanced field", lambda: _shapes_render(
            mi, card, "instanced field", instanced_field_dict(T),
            prb_side=FIELD_PRB_SIDE, profiled=False)),
        ("sdf blob", lambda: _shapes_render(
            mi, card, "sdf blob", sdf_terrain_dict(terrain64k_dict, T))),
        ("sdf grid gradient", lambda: _sdf_grid_grad(mi, card)),
        ("ellipsoid cloud", lambda: _shapes_render(
            mi, card, "ellipsoid cloud", ellipsoid_cloud_dict(T))),
        ("agreement", lambda: _shapes_agreement(mi)))
    for name, part in parts:
        t0 = time.perf_counter()
        out[name] = part()
        print(f"# shapes {name}: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Spectra in an RGB scene and the other accels (bvh_xla, the DDA grid,
# HybridAccel, the dense test above 8192 faces), with update() rebuilds
# ---------------------------------------------------------------------------

SPECTRAL_LIGHT = {"type": "blackbody", "temperature": 6500.0, "scale": 4e-4}
SPECTRAL_RED = {"type": "regular", "lambda_min": 400.0, "lambda_max": 700.0,
                "values": [0.05, 0.05, 0.06, 0.1, 0.45, 0.6, 0.6]}
# an irregular spectrum as an XML <spectrum value="..."> gives it
SPECTRAL_GREEN = ("400:0.05, 450:0.1, 500:0.35, 550:0.45, 600:0.15, "
                  "650:0.08, 700:0.05")
SPECTRAL_SPP = 16            # the spectral Cornell's path render, 512^2
ACCELS_CHECK_SIDE = 32       # card against CPU
NONE_SIDE = 128              # the dense test over terrain64k's faces
UPDATE_SIDE = 32             # the renders after update()'s rebuilds
NEW_ACCELS = ("xla", "grid", "hybrid")


def spectral_cornell_dict(mi, width: int, height: int, max_depth: int = 8):
    """``mi.cornell_box`` with its light's radiance a 6500 K blackbody, the
    red wall a regular and the green wall an irregular reflectance."""
    d = mi.cornell_box(width, height, max_depth=max_depth)
    d["light"]["emitter"]["radiance"] = dict(SPECTRAL_LIGHT)
    d["red"]["reflectance"] = dict(SPECTRAL_RED)
    d["green"]["reflectance"] = {"type": "irregular", "value": SPECTRAL_GREEN}
    return d


# the spectral variant normalizes a blackbody's SPD to a peak of 1 (the
# RGB projection keeps Planck's radiance): this scale gives the light about
# the RGB box's luminance
SPECTRAL_VARIANT_LIGHT = {"type": "blackbody", "temperature": 6500.0,
                          "scale": 14.0}
SPECTRAL_FLOOR = {"type": "uniform", "value": 0.6}
DISPERSIVE_GLASS = {"type": "dielectric", "int_ior": 1.5168,
                    "dispersion": 0.00420}     # BK7's Cauchy B [um^2]
SPECFILM_SRFS = {
    "c_blue": {"type": "regular", "lambda_min": 400.0, "lambda_max": 520.0,
               "values": [0.2, 1.0, 0.4, 0.0]},
    "c_flat": {"type": "uniform", "value": 0.5},
    "c_red": {"type": "irregular", "value": "560:0.0, 620:1.0, 700:0.3"},
    "c_warm": {"type": "blackbody", "temperature": 3000.0}}


# on the floor (0), the glass box's bottom face and the floor coincide:
# which of the two a ray inside the box hits is an ulp of the ray, and the
# card's camera rays are an ulp off the CPU's on ~40 % of lanes
# (tests/test_torch_coincident_faces.py)
GLASS_LIFT = 1e-3


def spectral_variant_cornell_dict(mi, width: int, height: int,
                                  max_depth: int = 8, extra=None,
                                  glass_lift: float = GLASS_LIFT):
    """The spectral Cornell for the spectral variant: spectral_cornell_dict
    with its light a 6500 K blackbody of SPECTRAL_VARIANT_LIGHT's scale and
    the floor a uniform reflectance. `extra`: "glass" makes the small box a
    dispersive dielectric (DISPERSIVE_GLASS) standing `glass_lift` above
    the floor, "specfilm" gives the sensor a specfilm of the four response
    functions SPECFILM_SRFS."""
    d = spectral_cornell_dict(mi, width, height, max_depth)
    d["light"]["emitter"]["radiance"] = dict(SPECTRAL_VARIANT_LIGHT)
    d["floor"]["bsdf"] = {"type": "diffuse",
                          "reflectance": dict(SPECTRAL_FLOOR)}
    if extra == "glass":
        d["small-box"]["bsdf"] = dict(DISPERSIVE_GLASS)
        d["small-box"]["to_world"] = mi.ScalarTransform4f().translate(
            [0.0, glass_lift, 0.0]) @ d["small-box"]["to_world"]
    elif extra == "specfilm":
        d["sensor"]["film"] = {**d["sensor"]["film"], "type": "specfilm",
                               **SPECFILM_SRFS}
    return d


def spectral_cornell_xml(width: int, height: int, max_depth: int = 8,
                         spp: int = 16) -> str:
    """The Cornell box as XML source for ``load_string``: rectangle walls,
    the green wall's reflectance a ``<spectrum value="wavelength:value,
    ...">``, the red one a ``<spectrum>`` of one value."""
    walls = {"floor": ('<rotate x="1" angle="-90"/>', "0, -1, 0", "white"),
             "ceiling": ('<rotate x="1" angle="90"/>', "0, 1, 0", "white"),
             "back": ("", "0, 0, -1", "white"),
             "green-wall": ('<rotate y="1" angle="-90"/>', "1, 0, 0",
                            "green"),
             "red-wall": ('<rotate y="1" angle="90"/>', "-1, 0, 0", "red")}
    shapes = "\n".join(
        f'  <shape type="rectangle" id="{k}"><transform name="to_world">'
        f'{rot}<translate value="{tr}"/></transform><ref id="{b}"/>'
        f'</shape>' for k, (rot, tr, b) in walls.items())
    return f"""<scene version="3.0.0">
  <integrator type="path"><integer name="max_depth" value="{max_depth}"/>
  </integrator>
{_sensor_xml("perspective", width, height, "independent", "gaussian",
             None).replace("$spp", str(spp))}
  <bsdf type="diffuse" id="white"><rgb name="reflectance"
    value="0.885809, 0.698859, 0.666422"/></bsdf>
  <bsdf type="diffuse" id="green"><spectrum name="reflectance"
    value="{SPECTRAL_GREEN}"/></bsdf>
  <bsdf type="diffuse" id="red"><spectrum name="reflectance" value="0.4"/>
  </bsdf>
  <shape type="rectangle" id="light">
    <transform name="to_world"><scale value="0.23, 0.19, 0.19"/>
      <rotate x="1" angle="90"/><translate value="0, 0.99, 0.01"/>
    </transform>
    <ref id="white"/>
    <emitter type="area"><rgb name="radiance"
      value="18.387, 13.9873, 6.75357"/></emitter>
  </shape>
{shapes}
  <shape type="cube" id="small-box">
    <transform name="to_world"><scale value="0.3"/>
      <rotate y="1" angle="-17"/><translate value="0.335, -0.7, 0.38"/>
    </transform>
    <ref id="white"/>
  </shape>
</scene>
"""


def _steps_per_query():
    """Per new accel module, mode: (steps, queries, steps a query) since
    the counters' reset."""
    from mitsuba3_tpu_torch.ops import bvh_xla
    from mitsuba3_tpu_torch.ops import grid as grid_mod
    return {name: {m: [mod.STEPS[m], mod.QUERIES[m],
                       mod.STEPS[m] / max(mod.QUERIES[m], 1)]
                   for m in mod.STEPS}
            for name, mod in (("xla", bvh_xla), ("grid", grid_mod))}


def _reset_accel_counters():
    from mitsuba3_tpu_torch.ops import bvh_tiled, bvh_xla
    from mitsuba3_tpu_torch.ops import grid as grid_mod
    for counts in (bvh_xla.STEPS, bvh_xla.QUERIES, grid_mod.STEPS,
                   grid_mod.QUERIES, bvh_tiled.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _load_accel(mi, d: dict, kind: str, device=None):
    """(scene, build s): `d` loaded with MI3T_ACCEL=kind; for "hybrid"
    loaded under "grid" and given a HybridAccel of that grid (closest)
    and a bvh_tiled over the same faces (any-hit), as JAX's update()
    makes one."""
    import torch
    from mitsuba3_tpu_torch.ops import bvh_tiled
    from mitsuba3_tpu_torch.render.scene import HybridAccel
    t0 = time.perf_counter()
    with _accel("grid" if kind == "hybrid" else kind):
        scene = mi.load_dict(d, device=device)
    if kind == "hybrid":
        p0, e1, e2 = (v.to_array().cpu().numpy()
                      for v in scene.triangle_soa())
        scene = scene.replace(accel=HybridAccel(
            closest=scene.accel, anyhit=bvh_tiled.build(
                p0, e1, e2, device=scene.device)))
    if scene.device.type == "cuda":
        torch.cuda.synchronize()
    return scene, time.perf_counter() - t0


def _accel_render(mi, card: str, tag: str, scene, build_s: float, spp: int,
                  ref=None, profile_labels=None):
    """One timed render of `scene` (seed 1) after counters' reset: rays,
    wall, Mrays/s, peak, steps a query, K4 launches, the image held
    against `ref`, (its accel's name, its image of the same seed): mean
    within 1 %, the close share printed; with `profile_labels`, a profiled
    render (seed 2) for launches and device ms. Returns (numbers,
    image)."""
    import torch
    from mitsuba3_tpu_torch.ops import bvh_tiled
    _reset_accel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img, rays = mi.render_with_stats(scene, seed=1, spp=spp,
                                     max_wavefront=1 << 20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = _steps_per_query()
    launched = dict(bvh_tiled.LAUNCHES)
    meter = _K4Meter()
    if any(launched.values()):
        # the same render again, metered: the bound of the timed one's
        # launches
        with meter:
            mi.render_with_stats(scene, seed=1, spp=spp,
                                 max_wavefront=1 << 20)
    _check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
           f"{tag}: image not finite or black")
    out = {"rays": rays, "wall_s": wall, "mrays_per_s": rays / wall / 1e6,
           "build_s": build_s, "peak_bytes": peak,
           "mean": float(img.mean()), "steps": steps,
           "k4_launches": launched, "k4": meter.summary()}
    line = (f"# accels {tag}: {rays} rays in {wall:.3f} s = "
            f"{rays / wall / 1e6:.3f} Mrays/s, build {build_s:.2f} s, peak "
            f"{peak / 2**30:.2f} GiB, mean {float(img.mean()):.6f}, steps a "
            f"query " + (", ".join(
                f"{k} {m} {v[2]:.1f} ({v[1]} queries)"
                for k, modes in steps.items() for m, v in modes.items()
                if v[1]) or "none (no traversal loop)"))
    if ref is not None:
        ref_name, ref_img = ref
        a, b = img.cpu().numpy(), ref_img.cpu().numpy()
        close = float(np.isclose(a, b, rtol=1e-3, atol=1e-3).mean())
        rel = abs(float(a.mean()) / float(b.mean()) - 1.0)
        out.update(ref=ref_name, close_to_ref=close, mean_rel_to_ref=rel)
        line += (f"; vs {ref_name}: mean {float(b.mean()):.6f} (rel "
                 f"{rel:.2e}), {close:.5f} of values close")
        _check(rel <= 0.01, f"{tag}: image mean {a.mean()} is not within "
               f"1 % of the {ref_name} render's {b.mean()}")
    print(line + f" [{card}]")
    if profile_labels is not None:
        out.update(_profile(lambda: mi.render_with_stats(
            scene, seed=2, spp=spp, max_wavefront=1 << 20), wall,
            profile_labels))
    return out, img


def _accels_terrain(mi, card: str, scenes: dict):
    """terrain64k (bench.py's 512^2, 4 spp) through xla, grid and the
    hybrid, each held against cellserve's image of the same seed, the
    grid's and the hybrid's renders profiled; the hybrid's any-hit must
    launch K4 (and its closest side never). The scenes stay in `scenes`
    for the rebuilds. Then the dense test over every face
    (MI3T_ACCEL=none) at NONE_SIDE^2 against cellserve's."""
    import torch
    d = terrain64k_dict(mi.ScalarTransform4f)
    cells, _ = _load_accel(mi, d, "cells")
    ref = ("cellserve", mi.render_with_stats(cells, seed=1, spp=4,
                                             max_wavefront=1 << 20)[0])
    out = {}
    k4 = _accel_kernels("tiled")[1]
    for kind in NEW_ACCELS:
        scene, build_s = _load_accel(mi, d, kind)
        if kind == "xla":       # the first: warms the render's code up
            mi.render(_at_side(scene, 64), seed=0, spp=1)
        # bvh_xla's render is not profiled: its ~535,000 launches take
        # the profiler ~37 s (PERF.md)
        out[kind], _ = _accel_render(
            mi, card, f"terrain64k 512x512 4spp {kind}", scene, build_s, 4,
            ref, None if kind == "xla" else k4 if kind == "hybrid" else {})
        if kind == "hybrid":
            n = out[kind]["k4_launches"]
            prof = out[kind]["profiled_kernels"]
            _check(n["anyhit"] > 0 and n["closest"] == 0,
                   f"hybrid: K4 launches {n}: any-hit only expected")
            _check(prof["K4 any-hit"]["launches"] > 0
                   and prof["K4 any-hit"]["device_ms"] > 0,
                   f"hybrid: the profiled render saw no K4 any-hit: {prof}")
            k4m = out[kind]["k4"]["anyhit"]
            _check(k4m["launches"] == n["anyhit"],
                   f"hybrid: K4 meter {k4m} disagrees with {n}")
            print(f"# accels hybrid K4 any-hit: {n['anyhit']} launches, "
                  f"{prof['K4 any-hit']['device_ms']:.2f} device ms in a "
                  f"profiled render, bound {k4m['bound_ms']:.4f} ms summed "
                  f"over the timed render's launches ({k4m['tests']} "
                  f"ray-triangle tests by K4's cull, counted in a rerun) "
                  f"[{card}]")
        scenes[kind] = scene
    side = NONE_SIDE
    small = dict(d, sensor=dict(d["sensor"], film={"width": side,
                                                    "height": side}))
    ref = ("cellserve", mi.render_with_stats(_at_side(cells, side), seed=1,
                                             spp=4)[0])
    scene, build_s = _load_accel(mi, small, "none")
    _check(scene.accel is None, "MI3T_ACCEL=none built an accel")
    out["none"], _ = _accel_render(
        mi, card, f"terrain64k {side}x{side} 4spp none (dense, "
        f"{scene.faces.shape[0]} faces)", scene, build_s, 4, ref)
    del cells, scene
    torch.cuda.empty_cache()
    return out


def _accels_interior(mi, card: str):
    """interior120k (bench.py's 256^2, 4 spp) through xla and grid, each
    image's mean held within 1 % of the other's."""
    import torch
    d = interior_dict(mi.ScalarTransform4f)
    out, ref = {}, None
    for kind in ("xla", "grid"):
        scene, build_s = _load_accel(mi, d, kind)
        out[kind], img = _accel_render(
            mi, card, f"interior120k 256x256 4spp {kind}", scene, build_s, 4,
            ref)
        ref = (kind, img) if ref is None else ref
        del scene
        torch.cuda.empty_cache()
    return out


def _accels_agreement(mi):
    """The small terrain (8,978 faces) on the card and on the CPU through
    each new accel and the dense test, as phase_agreement holds them."""
    out = {}
    for kind in NEW_ACCELS + ("none",):
        d = small_terrain_dict(mi.ScalarTransform4f)
        img_g = mi.render(_load_accel(mi, d, kind)[0], seed=5, spp=4)
        img_c = mi.render(_load_accel(mi, d, kind, "cpu")[0], seed=5, spp=4)
        out[kind] = _agree_images(f"MI3T_ACCEL={kind} small terrain "
                                  f"(24x24, 4 spp)", img_g.cpu().numpy(),
                                  img_c.numpy())
    return out


def _accels_update(mi, card: str, scenes: dict):
    """update() after a vertex edit of terrain64k (_bump) under each new
    accel: the rebuild's seconds, the accel's type unchanged, and a
    render of the rebuilt scene (UPDATE_SIDE^2, 1 spp) finite."""
    import torch
    from mitsuba3_tpu_torch.ops import bvh_tiled
    from mitsuba3_tpu_torch.ops import grid as grid_mod
    out = {}
    for kind in NEW_ACCELS:
        scene = scenes.pop(kind)
        params = mi.traverse(scene)
        params["vertices"] = torch.as_tensor(
            _bump(scene.vertices.cpu().numpy()), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = params.update()
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        _check(type(new.accel) is type(scene.accel),
               f"update() under {kind}: {type(new.accel).__name__}")
        if kind == "hybrid":
            _check(isinstance(new.accel.closest, grid_mod.GridAccel)
                   and isinstance(new.accel.anyhit, bvh_tiled.BVHTiled),
                   "update(): the hybrid's sides changed type")
        small = _at_side(new, UPDATE_SIDE)
        img = mi.render(small, seed=3, spp=1)
        _check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
               f"update() under {kind}: render not finite or black")
        print(f"# accels update() terrain64k {kind}: rebuild "
              f"{rebuild_s:.3f} s, {type(new.accel).__name__}, render "
              f"{UPDATE_SIDE}x{UPDATE_SIDE} mean {float(img.mean()):.6f} "
              f"[{card}]")
        out[kind] = {"rebuild_s": rebuild_s, "mean": float(img.mean())}
        del scene, new, small
        torch.cuda.empty_cache()
    return out


def _at_side(scene, side: int):
    """`scene` (square, uncropped) with its film resized to side^2: the
    sensor keeps its field of view."""
    import dataclasses
    return scene.replace(film=dataclasses.replace(
        scene.film, width=side, height=side, full_width=side,
        full_height=side))


SPECTRAL_CHECK_SIDE = 32      # card against CPU
SPECTRAL_LOADER_SIDE = 128    # the ray loader's reference image
SPECTRAL_LOADER_BATCH = 16384
SPECTRAL_LOADER_STEPS = 4


def _spectral_terrain(mi, card: str):
    """terrain64k (bench.py's 512^2, 4 spp, path max_depth 4) in the
    spectral variant through cellserve: a warm-up, one timed render with
    K1's launches counted from zero and timed by CUDA events (_K1Meter),
    the largest launch of each mode kept for the K1 rows; its luminance
    against the RGB render's of the same seed. Returns (numbers, K1
    launches, K1 rows)."""
    import torch
    from mitsuba3_tpu_torch.core import spectrum
    from mitsuba3_tpu_torch.ops import cellserve as cs

    d = terrain64k_dict(mi.ScalarTransform4f)
    with _accel("cells"):
        scene = mi.load_dict(d, spectral=True)
        rgb = mi.load_dict(d)
    _check(scene.spectral and isinstance(scene.accel, cs.CellServe),
           "spectral terrain64k: not spectral or not cellserve")
    mi.render_with_stats(scene, seed=0, spp=4, max_wavefront=1 << 20)
    torch.cuda.synchronize()
    for k in cs.LAUNCHES:
        cs.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    with _K1Meter(keep_largest=True) as meter:
        t0 = time.perf_counter()
        img, rays = mi.render_with_stats(scene, seed=1, spp=4,
                                         max_wavefront=1 << 20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(cs.LAUNCHES)
    k1 = meter.summary()
    peak = torch.cuda.max_memory_allocated()
    _check(launches["closest"] > 0 and launches["anyhit"] > 0,
           f"spectral terrain64k: K1 not launched in both modes: {launches}")
    _check(all(k1[m]["launches"] == launches[m] for m in launches),
           f"spectral terrain64k: K1 meter {k1} disagrees with {launches}")
    _check(tuple(img.shape) == (512, 512, 3)
           and bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
           "spectral terrain64k: image misshaped, not finite or black")
    img_rgb = mi.render(rgb, seed=1, spp=4, max_wavefront=1 << 20)
    lum = float(spectrum.luminance(img).mean())
    lum_rgb = float(spectrum.luminance(img_rgb).mean())
    mrays = rays / wall / 1e6
    print(f"# spectral terrain64k 512x512 4spp path, cellserve: {rays} rays "
          f"in {wall:.3f} s = {mrays:.3f} Mrays/s, peak "
          f"{peak / 2**30:.2f} GiB, luminance {lum:.6f} against the RGB "
          f"render's {lum_rgb:.6f} ({lum / lum_rgb - 1:+.4f}) [{card}]")
    for mode, v in k1.items():
        print(f"# spectral terrain64k K1 {mode}: {v['launches']} launches, "
              f"{v['device_ms']:.2f} device ms, bound {v['bound_ms']:.3f} ms"
              f" summed over them [{card}]")
    out = {"scene": "terrain64k 512x512 4spp, path max_depth 4, spectral, "
                    "cellserve", "rays": rays, "wall_s": wall,
           "mrays_per_s": mrays, "peak_bytes": peak, "luminance": lum,
           "luminance_rgb": lum_rgb, "k1": k1, "k1_launches": launches}
    del scene, rgb, img, img_rgb
    rows = [_k1_row(card, ".spectral", mode, *meter.largest[mode],
                    accel="cells.spectral") for mode in ("closest", "anyhit")]
    del meter
    torch.cuda.empty_cache()
    return out, launches, rows


def _spectral_cornell(mi, card: str):
    """spectral_variant_cornell_dict at 512^2, max_depth 8 in the spectral
    variant: a prb grad_step at SPECTRAL_SPP spp after a one-pass warm-up
    (Mrays/s x (1 + bwd_ratio); gradients finite, the white walls' row
    nonzero), its primal against the path render at 128^2 (equal); then
    the dispersive glass box and the 4-channel specfilm, path, 512^2,
    SPECTRAL_SPP spp each."""
    import torch
    from mitsuba3_tpu_torch.integrators import config_from_dict
    from mitsuba3_tpu_torch.render import integrator as ri

    names = ("bsdf_params", "em_radiance", "textures", "env_data")
    scene = mi.load_dict(_prb_dict(spectral_variant_cornell_dict(
        mi, 512, 512, 8)), spectral=True)
    n_fwd, n_bwd = _bwd_ratio(scene)
    _check(n_fwd == n_bwd, f"spectral replay issued {n_bwd} rays, primal "
           f"{n_fwd}")
    bwd_ratio = n_bwd / max(n_fwd, 1)
    _grad_step(scene, names, 0, SPECTRAL_SPP, passes=1)     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, rays, grads, n_passes = _grad_step(scene, names, 1, SPECTRAL_SPP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_grads("spectral cornell prb", grads, ())
    # slot 0 is "white" (RGB); the sampled walls' rows hold only their
    # projection, which the spectral variant does not read
    g_white = grads["bsdf_params"][0, :3]
    _check(bool((g_white != 0).all()), f"spectral cornell prb: the white "
           f"walls' gradient has a zero: {g_white.tolist()}")
    mrays = (1.0 + bwd_ratio) * rays / wall / 1e6
    print(f"# spectral cornell fwd+PRB bwd 512x512 {SPECTRAL_SPP}spp: {rays} "
          f"forward rays, bwd_ratio {bwd_ratio:.6f}, step {wall:.3f} s in "
          f"{n_passes} passes = {mrays:.3f} Mrays/s, loss {loss:.6g} "
          f"[{card}]")
    out = {"prb": {"forward_rays": rays, "bwd_ratio": bwd_ratio,
                   "wall_s": wall, "passes": n_passes,
                   "mrays_per_s": mrays, "loss": loss}}
    small = _at_side(scene, 128)
    img_prb = mi.render(small, seed=3, spp=SPECTRAL_SPP).detach()
    img_path = mi.render(small.replace(integrator=config_from_dict(
        {"type": "path", "max_depth": 8})), seed=3, spp=SPECTRAL_SPP)
    err = float((img_prb - img_path).abs().max())
    _check(err <= 1e-5, f"spectral cornell: the prb primal is not the path "
           f"image (max |diff| {err})")
    print(f"# spectral cornell 128x128: prb primal = path image (max |diff| "
          f"{err:.3g})")
    out["prb"]["primal_vs_path_max_abs"] = err
    del scene, small, grads
    torch.cuda.empty_cache()
    for extra in ("glass", "specfilm"):
        scene = mi.load_dict(spectral_variant_cornell_dict(
            mi, 512, 512, 8, extra), spectral=True)
        sppc, n_passes = ri.plan_passes(scene, SPECTRAL_SPP)
        mi.render_with_stats(scene, seed=0, spp=sppc)       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, rays = mi.render_with_stats(scene, seed=1, spp=SPECTRAL_SPP)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        nch = 4 if extra == "specfilm" else 3
        _check(tuple(img.shape) == (512, 512, nch)
               and bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
               f"spectral {extra}: image misshaped, not finite or black")
        means = img.mean(dim=(0, 1)).tolist()
        print(f"# spectral cornell {extra} path 512x512 {SPECTRAL_SPP}spp: "
              f"{rays} rays in {wall:.3f} s = {rays / wall / 1e6:.3f} "
              f"Mrays/s in {n_passes} passes, channel means {means} "
              f"[{card}]")
        out[extra] = {"rays": rays, "wall_s": wall,
                      "mrays_per_s": rays / wall / 1e6, "means": means}
        del scene, img
        torch.cuda.empty_cache()
    return out


def _spectral_loader(mi, card: str):
    """A few render_batch steps from a RayDataLoader: the reference is the
    spectral Cornell's XYZ film at SPECTRAL_LOADER_SIDE^2; its BSDF rows
    scaled by 0.6 and stepped by SGD on SPECTRAL_LOADER_BATCH-pixel
    batches through prb; the error of a fixed batch must fall."""
    import torch
    from mitsuba3_tpu_torch.core import spectrum

    side = SPECTRAL_LOADER_SIDE
    scene = mi.load_dict(_prb_dict(spectral_variant_cornell_dict(
        mi, side, side, 4)), spectral=True)
    ref = spectrum.srgb_to_xyz(mi.render(scene, seed=0, spp=64).detach())
    loader = mi.ad.RayDataLoader(ref.cpu().numpy(), SPECTRAL_LOADER_BATCH,
                                 seed=1, device=scene.device)
    fixed = next(loader)
    rows = (scene.bsdf_params * 0.6).detach().requires_grad_(True)
    opt = torch.optim.SGD([rows], lr=8.0)

    def err(batch, seed):
        img = mi.ad.render_batch(scene.replace(bsdf_params=rows), batch[0],
                                 seed=seed, spp=4)
        return torch.mean((img - batch[1]) ** 2)

    with torch.no_grad():
        errors = [float(err(fixed, 5))]
    t0 = time.perf_counter()
    for step in range(SPECTRAL_LOADER_STEPS):
        opt.zero_grad()
        err(next(loader), 10 + step).backward()
        opt.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with torch.no_grad():
        errors.append(float(err(fixed, 5)))
    _check(errors[1] < errors[0], f"ray loader: the error did not fall: "
           f"{errors}")
    print(f"# spectral ray loader: {SPECTRAL_LOADER_STEPS} render_batch "
          f"steps of {SPECTRAL_LOADER_BATCH} pixels x 4 spp in {wall:.3f} "
          f"s, fixed batch error {errors[0]:.6g} -> {errors[1]:.6g} "
          f"[{card}]")
    return {"steps": SPECTRAL_LOADER_STEPS, "wall_s": wall,
            "errors": errors}


def _leaves(obj, name: str = "") -> dict:
    """Every tensor of `obj` (a record of tensors and records) by its
    dotted field name."""
    import dataclasses
    import torch
    if isinstance(obj, torch.Tensor):
        return {name: obj}
    out = {}
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(_leaves(getattr(obj, f.name), f"{name}.{f.name}"))
    return out


def _glass_on_the_floor(mi):
    """The dispersive glass box standing on the floor (glass_lift 0) at
    SPECTRAL_CHECK_SIDE^2, 16 spp, max_depth 8, in the spectral variant:
    each bounce of ``path`` on the card and on the CPU from the same state
    (the CPU's, moved to the card), every field compared: liveness, the
    depth and the sampler equal, no value apart by more than 1e-3 (rtol
    and atol), so one bounce on the card differs from the CPU's by ulps
    alone. Rendered whole (from the card's camera rays and from the
    CPU's), the box parts card vs CPU: its bottom face and the floor
    coincide, and a ray inside hits the one or the other as an ulp
    decides (GLASS_LIFT); printed, not held, with the camera directions'
    lanes that differ. Returns those numbers."""
    import torch
    from mitsuba3_tpu_torch.integrators import path as path_mod
    from mitsuba3_tpu_torch.render import integrator as ri
    side = SPECTRAL_CHECK_SIDE
    d = spectral_variant_cornell_dict(mi, side, side, 8, "glass",
                                      glass_lift=0.0)
    scene_c = mi.load_dict(d, device="cpu", spectral=True)
    scene_g = mi.load_dict(d, spectral=True)
    img_c = mi.render(scene_c, seed=5, spp=16).numpy()
    close = {}
    for rays in ("card's", "CPU's"):
        with (_cpu_camera_rays(scene_c) if rays == "CPU's"
              else contextlib.nullcontext()):
            img_g = mi.render(scene_g, seed=5, spp=16).cpu().numpy()
        close[rays] = float(np.isclose(img_g, img_c, rtol=1e-3,
                                       atol=1e-3).mean())
    rng, ray, _ = ri._gen_camera_rays(scene_c, ri.pass_seed(5, 0), 16, 0,
                                      16)
    ray_g = ri._gen_camera_rays(scene_g, ri.pass_seed(5, 0), 16, 0, 16)[1]
    cam = [int((getattr(ray_g.d, c).cpu() != getattr(ray.d, c)).sum())
           for c in "xyz"]
    state = path_mod.init_state(scene_c, rng, ray, scene_c.integrator)
    step_c = path_mod.make_bounce(scene_c, scene_c.integrator)
    step_g = path_mod.make_bounce(scene_g, scene_g.integrator)
    n = state.active.shape[0]
    ulps = []
    for depth in range(8):
        out_c, _ = step_c(state)
        out_g, _ = step_g(_to_device(state, scene_g.device))
        fc, fg = _leaves(out_c), _leaves(_to_device(out_g, "cpu"))
        differ = torch.zeros(n, dtype=torch.bool)
        for name, a in fc.items():
            b = fg[name]
            if a.is_floating_point():
                ok = torch.isclose(b, a, rtol=1e-3, atol=1e-3,
                                   equal_nan=True)
                _check(bool(ok.all()), f"glass on the floor, bounce "
                       f"{depth}: {name} apart by more than 1e-3 on "
                       f"{int((~ok).sum())} lanes")
            else:
                _check(torch.equal(a, b), f"glass on the floor, bounce "
                       f"{depth}: {name} differs")
            if a.shape[:1] == (n,):
                differ |= (a != b).reshape(n, -1).any(dim=1)
        ulps.append(int(differ.sum()))
        state = out_c
    print(f"# agreement spectral glass on the floor ({side}x{side}, 16 spp, "
          f"max_depth 8): the card's camera directions differ from the "
          f"CPU's on {cam} of {n} lanes (x, y, z); rendered whole "
          + ", ".join(f"from the {k} camera rays {v:.5f}"
                      for k, v in close.items())
          + f" of values close (the coincident faces); bounce by bounce "
          f"from one state, lanes an ulp apart {ulps}, none by more than "
          f"1e-3")
    return {"camera_lanes_differ": cam, "close_whole": close,
            "ulp_lanes_per_bounce": ulps}


def _spectral_agreement(mi):
    """Card against CPU at SPECTRAL_CHECK_SIDE^2, 16 spp, in the spectral
    variant: the spectral Cornell by load_dict and (set_variant) by
    load_string, the dispersive box (GLASS_LIFT above the floor), the
    specfilm and the small terrain (K1 on the card), and the box on the
    floor bounce by bounce (_glass_on_the_floor); in RGB, the spectral
    Cornell (spectra projected to RGB) by load_dict and load_string."""
    side = SPECTRAL_CHECK_SIDE
    out = {}

    def pair(tag, load, **kw):
        img_g = mi.render(load(None), seed=5, **kw).cpu().numpy()
        out[tag] = _agree_images(
            f"spectral {tag} ({img_g.shape[1]}x{img_g.shape[0]})", img_g,
            mi.render(load("cpu"), seed=5, **kw).numpy())

    for extra in (None, "glass", "specfilm"):
        d = spectral_variant_cornell_dict(mi, side, side, 8, extra)
        pair(extra or "cornell", lambda dev, d=d: mi.load_dict(
            d, device=dev, spectral=True), spp=16)
    xml = spectral_cornell_xml(side, side, 8, 16)
    mi.set_variant("cuda_ad_spectral")
    try:
        pair("cornell XML", lambda dev: mi.load_string(xml, device=dev))
    finally:
        mi.set_variant("cuda_ad_rgb")
    with _accel("cells"):
        d = small_terrain_dict(mi.ScalarTransform4f)
        pair("small terrain", lambda dev: mi.load_dict(d, device=dev,
                                                      spectral=True), spp=4)
    out["glass on the floor"] = _glass_on_the_floor(mi)
    d = spectral_cornell_dict(mi, side, side, 8)
    pair("RGB-projected cornell", lambda dev: mi.load_dict(d, device=dev),
         spp=16)
    pair("RGB-projected cornell XML", lambda dev: mi.load_string(
        xml, device=dev))
    return out


def phase_spectral(mi, card: str):
    """The spectral variant on the card (nothing falls back to the CPU):
    terrain64k through cellserve (K1), the spectral Cornell's PRB step,
    the dispersive box and the specfilm, the ray loader's steps, and the
    card against the CPU. Returns (numbers, K1 launches of the terrain
    render, K1 rows)."""
    out, parts = {}, {}
    t0 = time.perf_counter()
    out["terrain64k"], launches, rows = _spectral_terrain(mi, card)
    parts["terrain64k"] = time.perf_counter() - t0
    for name, part in (("cornell", lambda: _spectral_cornell(mi, card)),
                       ("loader", lambda: _spectral_loader(mi, card)),
                       ("agreement", lambda: _spectral_agreement(mi))):
        t0 = time.perf_counter()
        out[name] = part()
        parts[name] = time.perf_counter() - t0
    for name, s_ in parts.items():
        print(f"# spectral {name}: {s_:.1f} s")
    out["part_s"] = parts
    return out, launches, rows


def phase_accels(mi, card: str):
    """The other accels on the card (nothing falls back to the CPU):
    terrain64k through bvh_xla, the grid and a HybridAccel (K4 any-hit)
    and the dense test; interior120k through bvh_xla and the grid; the
    small terrain on the card against the CPU through each; update()
    rebuilds of terrain64k under each. (The spectra are
    phase_spectral's.)"""
    scenes = {}
    out = {}
    for name, part in (
            ("terrain64k", lambda: _accels_terrain(mi, card, scenes)),
            ("interior120k", lambda: _accels_interior(mi, card)),
            ("agreement", lambda: _accels_agreement(mi)),
            ("update", lambda: _accels_update(mi, card, scenes))):
        t0 = time.perf_counter()
        out[name] = part()
        print(f"# accels {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main(only=None):
    """The whole smoke test, or with `only` (``--phase media``,
    ``--phase integrators``, ``--phase materials``, ``--phase shapes``,
    ``--phase accels`` or ``--phase spectral``) the kernel build and that
    phase alone, without the final line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only "
              "on the card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "mitsuba3_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (no "
              "mitsuba3_tpu_torch package beside this script)",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    import mitsuba3_tpu_torch as mi
    from mitsuba3_tpu_torch.ops import native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    card = smi.splitlines()[0] if smi else name
    print(f"# device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, numpy {np.__version__}")
    print(smi)

    t0 = time.perf_counter()
    logs = native.build(native.SOURCES)
    print(f"# build: {len(native.SOURCES)} sources in "
          f"{time.perf_counter() - t0:.1f} s into {native.BUILD_DIR}")
    for src, log in logs.items():
        for ln in log.splitlines():
            if any(w in ln for w in ("entry function", "registers", "spill",
                                     "smem")):
                print(f"#   {src}: {ln.strip()}")
            if src in SPILL_FREE and "spill stores" in ln:
                _check(" 0 bytes spill stores, 0 bytes spill loads" in ln,
                       f"{src} spills: {ln.strip()}")

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"# phase {label}: {time.perf_counter() - t:.1f} s")
        return out

    if only is not None:
        phase = {"media": phase_media, "integrators": phase_integrators,
                 "materials": phase_materials, "shapes": phase_shapes,
                 "accels": phase_accels,
                 "spectral": lambda m, c: phase_spectral(m, c)[0]}[only]
        result = timed(only, phase, mi, card)
        print(f"# chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
        print(json.dumps({only: result, "card": card}))
        return 0
    rows = timed("kernels K1", phase_kernels, mi, card)
    rows += timed("kernels K2 K3", phase_kernels_serve, mi, card)
    rows += timed("kernels K4", phase_kernels_tiled, mi, card)
    launches, renders = {}, []
    launches["cells"], render, ref = timed("render cellserve", phase_render,
                                           mi, card, "auto")
    renders.append(render)
    for accel in ("serve", "tiled"):
        launches[accel], render, _ = timed(f"render {accel}", phase_render,
                                           mi, card, accel, ref)
        renders.append(render)
    for accel in ("cells", "serve", "tiled"):
        timed(f"agreement {accel}", phase_agreement, mi, accel)
    prb_runs = [timed("cornell fwd+PRB bwd", phase_cornell_prb, mi, card),
                timed("terrain64k PRB step", phase_terrain_prb, mi, card),
                timed("glossy cornell fwd+PRB bwd", phase_cornell_prb, mi,
                      card, glossy_cornell_dict, "glossy cornell",
                      ((2, [6, 7]),), GLOSSY_CORNELL_SPP)]
    materials = [timed("every-BSDF cornell", phase_every_bsdf, mi, card)]
    rows += timed("kernels K1 glossy bounce", phase_kernels, mi, card,
                  glossy(terrain64k_dict), ".glossy", _bounce_rays)
    launches["cells.glossy"], glossy_terrain = timed(
        "render glossy terrain64k", phase_glossy_terrain, mi, card)
    materials.append(glossy_terrain)
    rows += timed("kernels K1 interior120k", phase_kernels, mi, card,
                  interior_dict, ".interior120k")
    launches["cells.interior120k"], interior = timed(
        "render interior120k", phase_interior, mi, card)
    loops = [timed("cornell inverse-rendering loop", phase_cornell_loop, mi,
                   card),
             timed("terrain64k vertex loop", phase_terrain_loop, mi, card)]
    scene_files = timed("scene files", phase_scene_files, mi, card)
    textures = timed("textures", phase_textures, mi, card)
    media = timed("media", phase_media, mi, card)
    integrators = timed("integrators", phase_integrators, mi, card)
    new_materials = timed("materials", phase_materials, mi, card)
    shapes = timed("shapes", phase_shapes, mi, card)
    accels = timed("accels", phase_accels, mi, card)
    spectral, launches["cells.spectral"], spectral_rows = timed(
        "spectral", phase_spectral, mi, card)
    rows += spectral_rows
    launches["cells.instanced"] = shapes["instanced field"]["k1_launches"]
    rows += timed("kernels K1 instanced prototype", phase_kernels, mi, card,
                  instanced_field_dict, ".instanced", _proto_rays,
                  lambda scene: scene.proto_accels[0])
    k8_device = timed("K8 device times", phase_k8_device, card)
    rows += timed("kernels K5-K8", lambda: phase_kernels_attic(
        card, k8_device=k8_device))
    attic_launches, queries = timed("attic queries", phase_attic_queries,
                                    card, k8_device)
    launches.update(attic_launches)

    for r in rows:
        counts = launches[r.pop("accel")]
        r["launches"] = counts[r["mode"]]
        if "queries" in r:
            r["launches"] = sum(
                q[f"{kind}_launches"][r["mode"]] for q in queries
                for kind in ("closest", "anyhit")
                if [q["accel"], q["rays"]] in r["queries"])
        r["card"] = card
    print(f"# chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"renders": renders, "card": card}))
    print(json.dumps({"attic_queries": queries, "card": card}))
    print(json.dumps({"prb": prb_runs, "card": card}))
    print(json.dumps({"materials": materials, "card": card}))
    print(json.dumps({"interior": interior, "card": card}))
    print(json.dumps({"loops": loops, "card": card}))
    print(json.dumps({"scene_files": scene_files, "card": card}))
    print(json.dumps({"textures": textures, "card": card}))
    print(json.dumps({"media": media, "card": card}))
    print(json.dumps({"integrators": integrators, "card": card}))
    print(json.dumps({"slice_materials": new_materials, "card": card}))
    print(json.dumps({"shapes": shapes, "card": card}))
    print(json.dumps({"accels": accels, "card": card}))
    print(json.dumps({"spectral": spectral, "card": card}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--k8-device-ms"]:
        sys.exit(k8_device_main())
    if sys.argv[1:2] == ["--phase"] and len(sys.argv) == 3:
        sys.exit(main(only=sys.argv[2]))
    sys.exit(main())
