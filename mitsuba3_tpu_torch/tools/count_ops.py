"""Count the tensor operations of one render pass per sampler, on the CPU.

    python3 -m mitsuba3_tpu_torch.tools.count_ops [--size 16] [--spp 64]
    python3 -m mitsuba3_tpu_torch.tools.count_ops --textured [--size 16]
    python3 -m mitsuba3_tpu_torch.tools.count_ops --media [--size 16]
    python3 -m mitsuba3_tpu_torch.tools.count_ops --integrators [--size 16]
    python3 -m mitsuba3_tpu_torch.tools.count_ops --materials [--size 16]
    python3 -m mitsuba3_tpu_torch.tools.count_ops --shapes [--size 16]
    python3 -m mitsuba3_tpu_torch.tools.count_ops --accels [--size 16]

Run from the repository root. For each sampler type, the scene is
``chip_smoke.cornell_xml``'s Cornell box (perspective sensor, Gaussian
filter) read with ``load_file(..., device="cpu")``; one ``render_pass``
of 2 samples per pixel out of ``--spp`` runs under a dispatch counter of
every aten operation that is not a view. On the card nearly each such
operation is one kernel launch, so the count predicts a pass's launches
before a chip run. The orthogonal sampler is also counted with the
thinlens sensor and the lanczos filter (``chip_smoke``'s XML Cornell
cell). Prints one line per scene and the ratio to ``independent``.

``--textured`` counts instead one PRB pass (forward and backward, as
``chip_smoke._grad_step`` runs it: 2 of ``--spp`` samples per pixel) of
``chip_smoke``'s textured Cornell (``textured_cornell_xml``, its image
files at 64^2) and of the diffuse Cornell box, both with ``prb`` at
``max_depth`` 8, and prints their ratio.

``--media`` counts one PRB pass (forward and backward, 2 of ``--spp``
samples per pixel) of ``chip_smoke``'s fog Cornell under ``prbvolpath``
(``max_depth`` 6; gradients of medium_params, bsdf_params and
em_radiance) beside the diffuse Cornell's under ``prb`` at the same
depth, then one forward pass of the smoke (``chip_smoke.smoke_dict`` on a
16^3 grid, ``max_depth`` 8) under ``volpath`` and ``volpathmis``, and of
the foggy interior (``foggy_interior_dict`` at 9,000 triangles, cellserve)
under ``volpath``. A pass's operations barely depend on its lane count
(the loops run a fixed number of steps), so the count at ``--size``
predicts a full-size pass.

``--integrators`` counts one forward pass (2 of ``--spp`` samples per
pixel) of bench.py's Cornell box (``max_depth`` 8) under ``path``,
``direct``, ``aov`` (``chip_smoke.ALL_AOVS`` around a ``path``) and
``moment`` (around ``path``), of ``chip_smoke``'s sphere-lit,
directionalarea and projector Cornells under ``path``, of the small
terrain (8,978 faces, cellserve) under ``path``, ``direct`` and
``depth``, and one light-tracer pass of 2 light paths per pixel
(``ptracer._trace_pass``, ``max_depth`` 8) on the Cornell box.

``--materials`` counts one forward pass (2 of ``--spp`` samples per
pixel, ``max_depth`` 8) and one PRB pass (forward and backward; bsdf_params
and em_radiance) of ``chip_smoke``'s materials Cornell (principled,
principledthin, two measured tables of 16^2, half_diffuse) beside the
diffuse Cornell box's, one forward pass of a hair ball (``chip_smoke``'s
hair_dict with 64 strands of 17 points: 12,288 tube faces, cellserve) and
of the small terrain in ``PRINCIPLED_TERRAIN_BSDF`` (cellserve).

``--shapes`` counts one forward pass (2 of ``--spp`` samples per pixel,
``max_depth`` 4) of ``chip_smoke``'s four shape scenes at their full
geometry: the analytic terrain64k (464 analytic rows), the instanced
field, the SDF blob on terrain64k and the ellipsoid cloud, with the
instance loop's rounds; on the CPU K1 runs its plain version, whose
operations are also given apart, and the count with each K1 call as one
launch is the card's. The analytic rows are evaluated in chunks of at
most ``ops/analytic.py``'s STEP_ELEMS rows x lanes, so at a full width
of 2^20 lanes a query takes about 59 chunks where a small pass takes 4,
and the instance loop's rounds follow the rays: scale those parts.

``--accels`` counts one forward pass (2 of ``--spp`` samples per pixel,
``max_depth`` 4) of terrain64k (65,536 faces) through cellserve, bvh_xla,
the grid, a HybridAccel and the dense test (``MI3T_ACCEL=none``), each K1
or K4 call as one launch, with the traversal loops' steps. A loop's
steps follow its slowest lane, and the dense test's ray steps the lane
count (65,536 lanes a step): scale those parts.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func._schema.is_mutable and func.is_view:
            return func(*args, **(kwargs or {}))
        self.n += 1
        return func(*args, **(kwargs or {}))


def count_pass(path: str, spp: int) -> int:
    import mitsuba3_tpu_torch as mt
    from mitsuba3_tpu_torch.render import integrator as ri
    scene = mt.load_file(path, device="cpu")
    with torch.no_grad(), _Count() as c:
        ri.render_pass(scene, 7, 2, 0, spp, base_seed=7)
    return c.n


def count_prb_pass(scene, spp: int, names) -> int:
    """Operations of one PRB pass of 2 of `spp` samples per pixel, forward
    and backward, differentiating the θ tables `names`."""
    import chip_smoke
    with _Count() as c:
        chip_smoke._grad_step(scene, names, 7, spp, passes=1)
    return c.n


def count_textured(size: int, spp: int):
    import chip_smoke
    import mitsuba3_tpu_torch as mt
    names = ("bsdf_params", "em_radiance", "textures")
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_cornell_textures(tmp, 64)
        textured = mt.load_file(chip_smoke.textured_cornell_xml(
            mt, tmp, size, size, 8, spp), device="cpu")
        n_tex = count_prb_pass(textured, spp, names)
    diffuse = mt.load_dict(chip_smoke._prb_dict(mt.cornell_box(
        size, size, spp=spp, max_depth=8)), device="cpu")
    n_dif = count_prb_pass(diffuse, spp, names)
    print(f"PRB pass {size}x{size}, 2 of {spp} spp, max_depth 8: textured "
          f"cornell {n_tex} ops, diffuse cornell {n_dif} ops, "
          f"{n_tex / n_dif:.2f}x")


def count_media(size: int, spp: int):
    import chip_smoke
    import mitsuba3_tpu_torch as mt
    from mitsuba3_tpu_torch.render import integrator as ri
    names = ("medium_params", "bsdf_params", "em_radiance")
    fog = mt.load_dict(chip_smoke.fog_cornell_dict(
        mt, size, size, 6, "prbvolpath"), device="cpu")
    n_fog = count_prb_pass(fog, spp, names)
    diffuse = mt.load_dict(chip_smoke._prb_dict(mt.cornell_box(
        size, size, spp=spp, max_depth=6)), device="cpu")
    n_dif = count_prb_pass(diffuse, spp, names[1:])
    print(f"PRB pass {size}x{size}, 2 of {spp} spp, max_depth 6: fog "
          f"cornell (prbvolpath) {n_fog} ops, diffuse cornell (prb) {n_dif} "
          f"ops, {n_fog / n_dif:.2f}x")
    scenes = [(f"smoke 16^3 {it}", chip_smoke.smoke_dict(mt, size, 16, it))
              for it in ("volpath", "volpathmis")]
    scenes.append(("foggy interior 9000 volpath",
                   chip_smoke.foggy_interior_dict(mt.ScalarTransform4f, 9000,
                                                  size)))
    for label, d in scenes:
        scene = mt.load_dict(d, device="cpu")
        with torch.no_grad(), _Count() as c:
            ri.render_pass(scene, 7, 2, 0, spp, base_seed=7)
        print(f"{label} pass {size}x{size}, 2 of {spp} spp: {c.n} ops")


def count_integrators(size: int, spp: int):
    import chip_smoke
    import mitsuba3_tpu_torch as mt
    from mitsuba3_tpu_torch.integrators import ptracer
    from mitsuba3_tpu_torch.render import integrator as ri
    cornell = mt.cornell_box(size, size, spp=spp, max_depth=8)
    path = cornell["integrator"]
    terrain = chip_smoke.small_terrain_dict(mt.ScalarTransform4f, size)
    scenes = [(f"cornell {t['type']}", dict(cornell, integrator=t)) for t in (
        path, {"type": "direct"},
        {"type": "aov", "aovs": chip_smoke.ALL_AOVS, "integrator": path},
        {"type": "moment", "nested": path})]
    scenes += [
        ("sphere cornell path", chip_smoke.sphere_cornell_dict(
            mt, size, size, 8)),
        ("directionalarea cornell path",
         chip_smoke.directionalarea_cornell_dict(mt, size, size, 8)),
        ("projector cornell path", chip_smoke.projector_cornell_dict(
            mt, size, size, 8, size))]
    scenes += [(f"small terrain {t}", dict(terrain, integrator={
        "type": t, "max_depth": 4})) for t in ("path", "direct", "depth")]
    for label, d in scenes:
        scene = mt.load_dict(d, device="cpu")
        with torch.no_grad(), _Count() as c:
            ri.render_pass(scene, 7, 2, 0, spp, base_seed=7)
        print(f"{label} pass {size}x{size}, 2 of {spp} spp: {c.n} ops")
    scene = mt.load_dict(dict(cornell, integrator={"type": "ptracer",
                                                   "max_depth": 8}),
                         device="cpu")
    with torch.no_grad(), _Count() as c:
        ptracer._trace_pass(scene, 7, 2 * size * size, scene.integrator)
    print(f"cornell ptracer pass, {2 * size * size} light paths: {c.n} ops")


def count_materials(size: int, spp: int):
    import chip_smoke
    import mitsuba3_tpu_torch as mt
    from mitsuba3_tpu_torch.render import integrator as ri
    chip_smoke.register_half_diffuse(mt)
    names = ("bsdf_params", "em_radiance")
    iso, aniso = ({"tables": chip_smoke.measured_fields(n, 8, 16)}
                  for n in (1, 4))
    cornells = (("materials cornell", chip_smoke.materials_cornell_dict(
        mt, size, size, 8, iso, aniso)),
        ("diffuse cornell", mt.cornell_box(size, size, spp=spp,
                                           max_depth=8)))
    for label, d in cornells:
        scene = mt.load_dict(d, device="cpu")
        with torch.no_grad(), _Count() as c:
            ri.render_pass(scene, 7, 2, 0, spp, base_seed=7)
        prb = count_prb_pass(mt.load_dict(chip_smoke._prb_dict(d),
                                          device="cpu"), spp, names)
        print(f"{label} {size}x{size}, 2 of {spp} spp, max_depth 8: path "
              f"pass {c.n} ops, PRB pass {prb} ops")
    with tempfile.TemporaryDirectory() as tmp:
        path = chip_smoke.write_curve_file(
            os.path.join(tmp, "hair.txt"), chip_smoke.hair_strands(64),
            chip_smoke.HAIR_RADIUS)
        scenes = [("hair ball 64 strands", chip_smoke.hair_dict(
            mt, path, size, chip_smoke.HAIR_EUMELANIN)),
            ("principled small terrain", chip_smoke.principled_terrain_dict(
                chip_smoke.small_terrain_dict, mt.ScalarTransform4f,
                width=size))]
        for label, d in scenes:
            with chip_smoke._accel("cells"):
                scene = mt.load_dict(d, device="cpu")
            with torch.no_grad(), _Count() as c:
                ri.render_pass(scene, 7, 2, 0, spp, base_seed=7)
            print(f"{label} path pass {size}x{size}, 2 of {spp} spp, "
                  f"{int((scene.face_shape >= 0).sum())} faces: {c.n} ops")


def count_shapes(size: int, spp: int):
    import chip_smoke
    import mitsuba3_tpu_torch as mt
    from mitsuba3_tpu_torch.ops import cellserve
    from mitsuba3_tpu_torch.render import integrator as ri
    T = mt.ScalarTransform4f
    scenes = (
        ("analytic terrain64k", chip_smoke.analytic_terrain_dict(
            chip_smoke.terrain64k_dict, T)),
        ("instanced field", chip_smoke.instanced_field_dict(T, width=size)),
        ("sdf blob", chip_smoke.sdf_terrain_dict(chip_smoke.terrain64k_dict,
                                                 T)),
        ("ellipsoid cloud", chip_smoke.ellipsoid_cloud_dict(T, width=size)))
    for label, d in scenes:
        d["sensor"]["film"].update(width=size, height=size)
        with chip_smoke._accel("cells"):
            scene = mt.load_dict(d, device="cpu")
        c = _Count()
        k1 = [0, 0]       # K1 calls, operations of their plain versions
        serve = cellserve.serve_blocks

        def one_launch(*args):
            n0 = c.n
            out = serve(*args)
            k1[0] += 1
            k1[1] += c.n - n0
            return out
        cellserve.serve_blocks = one_launch
        try:
            with torch.no_grad(), chip_smoke._BlockMeter() as blocks, c:
                ri.render_pass(scene, 7, 2, 0, spp, base_seed=7)
        finally:
            cellserve.serve_blocks = serve
        print(f"{label} path pass {size}x{size}, 2 of {spp} spp: {c.n} ops, "
              f"{c.n - k1[1] + k1[0]} with each of the {k1[0]} K1 calls as "
              f"one launch (their plain versions: {k1[1]} ops); "
              f"{scene.n_analytic} analytic rows, {blocks.rounds} instance "
              f"rounds in {blocks.queries} queries")


def count_accels(size: int, spp: int):
    import chip_smoke
    import mitsuba3_tpu_torch as mt
    from mitsuba3_tpu_torch.ops import bvh_tiled, cellserve
    from mitsuba3_tpu_torch.render import integrator as ri
    d = chip_smoke.terrain64k_dict(mt.ScalarTransform4f)
    d["sensor"]["film"].update(width=size, height=size)
    for kind in ("cells", "xla", "grid", "hybrid", "none"):
        scene = chip_smoke._load_accel(mt, d, kind, "cpu")[0]
        c = _Count()
        calls = [0, 0]    # K1 and K4 calls, operations of their plain versions
        saved = cellserve.serve_blocks, bvh_tiled.run_round

        def one_launch(fn):
            def launch(*args):
                n0 = c.n
                out = fn(*args)
                calls[0] += 1
                calls[1] += c.n - n0
                return out
            return launch
        cellserve.serve_blocks = one_launch(saved[0])
        bvh_tiled.run_round = one_launch(saved[1])
        chip_smoke._reset_accel_counters()
        try:
            with torch.no_grad(), c:
                ri.render_pass(scene, 7, 2, 0, spp, base_seed=7)
        finally:
            cellserve.serve_blocks, bvh_tiled.run_round = saved
        steps = "; ".join(
            f"{name} {m} {v[0]} steps in {v[1]} queries"
            for name, modes in chip_smoke._steps_per_query().items()
            for m, v in modes.items() if v[1])
        print(f"terrain64k {kind} path pass {size}x{size}, 2 of {spp} spp: "
              f"{c.n} ops, {c.n - calls[1] + calls[0]} with each of the "
              f"{calls[0]} K1/K4 calls as one launch; {steps or 'no loop'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--textured", action="store_true")
    ap.add_argument("--media", action="store_true")
    ap.add_argument("--integrators", action="store_true")
    ap.add_argument("--materials", action="store_true")
    ap.add_argument("--shapes", action="store_true")
    ap.add_argument("--accels", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.accels:
        count_accels(args.size, args.spp)
        return 0
    if args.shapes:
        count_shapes(args.size, args.spp)
        return 0
    if args.materials:
        count_materials(args.size, args.spp)
        return 0
    if args.integrators:
        count_integrators(args.size, args.spp)
        return 0
    if args.textured:
        count_textured(args.size, args.spp)
        return 0
    if args.media:
        count_media(args.size, args.spp)
        return 0
    import chip_smoke
    import mitsuba3_tpu_torch as mt
    from mitsuba3_tpu_torch.render.sampler import TYPES
    scenes = [(t, "perspective", "gaussian") for t in TYPES]
    scenes.append(("orthogonal", "thinlens", "lanczos"))
    base = None
    with tempfile.TemporaryDirectory() as tmp:
        for k, (stype, sensor, rfilter) in enumerate(scenes):
            d = os.path.join(tmp, str(k))
            os.mkdir(d)
            path = chip_smoke.cornell_xml(
                mt, d, args.size, args.size, spp=args.spp, sampler=stype,
                sensor=sensor, rfilter=rfilter)
            n = count_pass(path, args.spp)
            base = base or n
            print(f"{stype}/{sensor}/{rfilter} {args.size}x{args.size}, "
                  f"2 of {args.spp} spp: {n} ops, {n / base:.2f}x "
                  f"independent")
    return 0


if __name__ == "__main__":
    sys.exit(main())
