"""Time JAX's side of the slowest scene-file CPU tests, jitted and eager.

    python tests/jax_side_times.py

Run from the repository root, on the CPU. Times, in one process and in
the order the tests run them, JAX's render of each of
``chip_smoke.XML_COMBOS`` at 16^2, 16 spp, ``max_depth`` 3 (as
``test_torch_sampler.py::test_xml_renders_match_jax``), once jitted and
once under ``jax.disable_jit``, and JAX's ``prb`` gradient of
``test_prb_grads_multijitter_mitchell_crop_match_jax`` jitted, jitted
with ``jax_disable_most_optimizations``, eager,
and jitted at ``max_depth`` 2, each in a fresh process. Each line is
one wall time in seconds; a first eager call also pays for compiling
the eager ops it meets first.
"""
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import mitsuba3_tpu as mj  # noqa: E402
import mitsuba3_tpu_torch as mt  # noqa: E402


def _timed(label, fn):
    t = time.perf_counter()
    fn()
    print(f"{label}: {time.perf_counter() - t:.2f} s", flush=True)


def main():
    tmp = tempfile.mkdtemp()
    for sampler, sensor, rfilter, crop in chip_smoke.XML_COMBOS:
        path = chip_smoke.cornell_xml(
            mt, tmp, 16, 16, max_depth=3, spp=16, sampler=sampler,
            sensor=sensor, rfilter=rfilter,
            crop=crop and tuple(c // 2 for c in crop))
        for eager in (False, True):
            def render():
                with jax.disable_jit(eager):
                    img, _ = mj.render_with_stats(mj.load_file(path), seed=5)
                    np.asarray(img)
            _timed(f"render {sampler} {'eager' if eager else 'jit'}", render)
    for mode, depth in GRAD_CASES:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--grad",
                        mode, str(depth)], check=True)


def grad_case(mode: str, depth: int):
    """One gradient case in a process of its own, so that no earlier
    compile is cached and the flag holds from the process's first."""
    jax.config.update("jax_disable_most_optimizations",
                      mode == "jit, no XLA optimisations")
    tmp = tempfile.mkdtemp()
    names = ("bsdf_params", "em_radiance")
    path = chip_smoke.cornell_xml(
        mt, tmp, 12, 12, max_depth=depth, spp=4, sampler="multijitter",
        rfilter="mitchell", crop=(8, 8, 2, 3), integrator="prb")
    sj = mj.load_file(path)

    def grad():
        with jax.disable_jit(mode == "eager"):
            g = jax.grad(lambda th: mj.render(
                sj.replace(**th), spp=4, seed=2).mean())(
                    {k: getattr(sj, k) for k in names})
            np.asarray(g["em_radiance"])
    _timed(f"prb gradient max_depth {depth} {mode}", grad)


GRAD_CASES = (("jit", 3), ("jit, no XLA optimisations", 3), ("eager", 3),
              ("jit", 2))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--grad"]:
        grad_case(sys.argv[2], int(sys.argv[3]))
    else:
        main()
