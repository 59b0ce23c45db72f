"""Count the tensor operations of one render pass per sampler, on the CPU.

    python3 -m mitsuba3_tpu_torch.tools.count_ops [--size 16] [--spp 64]

Run from the repository root. For each sampler type, the scene is
``chip_smoke.cornell_xml``'s Cornell box (perspective sensor, Gaussian
filter) read with ``load_file(..., device="cpu")``; one ``render_pass``
of 2 samples per pixel out of ``--spp`` runs under a dispatch counter of
every aten operation that is not a view. On the card nearly each such
operation is one kernel launch, so the count predicts a pass's launches
before a chip run. The orthogonal sampler is also counted with the
thinlens sensor and the lanczos filter (``chip_smoke``'s XML Cornell
cell). Prints one line per scene and the ratio to ``independent``.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--spp", type=int, default=64)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
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
