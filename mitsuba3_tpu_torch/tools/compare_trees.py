"""Time the cells that two trees of the port share, alternating in one call.

    python3 -m mitsuba3_tpu_torch.tools.compare_trees LABEL=DIR ...

Run from the repository root on a machine with a card. Each DIR is a
checkout of the repository, e.g. the parent commit unpacked by ``git
archive`` into ``build/parent``. Per tree, in the order given and then in
reverse (so that a drift of the card or its host shows), a process of its
own imports that tree's ``mitsuba3_tpu_torch``, builds that tree's kernels
and runs this checkout's ``chip_smoke.py`` phases on it, those that
``--cells`` names: ``cornell``, the diffuse Cornell fwd + PRB bwd step at
512^2, 64 spp (``phase_cornell_prb``); ``terrain``, the terrain64k render
through cellserve (``phase_render``); ``interior``, the three
interior120k renders (``phase_interior``); ``every_bsdf``, the every-BSDF
Cornell's ``path`` render at 512^2 and its PRB step at 128^2
(``phase_every_bsdf``). The first three by default. The procedure is the
same for every tree; only the package differs. Each process prints its
numbers as one JSON line; the tool ends with a table of them::

    git archive HEAD~1 | tar -x -C build/parent
    python3 -m mitsuba3_tpu_torch.tools.compare_trees parent=build/parent new=.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TAG = "compare_trees: "


CELLS = ("cornell", "terrain", "interior", "every_bsdf")


def child(tree: str, cells) -> int:
    """Run `cells` on the package of `tree`; print their numbers."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import mitsuba3_tpu_torch as mi
    from mitsuba3_tpu_torch.ops import native
    assert os.path.samefile(os.path.dirname(mi.__file__),
                            os.path.join(tree, "mitsuba3_tpu_torch"))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"tree": tree, "card": card, "torch": torch.__version__}
    if {"terrain", "interior"} & set(cells):
        native.build(native.SOURCES)
    if "cornell" in cells:
        cornell = smoke.phase_cornell_prb(mi, card)
        out.update(cornell_step_s=cornell["wall_s"],
                   cornell_mrays_per_s=cornell["mrays_per_s"],
                   cornell_launches_per_pass=cornell["profiled_kernels"][
                       "other kernels"]["launches"])
    if "terrain" in cells:
        _, terrain, _ = smoke.phase_render(mi, card, "auto")
        out.update(terrain64k_wall_s=terrain["wall_s"],
                   terrain64k_mrays_per_s=terrain["mrays_per_s"])
    if "interior" in cells:
        _, interior = smoke.phase_interior(mi, card)
        out.update(interior120k_wall_s=interior["wall_s"],
                   interior120k_mrays_per_s=interior["mrays_per_s"])
    if "every_bsdf" in cells:
        every = smoke.phase_every_bsdf(mi, card)
        out.update(every_bsdf_path_wall_s=every["wall_s"],
                   every_bsdf_path_mrays_per_s=every["mrays_per_s"],
                   every_bsdf_launches_per_pass=every["profiled_kernels"][
                       "other kernels"]["launches"],
                   every_bsdf_prb_step_s=every["prb"]["wall_s"])
    print(TAG + json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", metavar="LABEL=DIR")
    ap.add_argument("--cells", default="cornell,terrain,interior",
                    help="comma-separated, of: " + ", ".join(CELLS))
    ap.add_argument("--child", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cells = args.cells.split(",")
    if not set(cells) <= set(CELLS):
        ap.error(f"--cells: not a cell: {sorted(set(cells) - set(CELLS))}")
    if args.child:
        return child(args.child, cells)
    trees = [t.split("=", 1) for t in args.trees]
    order = trees + trees[::-1]
    results = []
    for label, tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--cells", args.cells],
            cwd=ROOT, capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr)
        if proc.returncode != 0:
            print(f"compare_trees: {label} ({tree}) failed with code "
                  f"{proc.returncode}", file=sys.stderr)
            return 1
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith(TAG)]
        results.append(dict(json.loads(line[-1][len(TAG):]), label=label))
    keys = [k for k in ("cornell_step_s", "terrain64k_mrays_per_s",
                        "interior120k_mrays_per_s",
                        "every_bsdf_path_mrays_per_s",
                        "every_bsdf_launches_per_pass",
                        "every_bsdf_prb_step_s") if k in results[0]]
    print("# run  tree     " + "  ".join(f"{k:>24}" for k in keys))
    for i, r in enumerate(results):
        print(f"# {i + 1:3d}  {r['label']:8s} "
              + "  ".join(f"{r[k]:24.6f}" for k in keys)
              + f"  [{r['card']}]")
    print(json.dumps({"compare_trees": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
