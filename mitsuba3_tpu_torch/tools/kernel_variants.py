"""Time drop-in variants of a hand-written kernel on its main path.

    python3 -m mitsuba3_tpu_torch.tools.kernel_variants KERNEL NAME=FILE ...

Run from the repository root on a machine with a card. KERNEL is
``cellserve_serve`` (K1, the cellserve render), ``bvh_serve_cull`` or
``bvh_serve_serve`` (K2 or K3, ``MI3T_ACCEL=serve``), ``bvh_tiled_mt``
(K4, ``MI3T_ACCEL=tiled``), ``bvh_pallas_traverse`` (K5, the bvh_pallas
queries), ``bvh_queue_serve`` (K7, the bvh_queue queries) or
``bvh2_serve`` (K8, a bvh2 query); each FILE is
a ``.cu`` that exports the same ``extern "C"`` launcher as
``csrc/KERNEL.cu``, whose own build runs as the variant ``shipped``. Every
variant is built with the shipped flags (ptxas' registers and spills are
printed) and swapped into the loader in place of the shipped library.

For K1-K4, per variant the tool prints the device ms and launches of each
mode of the kernel over one 512x512 4 spp terrain64k render, after a
warm-up render, with the image held bit-equal to the shipped kernel's;
then it runs ``chip_smoke.py``'s kernel phase for KERNEL, which holds one
full-width round to the plain version and times it. For K5 and K7 the
render is one timed bench_bvh query of each kind (``chip_smoke._bvh_rays``,
2^19 primary and 2^19 bounce rays, each query of the accel's module, after
a warm-up, by ``chip_smoke._timed_query``) with its wall, launches and the
kernel's device ms from one more, profiled call, every result held
bit-equal to the shipped kernel's; then ``chip_smoke.phase_kernels_attic``'s
rows for the kernel (the plain versions, and K5's per-tile spread, run
once with the shipped build loaded and are kept for the other variants).
For K8 the query is the bvh2 closest hit on the 2^19 bounce rays alone
(~13 s, most of it the refill), and the kernel's device ms are those of
its launches in the warm-up call, replayed under the profiler
(``chip_smoke._k8_replay_ms``: profiling the whole query takes minutes)
once every query has run, each replay followed by 20 launches on the
row's arguments, whose device time ``chip_smoke._k8_row`` then reports.
The variants run in the order given, then again in reverse, so that a
drift of the card shows; e.g. the parent commit's K5 against the shipped
one::

    git archive HEAD~1 mitsuba3_tpu_torch | tar -x -C build/parent
    python3 -m mitsuba3_tpu_torch.tools.kernel_variants bvh_pallas_traverse \
        parent=build/parent/mitsuba3_tpu_torch/csrc/bvh_pallas_traverse.cu
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import subprocess
import sys
from pathlib import Path

# kernel -> (MI3T_ACCEL of its render, chip_smoke's phase for one round)
KERNELS = {"cellserve_serve": ("cells", "phase_kernels"),
           "bvh_serve_cull": ("serve", "phase_kernels_serve"),
           "bvh_serve_serve": ("serve", "phase_kernels_serve"),
           "bvh_tiled_mt": ("tiled", "phase_kernels_tiled")}
# attic kernel -> (its module in ops/attic, the queries timed, the ray
# kinds, a name that only the kernel's device functions carry, its rows in
# chip_smoke.phase_kernels_attic)
ATTIC = {"bvh_pallas_traverse": (
             "bvh_pallas", ("intersect_bvh", "occluded_bvh",
                            "intersect_bvh_sorted", "occluded_bvh_sorted"),
             ("primary", "bounce"), "traverse_", "K5"),
         "bvh_queue_serve": (
             "bvh_queue", ("intersect_bvh", "occluded_bvh"),
             ("primary", "bounce"), "serve_multi_kernel", "K7"),
         "bvh2_serve": (
             "bvh2", ("intersect_bvh",), ("bounce",), "bvh2_serve_kernel",
             "K8")}
OUT = Path("build") / "variants"


def _build(kernel: str, sources: dict) -> dict:
    """Build every variant at once; returns {name: loaded library}."""
    from mitsuba3_tpu_torch.ops import native
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = OUT / f"lib{kernel}-{name}.so"
        procs[name] = (lib, subprocess.Popen(
            native._command(Path(src), lib), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"kernel_variants: {name} does not build:\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill stores" in ln:
                print(f"# {name}: {ln.strip()}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted({**KERNELS, **ATTIC}))
    ap.add_argument("variants", nargs="+", metavar="NAME=FILE")
    args = ap.parse_args(argv)
    sources = dict(v.split("=", 1) for v in args.variants)

    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    import mitsuba3_tpu_torch as mi
    from mitsuba3_tpu_torch.ops import native

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    libs = {"shipped": native.load(args.kernel),
            **_build(args.kernel, sources)}
    if args.kernel in ATTIC:
        return _attic(args.kernel, libs, card)
    accel, phase = KERNELS[args.kernel]
    _, labels = smoke._accel_kernels(accel)
    with smoke._accel(accel):
        scene = mi.load_dict(smoke.terrain64k_dict(mi.ScalarTransform4f))

    def render():
        return mi.render_with_stats(scene, seed=2, spp=4,
                                    max_wavefront=1 << 20)[0]

    order = list(libs) + list(libs)[::-1]
    ref = None
    for i, name in enumerate(order):
        native._loaded[args.kernel] = libs[name]
        render()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            img = render()
            torch.cuda.synchronize()
        if ref is None:
            ref = img
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        per_mode = {label: (round(sum(e.device_time_total for e in events
                                      if key in e.key) / 1e3, 3),
                            sum(e.count for e in events if key in e.key))
                    for label, key in labels.items()}
        print(f"# {args.kernel} {name} (pass {i // len(libs)}), per render: "
              f"{per_mode} (device ms, launches); image equal to shipped's: "
              f"{torch.equal(img, ref)} [{card}]", flush=True)
    del scene
    torch.cuda.empty_cache()
    for i, name in enumerate(order):
        native._loaded[args.kernel] = libs[name]
        print(f"# {args.kernel} {name} (pass {i // len(libs)}), one "
              f"full-width round:", flush=True)
        getattr(smoke, phase)(mi, card)
    native._loaded[args.kernel] = libs["shipped"]
    return 0


def _flat(out):
    """The tensors of a query's result, in order."""
    if hasattr(out, "x"):
        return [out.x, out.y]
    if isinstance(out, (tuple, list)):
        return [t for x in out for t in _flat(x)]
    return [out]


def _attic(kernel: str, libs: dict, card: str) -> int:
    """K5, K7 or K8: per variant, the timed bench_bvh queries, then the
    kernel's rows of chip_smoke's attic phase."""
    import torch
    import chip_smoke as smoke
    from mitsuba3_tpu_torch.ops import native
    modname, queries, kinds, label, rows = ATTIC[kernel]
    mod = importlib.import_module(f"mitsuba3_tpu_torch.ops.attic.{modname}")
    acc = mod.build(*smoke.make_terrain(smoke.BVH_SIDE), device="cuda")
    rays = {kind: smoke._bvh_rays(kind) for kind in kinds}
    order = list(libs) + list(libs)[::-1]
    ref, equal, timed = {}, True, []
    for i, name in enumerate(order):
        native._loaded[kernel] = libs[name]
        for kind, (o, d, maxt) in rays.items():
            for q in queries:
                fn = getattr(mod, q)
                launched = [] if kernel == "bvh2_serve" else None
                out, wall, n = smoke._timed_query(mod.LAUNCHES, fn, acc, o,
                                                  d, maxt, record=launched)
                got = ref.setdefault((kind, q), _flat(out))
                same = all(torch.equal(a, b)
                           for a, b in zip(_flat(out), got))
                equal &= same
                dev = None
                if launched is None:
                    dev = smoke._device_ms(lambda: fn(acc, o, d, maxt),
                                           label, warm=False)
                timed.append((i, name, kind, q, wall, n, same, launched,
                              dev))
    # K8's device times are taken only now, every query being done: a
    # profiler session that follows another one and a large unprofiled
    # workload misses kernels (chip_smoke.phase_k8_device); per pass and
    # variant, the query's recorded launches replayed and 20 launches on
    # the row's arguments
    row, k8_rows = None, []
    if kernel == "bvh2_serve":
        row = mod.first_round(acc, *rays["bounce"])
    for i, name, kind, q, wall, n, same, launched, dev in timed:
        if dev is None:
            native._loaded[kernel] = libs[name]
            dev = smoke._k8_replay_ms(acc, launched)
            k8_rows.append(smoke._device_ms(lambda: mod.serve(acc, *row),
                                            smoke.K8_KERNEL, 20))
        dev_ms, seen = dev
        # the profiler must see every launch of the kernel (bvh_queue's
        # cull is K6, another kernel)
        equal &= seen == sum(v for k, v in n.items() if k != "cull")
        print(f"# {kernel} {name} (pass {i // len(libs)}), {kind} "
              f"{q}: {wall * 1e3:.3f} ms, "
              f"{smoke.BVH_RAYS / wall / 1e6:.3f} Mrays/s, launches "
              f"{n}, kernel device ms {dev_ms:.4f} in {seen} "
              f"launches; results equal to shipped's: {same} "
              f"[{card}]", flush=True)
    del acc
    torch.cuda.empty_cache()
    plain = {}
    for i, name in enumerate(order):
        native._loaded[kernel] = libs[name]
        print(f"# {kernel} {name} (pass {i // len(libs)}), full-width "
              f"rows:", flush=True)
        smoke.phase_kernels_attic(
            card, kernels=(rows,), plain=plain,
            k8_device={"bounce row": k8_rows[i]} if k8_rows else None)
    native._loaded[kernel] = libs["shipped"]
    if not equal:
        print("kernel_variants: a variant's results differ from the shipped "
              "kernel's, or the profiler missed launches", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
