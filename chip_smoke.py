#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``mitsuba3_tpu_torch``).

Run from the repository root on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases:
1. the card's name and power limit (exits nonzero without a CUDA device);
2. build every kernel and the SAH builder from ``mitsuba3_tpu_torch/csrc``
   into ``build/kernels/`` (nvcc or g++, one process per source, all at
   once);
3. kernels: one full-width round of the terrain64k main path (primary
   rays of the 512^2, 4 spp camera) through each kernel and its plain
   PyTorch version, compared and timed: K1 after pairgen and the pair sort
   (closest and any-hit), K2 as the first bvh_serve cull, K3 as the first
   bvh_serve block serve after the leaf sort, K4 as the first bvh_tiled
   16-slot round (closest and any-hit);
4. render: ``load_dict`` of the terrain64k scene of ``bench.py``, a
   4 spp render, then a timed one, then one under torch.profiler for
   device time by kernel; first with the default accel (cellserve, K1),
   then under ``MI3T_ACCEL=serve`` (K2, K3) and ``MI3T_ACCEL=tiled`` (K4),
   each held against the cellserve image and checked to launch its kernels;
5. agreement: the small terrain rendered on the card and on the CPU, under
   each accel;
6. one JSON line of per-kernel numbers.

The last line is ``{"ok": true, "device": {...}}``; any failed check ends
the script with a nonzero code before it. The script imports no JAX: the
terrain functions below are numpy copies of the benchmark's.
"""
from __future__ import annotations

import contextlib
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
K = 128
LIBRARY_NOTE = ("none: no single PyTorch call computes this function")


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


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def _check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _cuda_ms(fn, reps: int):
    """Mean milliseconds of fn() over `reps` launches (CUDA events, after
    one warm-up call)."""
    import torch
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
    print(f"# {tpu} {mode}: kernel {k_ms:.4f} ms, plain {p_ms:.2f} ms, "
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


def _primary_rays(scene):
    """The 1,048,576 primary rays of the terrain64k camera (one pass)."""
    from mitsuba3_tpu_torch.render import integrator as ri
    sppc, _ = ri.plan_passes(scene, 4, 1 << 20)
    return ri._gen_camera_rays(scene, ri.pass_seed(0, 0), sppc, 0, 4)[1]


def phase_kernels(mi, card: str):
    """K1 against its plain version on one full-width round of the
    terrain64k main path."""
    import torch
    from mitsuba3_tpu_torch.ops import cellserve as cs

    scene = mi.load_dict(terrain64k_dict(mi.ScalarTransform4f))
    acc = scene.accel
    ray = _primary_rays(scene)
    n = ray.o.x.shape[0]
    og, dg = cs._grid_ray(acc, ray.o, ray.d)
    t_in, t_out, inv = cs._clip(acc, og, dg, ray.maxt)
    active = t_in <= t_out
    slots, _, _ = cs._pairgen(acc, og, dg, inv, t_in, t_out, active,
                              torch.zeros_like(t_in))
    _, rays, r0, nr = cs.sort_pairs(acc, slots, ray.o, ray.d)
    n_pairs = int((slots < acc.res ** 3).sum())
    n_sub = r0.shape[0]
    sum_nr = int(nr.sum())
    # every real pair of a sub-block tests every row of its window; the
    # padding pairs, all in the last sub-block, need none
    tests = K * (K * sum_nr - (n_sub * K - n_pairs) * int(nr[-1]))
    print(f"# kernels: {n} lanes, {n_pairs} pairs, {n_sub} sub-blocks, "
          f"sum(nr) = {sum_nr} rows, slab table {acc.tris.shape[0]} rows "
          f"({acc.tris.numel() * 4 / 1e6:.1f} MB), res {acc.res}")

    rows = []
    for want_uv, mode in ((True, "closest"), (False, "anyhit")):
        kt, kp, _, _ = cs.serve_blocks(acc.tris, rays, r0, nr, want_uv)
        pt, pp, _, _ = cs.serve_blocks_plain(acc.tris, rays, r0, nr,
                                             want_uv)
        torch.cuda.synchronize()
        big_k, big_p = kt >= cs.BIG, pt >= cs.BIG
        _check(bool((big_k == big_p).all()),
               f"K1 {mode}: BIG (no hit) differs on "
               f"{int((big_k != big_p).sum())} pairs")
        err, _ = _hold_t(f"K1 {mode}", kt, pt, ~big_p,
                         *((kp, pp) if want_uv else ()))
        k_ms = _cuda_ms(lambda: cs.serve_blocks(acc.tris, rays, r0, nr,
                                                want_uv), 20)
        p_ms = _cuda_ms(lambda: cs.serve_blocks_plain(acc.tris, rays, r0,
                                                      nr, want_uv), 2)
        out_b = 16 if want_uv else 4
        rows.append(_row(
            f"cellserve_serve.{mode}", "K1", "cellserve_serve.cu",
            "mitsuba3_tpu/ops/cellserve.py:348", mode, err, k_ms, p_ms,
            tests * OPS_PER_TEST,
            acc.tris.numel() * 4 + rays.shape[1] * (24 + out_b) + n_sub * 8,
            card, accel="cells", sum_nr=sum_nr, pairs=n_pairs, tests=tests))
    del scene
    torch.cuda.empty_cache()
    return rows


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


def phase_kernels_serve(mi, card: str):
    """K2 (first cull) and K3 (first block serve after the leaf sort) of a
    bvh_serve query on the terrain64k primary rays, against their plain
    versions."""
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
    rows = []

    # K2: the first cull
    lk = i[bs.LK]
    kb = bs.cull(acc, f, lk)
    work = {}
    pb = bs.cull_plain(acc, f, lk, stats=work)
    torch.cuda.synchronize()
    _check(torch.equal(kb, pb), f"K2: keys differ on "
           f"{int((kb != pb).sum())} of {kb.numel()}")
    live = (pb[0] != bs.NONE) & (i[bs.RID] >= 0)
    print(f"# K2: keys bit-equal, {int(live.sum())} rays request a leaf; "
          f"{work['chunks_taken']} of {acc.m_pad // bs.LC * npad // bs.RCHUNK}"
          f" (block, chunk) pairs taken; {work['sup_tests']} chunk-box and "
          f"{work['box_tests']} leaf-box tests needed")
    k_ms = _cuda_ms(lambda: bs.cull(acc, f, lk), 20)
    p_ms = _cuda_ms(lambda: bs.cull_plain(acc, f, lk), 2)
    ops = work["sup_tests"] * OPS_PER_SUP + work["box_tests"] * OPS_PER_BOX
    nbytes = (acc.bounds.numel() + acc.sup.numel()) * 4 \
        + npad * (32 + 4 * acc.topk)
    rows.append(_row("bvh_serve_cull", "K2", "bvh_serve_cull.cu",
                     "mitsuba3_tpu/ops/bvh_serve.py:112", "cull", 0.0, k_ms,
                     p_ms, ops, nbytes, card, accel="serve", **work))

    # K3: the first block serve, after the sort by requested leaf
    fs, _, leaf_all, _, _ = bs.sort_requests(acc, f, i, pb, live)
    blk = bs.block_ids(acc, leaf_all)
    kt, kp, _, _, ks = bs.serve_blocks(acc, blk, fs, leaf_all)
    work = {}
    pt, pp, _, _, ps = bs.serve_blocks_plain(acc, blk, fs, leaf_all,
                                             stats=work)
    torch.cuda.synchronize()
    _check(torch.equal(ks, ps), "K3: served-rank bits differ")
    _check(torch.equal(kt >= bs.BIG, pt >= bs.BIG), "K3: hit sets differ")
    err, _ = _hold_t("K3", kt, pt, pt < bs.BIG, kp, pp)
    tests = work["tests"]
    k_ms = _cuda_ms(lambda: bs.serve_blocks(acc, blk, fs, leaf_all), 20)
    p_ms = _cuda_ms(lambda: bs.serve_blocks_plain(acc, blk, fs, leaf_all), 2)
    nbytes = (acc.tris.numel() * 4 + blk.numel() * 4
              + npad * (28 + 4 * acc.topk + 20))
    print(f"# K3: {int((ps != 0).sum())} rays served, {tests} ray-triangle "
          f"tests")
    rows.append(_row("bvh_serve_serve", "K3", "bvh_serve_serve.cu",
                     "mitsuba3_tpu/ops/bvh_serve.py:273", "serve", err, k_ms,
                     p_ms, tests * (OPS_PER_TEST + 1), nbytes, card,
                     accel="serve", tests=tests))
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
        kt, kp, _, _ = bt.run_round(*args, closest)
        work = {}
        pt, pp, _, _ = bt.run_round_plain(*args, closest, stats=work)
        torch.cuda.synchronize()
        _check(torch.equal(kp >= 0, pp >= 0), f"K4 {mode}: hit sets differ")
        hit = pp >= 0
        if closest:
            err, _ = _hold_t(f"K4 {mode}", kt, pt, hit, kp, pp)
            miss = ~hit
            _check(torch.equal(kt[miss], pt[miss]),
                   f"K4 {mode}: t differs where nothing was hit")
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


# accel -> (launch counters, profiler labels of its kernels)
def _accel_kernels(accel):
    from mitsuba3_tpu_torch.ops import bvh_serve, bvh_tiled, cellserve
    return {"cells": (cellserve.LAUNCHES, {"K1": "serve_kernel<"}),
            "serve": (bvh_serve.LAUNCHES, {"K2": "cull_kernel<",
                                           "K3": "serve_kernel<"}),
            "tiled": (bvh_tiled.LAUNCHES, {"K4": "mt_kernel<"})}[accel]


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
    out.update(_profile(mi, scene, wall, labels))
    del scene
    torch.cuda.empty_cache()
    return launches, out, img1


def _profile(mi, scene, wall_unprofiled: float, kernels: dict):
    """Device time by kernel over one render (torch.profiler); the idle
    share is taken against the unprofiled render's wall time too, since
    the profiler slows the host. `kernels` maps a label to the substring
    of the CUDA kernel names it sums."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mi.render_with_stats(scene, seed=2, spp=4, max_wavefront=1 << 20)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in events)
    busy = busy_us / 1e6
    print(f"# profile: device busy {busy:.4f} s; wall {wall:.3f} s "
          f"profiled (idle share {max(0.0, 1 - busy / wall):.3f}), "
          f"{wall_unprofiled:.3f} s unprofiled (idle share "
          f"{max(0.0, 1 - busy / wall_unprofiled):.3f})")
    groups = {label: [e for e in events if key in e.key]
              for label, key in kernels.items()}
    groups["other kernels"] = [e for e in events if not any(
        key in e.key for key in kernels.values())]
    for label, group in groups.items():
        print(f"# profile: {label}: "
              f"{sum(e.device_time_total for e in group) / 1e3:.2f} ms "
              f"device in {sum(e.count for e in group)} launches")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:12]:
        print(f"#   {e.device_time_total / 1e3:10.2f} ms  {e.count:7d}x  "
              f"{e.key[:90]}")
    return {"device_busy_s": busy, "profiled_wall_s": wall,
            "idle_share": max(0.0, 1 - busy / wall_unprofiled)}


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


def main():
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
          f"{torch.version.cuda}")
    print(smi)

    t0 = time.perf_counter()
    logs = native.build(native.SOURCES)
    print(f"# build: {len(native.SOURCES)} sources in "
          f"{time.perf_counter() - t0:.1f} s into {native.BUILD_DIR}")
    for src, log in logs.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                print(f"#   {src}: {ln.strip()}")

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"# phase {label}: {time.perf_counter() - t:.1f} s")
        return out

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

    for r in rows:
        counts = launches[r.pop("accel")]
        r["launches"] = counts[r["mode"]]
        r["card"] = card
    print(f"# chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"renders": renders, "card": card}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
