"""The SAH BVH builder — counterpart of ``mitsuba3_tpu/native``.

``build_bvh`` calls the port's copy of the JAX package's C++ builder
(``csrc/bvh_build.cpp``), compiled by ``ops/native.py`` with the same g++
flags into ``build/kernels/``, so its output is bit-equal to
``mitsuba3_tpu.native.build_bvh``. ``build_bvh_numpy`` is a copy of the
JAX package's median-split builder with the same contract; the accels
never fall back to it.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..ops import native as _native

SOURCE = "bvh_build.cpp"


def _lib():
    lib = _native.load(SOURCE)
    if lib.mi_build_bvh.restype is not ctypes.c_int:
        lib.mi_build_bvh.restype = ctypes.c_int
    return lib


def build_bvh(bbmin: np.ndarray, bbmax: np.ndarray, leaf_size: int):
    """Binned-SAH BVH over primitive bounds.

    Returns (prim_order [n] int32 DFS-leaf permutation,
             node_bounds [n_nodes, 6] f32,
             node_meta [n_nodes, 2] int32 ((~leaf, count) at leaves),
             leaf_first [n_leaves] int32 (offset into prim_order),
             leaf_count [n_leaves] int32).
    """
    n = bbmin.shape[0]
    bbmin = np.ascontiguousarray(bbmin, np.float32)
    bbmax = np.ascontiguousarray(bbmax, np.float32)
    max_nodes = 4 * n + 8
    prim_order = np.full(n, -1, np.int32)
    node_bounds = np.zeros((max_nodes, 6), np.float32)
    node_meta = np.zeros((max_nodes, 2), np.int32)
    leaf_first = np.zeros(2 * n + 2, np.int32)
    leaf_count = np.zeros(2 * n + 2, np.int32)
    n_leaves = ctypes.c_int(0)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    nn = _lib().mi_build_bvh(
        bbmin.ctypes.data_as(fp), bbmax.ctypes.data_as(fp),
        ctypes.c_int(n), ctypes.c_int(leaf_size),
        prim_order.ctypes.data_as(ip), node_bounds.ctypes.data_as(fp),
        node_meta.ctypes.data_as(ip), leaf_first.ctypes.data_as(ip),
        leaf_count.ctypes.data_as(ip), ctypes.byref(n_leaves))
    if nn < 0:
        raise RuntimeError("mi_build_bvh failed")
    nl = n_leaves.value
    return (prim_order, node_bounds[:nn].copy(), node_meta[:nn].copy(),
            leaf_first[:nl].copy(), leaf_count[:nl].copy())


def build_bvh_numpy(bbmin: np.ndarray, bbmax: np.ndarray, leaf_size: int):
    """Pure-NumPy median-split builder (same output contract)."""
    centroid = 0.5 * (bbmin + bbmax)
    node_bounds, node_meta = [], []
    leaf_first, leaf_count = [], []
    order = []

    def rec(ids):
        node = len(node_bounds)
        node_bounds.append(np.concatenate([bbmin[ids].min(0),
                                           bbmax[ids].max(0)]))
        node_meta.append([0, 0])
        if len(ids) <= leaf_size:
            leaf = len(leaf_first)
            leaf_first.append(len(order))
            leaf_count.append(len(ids))
            order.extend(ids.tolist())
            node_meta[node] = [~leaf, len(ids)]
            return node
        c = centroid[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        srt = np.argsort(c[:, axis], kind="stable")
        mid = len(ids) // 2
        left = rec(ids[srt[:mid]])
        right = rec(ids[srt[mid:]])
        node_meta[node] = [left, right]
        return node

    rec(np.arange(bbmin.shape[0]))
    return (np.asarray(order, np.int32),
            np.asarray(node_bounds, np.float32),
            np.asarray(node_meta, np.int32),
            np.asarray(leaf_first, np.int32),
            np.asarray(leaf_count, np.int32))
