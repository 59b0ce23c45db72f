"""LargeSteps mesh-optimisation preconditioner — counterpart of
``mitsuba3_tpu/ad/largesteps.py`` (Nicolet et al. 2021,
src/python/python/ad/largesteps.py).

Vertex positions v are reparametrised as differential coordinates
u = (I + λL) v, with L a uniform or cotangent Laplacian kept as COO
arrays (a matvec is a gather and an ``index_add_``, where JAX uses
``segment_sum``). ``from_differential`` solves (I + λL) v = u by
conjugate gradients inside a ``torch.autograd.Function`` whose backward
is the same solve on the cotangent, since the system is symmetric
positive definite.

The solve is JAX's ``jax.scipy.sparse.linalg.cg`` on the whole [n, 3]
block as one vector: its dot products run over all 3n entries and it
stops once ‖r‖² ≤ tol²·‖b‖², or after ``cg_iters`` iterations. Each
iteration updates only while that test says to go on, so the host reads
the test every CHECK_EVERY iterations (one sync each) and the result is
the one an every-iteration check gives.
"""
from __future__ import annotations

import numpy as np
import torch

from ..loader import resolve_device

CHECK_EVERY = 8


def mesh_laplacian(vertices: np.ndarray, faces: np.ndarray,
                   method: str = "uniform"):
    """The combinatorial or cotangent Laplacian L = D - W of a triangle
    mesh as COO arrays (rows, cols, vals); host-side NumPy, once at
    set-up, with the JAX package's arithmetic."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    i0, i1, i2 = f[:, 0], f[:, 1], f[:, 2]

    if method == "uniform":
        rows = np.concatenate([i0, i1, i1, i2, i2, i0])
        cols = np.concatenate([i1, i0, i2, i1, i0, i2])
        vals = np.ones(rows.shape[0], np.float64)
    elif method == "cotan":
        def cot(a, b, c):
            # cotangent of the angle at vertex a (opposite edge b-c)
            u = v[b] - v[a]
            w = v[c] - v[a]
            cross = np.linalg.norm(np.cross(u, w), axis=-1)
            return (u * w).sum(-1) / np.maximum(cross, 1e-12)

        c0 = cot(i0, i1, i2)  # weight of edge (i1, i2)
        c1 = cot(i1, i2, i0)  # weight of edge (i2, i0)
        c2 = cot(i2, i0, i1)  # weight of edge (i0, i1)
        rows = np.concatenate([i1, i2, i2, i0, i0, i1])
        cols = np.concatenate([i2, i1, i0, i2, i1, i0])
        vals = 0.5 * np.concatenate([c0, c0, c1, c1, c2, c2])
        vals = np.maximum(vals, 0.0)  # clamp negative cotans for PSD
    else:
        raise ValueError(f"Unknown Laplacian type {method!r}")

    # accumulate duplicate edges
    n = v.shape[0]
    key = rows * n + cols
    order = np.argsort(key)
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    uniq, start = np.unique(key, return_index=True)
    w_sum = np.add.reduceat(vals, start)
    rows = (uniq // n).astype(np.int32)
    cols = (uniq % n).astype(np.int32)
    return rows, cols, w_sum.astype(np.float32)


class LargeSteps:
    """Usage (the reference API, largesteps.py:69)::

        ls = LargeSteps(verts, faces, lambda_=19.0, method="cotan")
        u = ls.to_differential(verts)        # optimise u
        verts = ls.from_differential(u)      # differentiable solve

    The tables live on `vertices`' device when it is a tensor, else on
    `device` (the card unless the caller passes ``"cpu"``).
    ``cg_iterations`` holds the iteration count of the latest solve,
    forward or backward."""

    def __init__(self, vertices, faces, lambda_: float = 19.0,
                 method: str = "uniform", cg_iters: int = 200,
                 cg_tol: float = 1e-6, device=None):
        if isinstance(vertices, torch.Tensor):
            dev = vertices.device
            vertices = vertices.detach().cpu().numpy()
        else:
            dev = resolve_device(device)
        faces = (faces.cpu().numpy() if isinstance(faces, torch.Tensor)
                 else np.asarray(faces))
        rows, cols, vals = mesh_laplacian(vertices, faces, method)
        n = np.asarray(vertices).shape[0]
        deg = np.zeros(n, np.float32)
        np.add.at(deg, rows, vals)
        self.rows = torch.as_tensor(rows.astype(np.int64), device=dev)
        self.cols = torch.as_tensor(cols.astype(np.int64), device=dev)
        self.vals = torch.as_tensor(vals, device=dev)
        self.deg = torch.as_tensor(deg, device=dev)
        self.n = n
        self.device = dev
        self.lambda_ = float(lambda_)
        self.cg_iters = int(cg_iters)
        self.cg_tol = float(cg_tol)
        self.cg_iterations = 0

    def matvec(self, x):
        """(I + λL) x for x of shape [n, k]."""
        lx = self.deg[:, None] * x - torch.zeros_like(x).index_add_(
            0, self.rows, self.vals[:, None] * x[self.cols])
        return x + self.lambda_ * lx

    def to_differential(self, v):
        return self.matvec(self._as_block(v))

    def from_differential(self, u):
        return _Solve.apply(self, self._as_block(u))

    def _as_block(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def solve(self, b):
        """x = (I + λL)^-1 b by CG on the whole block from x = 0 (no
        autograd; ``from_differential`` is the differentiable form)."""
        with torch.no_grad():
            atol2 = torch.clamp(self.cg_tol ** 2 * (b * b).sum(), min=0.0)
            x = torch.zeros_like(b)
            r = b - self.matvec(x)
            p = r
            gamma = (r * r).sum()
            k = torch.zeros((), dtype=torch.int64, device=b.device)
            for i in range(self.cg_iters):
                go = gamma > atol2
                if i % CHECK_EVERY == 0 and not bool(go):
                    break
                ap = self.matvec(p)
                alpha = gamma / (p * ap).sum()
                x_new = x + alpha * p
                r_new = r - alpha * ap
                gamma_new = (r_new * r_new).sum()
                p_new = r_new + (gamma_new / gamma) * p
                x = torch.where(go, x_new, x)
                r = torch.where(go, r_new, r)
                p = torch.where(go, p_new, p)
                gamma = torch.where(go, gamma_new, gamma)
                k = k + go.to(torch.int64)
            self.cg_iterations = int(k)
        return x


class _Solve(torch.autograd.Function):
    """x = A^-1 b; A is SPD, so the adjoint is the same solve on the
    cotangent (largesteps.py:50 SolveCholesky's backward)."""

    @staticmethod
    def forward(ctx, ls: LargeSteps, b):
        ctx.ls = ls
        return ls.solve(b)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ls.solve(g.contiguous())
