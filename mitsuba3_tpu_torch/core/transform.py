"""4x4 affine transforms — counterpart of ``mitsuba3_tpu/core/transform.py``.

Host-side NumPy (float64), used while a scene dict is lowered.
"""
from __future__ import annotations

import numpy as np


class Transform4f:
    """Immutable 4x4 transform with a chainable API (mi.ScalarTransform4f)."""

    def __init__(self, matrix=None, inverse=None):
        if matrix is None:
            matrix = np.eye(4)
        self.matrix = np.asarray(matrix, dtype=np.float64)
        if inverse is None:
            inverse = np.linalg.inv(self.matrix)
        self.inverse_matrix = np.asarray(inverse, dtype=np.float64)

    def __matmul__(self, other: "Transform4f") -> "Transform4f":
        return Transform4f(self.matrix @ other.matrix,
                           other.inverse_matrix @ self.inverse_matrix)

    def translate(self, v) -> "Transform4f":
        m = np.eye(4)
        m[:3, 3] = v
        inv = np.eye(4)
        inv[:3, 3] = -np.asarray(v, dtype=np.float64)
        return self @ Transform4f(m, inv)

    def scale(self, v) -> "Transform4f":
        v = np.atleast_1d(np.asarray(v, dtype=np.float64))
        if v.size == 1:
            v = np.repeat(v, 3)
        m = np.diag(np.concatenate([v, [1.0]]))
        inv = np.diag(np.concatenate([1.0 / v, [1.0]]))
        return self @ Transform4f(m, inv)

    def rotate(self, axis, angle_deg) -> "Transform4f":
        """Rotation about `axis` by `angle_deg` degrees (transform.h:rotate)."""
        axis = np.asarray(axis, dtype=np.float64)
        axis = axis / np.linalg.norm(axis)
        theta = np.deg2rad(angle_deg)
        s, c = np.sin(theta), np.cos(theta)
        x, y, z = axis
        k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
        r3 = c * np.eye(3) + s * k + (1 - c) * np.outer(axis, axis)
        m = np.eye(4)
        m[:3, :3] = r3
        return self @ Transform4f(m, m.T)

    def look_at(self, origin, target, up) -> "Transform4f":
        """Camera-to-world: X=left=cross(up,dir), Y=cross(dir,left), Z=dir
        (transform.h:175-200)."""
        origin = np.asarray(origin, dtype=np.float64)
        target = np.asarray(target, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)
        dir_ = target - origin
        dir_ = dir_ / np.linalg.norm(dir_)
        left = np.cross(up, dir_)
        left = left / np.linalg.norm(left)
        new_up = np.cross(dir_, left)
        m = np.eye(4)
        m[:3, 0] = left
        m[:3, 1] = new_up
        m[:3, 2] = dir_
        m[:3, 3] = origin
        return self @ Transform4f(m)

    def transform_point(self, p):
        p = np.asarray(p, dtype=np.float64)
        return p @ self.matrix[:3, :3].T + self.matrix[:3, 3]

    def transform_vector(self, v):
        v = np.asarray(v, dtype=np.float64)
        return v @ self.matrix[:3, :3].T

    def transform_normal(self, n):
        """Normals by the inverse transpose (not renormalised)."""
        n = np.asarray(n, dtype=np.float64)
        return n @ self.inverse_matrix[:3, :3]

    def inverse(self) -> "Transform4f":
        return Transform4f(self.inverse_matrix, self.matrix)


def as_transform(spec) -> Transform4f:
    """A Transform4f from anything carrying a 4x4 ``matrix`` (any package's
    transform class) or from a 4x4 array."""
    if isinstance(spec, Transform4f):
        return spec
    if hasattr(spec, "matrix"):
        return Transform4f(np.asarray(spec.matrix, np.float64))
    arr = np.asarray(spec, dtype=np.float64)
    if arr.shape == (4, 4):
        return Transform4f(arr)
    raise ValueError(f"Cannot interpret transform spec: {spec!r}")
