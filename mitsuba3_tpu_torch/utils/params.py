"""SceneParameters / traverse — counterpart of ``mitsuba3_tpu/utils/params.py``
(mi.traverse / SceneParameters, src/python/python/util.py:10-272).

A dict-like view of a Scene's differentiable tables under the JAX
package's keys, with ``set_dirty`` batching. ``update()`` applies the
pending writes, rebuilds the state derived from them (the environment's
sampling tables after an ``env_data`` edit; the area-emitter tables and
the accel over the queried faces and each prototype's cellserve after a
``vertices`` edit, as Scene::parameters_changed does;
the BSDF dispatch's texture and type tables after a ``bsdf_params`` edit;
the textures the projector rows name after a ``de_params`` edit;
the majorant of the medium rows that own a density grid after a grid
edit, heterogeneous.cpp:178; a new grid tensor gets a new cell table on
its first lookup) and returns a new Scene; the Scene it started from is
left as it was. A sphere emitter's cone row (``em_sphere``) stays as
loaded after a ``vertices`` edit, as in the JAX package.

The accel is geometry, not a parameter: it is rebuilt on the host from
the vertices' values (``.detach().cpu()``), while gradients still reach
``vertices`` through the render (``ad/prb.py`` re-attaches hits to θ).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import bsdfs
from .. import emitters as em_pkg
from ..emitters import envmap as env_mod
from ..ops import bvh_serve, bvh_tiled, bvh_xla, cellserve
from ..ops import grid as grid_mod
from ..render.scene import HybridAccel, reached_slots


class SceneParameters:
    """Mutable view; ``.scene()`` (or ``.update()``) makes the Scene."""

    def __init__(self, scene):
        self._scene = scene
        self._dirty = set()
        self._values = {
            "vertices": scene.vertices,
            "em_radiance": scene.em_radiance,
            "bsdf_params": scene.bsdf_params,
            "env_data": scene.env_data,
            "env_scale": scene.env_scale,
            "sensor.to_world.origin": scene.sensor.origin,
        }
        if scene.medium_params is not None and scene.medium_params.shape[0]:
            self._values["medium_params"] = scene.medium_params
            for i, grid in enumerate(scene.medium_grids):
                self._values[f"medium{i}.density.data"] = grid
        if scene.de_params is not None:
            self._values["de_params"] = scene.de_params
        for i, tex in enumerate(scene.textures):
            self._values[f"texture{i}.data"] = tex

    # -- mapping protocol -------------------------------------------------
    def keys(self):
        return self._values.keys()

    def items(self):
        return self._values.items()

    def __contains__(self, k):
        return k in self._values

    def __getitem__(self, k):
        return self._values[k]

    def __setitem__(self, k, v):
        """Write a value (kept on the table's device and dtype; a tensor
        keeps its autograd history) and mark the key dirty."""
        if k not in self._values:
            raise KeyError(k)
        old = self._values[k]
        self._values[k] = torch.as_tensor(v, dtype=old.dtype,
                                          device=old.device)
        self._dirty.add(k)

    def set_dirty(self, k):
        self._dirty.add(k)

    def update(self, values=None):
        """Apply pending writes and refresh derived state
        (parameters_changed() analog). Returns the new Scene."""
        if values:
            for k, v in values.items():
                self[k] = v
        s = self._scene
        tex = list(s.textures)
        # grids after the medium rows: a grid edit re-derives its row's
        # majorant from the rows as they end up (JAX's order is the set's)
        for k in sorted(self._dirty, key=_is_grid):
            v = self._values[k]
            if k == "vertices":
                s = _rebuild_geometry_derived(s.replace(vertices=v))
            elif k == "env_data":
                s = _rebuild_env_tables(s.replace(env_data=v))
            elif k == "bsdf_params":
                s = _rebuild_dispatch_tables(s.replace(bsdf_params=v))
            elif k == "sensor.to_world.origin":
                s = s.replace(sensor=s.sensor.replace(origin=v))
            elif k.startswith("texture"):
                tex[int(k[len("texture"):].split(".")[0])] = v
                s = s.replace(textures=tuple(tex))
            elif _is_grid(k):
                s = _replace_grid(s, int(k[len("medium"):].split(".")[0]), v)
            elif k == "de_params":
                s = s.replace(de_params=v, projector_textures=(
                    em_pkg.projector_textures(s.delta_emitter_types,
                                              v.detach().cpu().numpy())))
            else:   # em_radiance, env_scale, medium_params
                s = s.replace(**{k: v})
        self._dirty.clear()
        self._scene = s
        return s

    def scene(self):
        return self.update()


def _is_grid(key: str) -> bool:
    return key.startswith("medium") and key != "medium_params"


def _replace_grid(scene, idx: int, grid):
    """Density grid `idx` replaced, and the majorant bound [8] re-derived
    on every medium row that owns grid slot idx + 1 (row order need not
    follow grid order), with the JAX package's host arithmetic."""
    grids = list(scene.medium_grids)
    grids[idx] = grid
    mp = scene.medium_params.detach().cpu().numpy().copy()
    g_max = float(grid.detach().max())
    for row in np.where(np.round(mp[:, 9]).astype(int) == idx + 1)[0]:
        mp[row, 8] = mp[row, 6] * g_max * float(mp[row, 0:3].max())
    return scene.replace(medium_grids=tuple(grids),
                         medium_params=torch.as_tensor(
                             mp, device=scene.medium_params.device))


def _rebuild_dispatch_tables(scene):
    """Refresh the textures each BSDF type's rows name and the types each
    dispatch can meet after a ``bsdf_params`` edit, which may point a row
    at another texture or an adapter at another nested slot."""
    def host(x):
        return None if x is None else x.detach().cpu().numpy()
    return scene.replace(**bsdfs.dispatch_tables(
        scene.bsdf_types, host(scene.bsdf_params), reached_slots(
            host(scene.face_bsdf), host(scene.face_shape),
            host(scene.analytic_prims), host(scene.sdf_rows))))


def _rebuild_env_tables(scene):
    """Refresh the environment's importance-sampling tables after radiance
    edits (envmap.cpp parameters_changed)."""
    if scene.env_emitter < 0:
        return scene
    return scene.replace(env_warp=env_mod.build_tables(
        scene.env_data.detach().cpu().numpy(), scene.device))


def _rebuild_geometry_derived(scene):
    """Refresh the area-emitter tables and the accel after vertex edits
    (Scene::parameters_changed's accel rebuild, scene.cpp:503-563), with
    the JAX package's host arithmetic, so the tables and the accel equal
    its own bit for bit."""
    dev = scene.device
    v = scene.vertices.detach().cpu().numpy()
    f = scene.faces.cpu().numpy()
    p = v[f]
    areas = 0.5 * np.linalg.norm(
        np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]), axis=-1)
    fe = scene.face_emitter.cpu().numpy()
    inv_total = np.zeros_like(areas, dtype=np.float32)
    ef_face = scene.ef_face.cpu().numpy()
    updates = {}
    if ef_face.size:
        e_total = max(scene.n_emitters, 1)
        pmfs = np.zeros(ef_face.shape[0], np.float64)
        for e in np.unique(fe[fe >= 0]):
            mask = fe == e
            total = float(areas[mask].sum())
            inv_total[mask] = 1.0 / max(total, 1e-30)
            sel = np.isin(ef_face, np.where(mask)[0])
            pmfs[sel] = areas[ef_face[sel]] / max(total, 1e-30) / e_total
        updates["ef_cdf"] = torch.as_tensor(
            np.cumsum(pmfs).astype(np.float32), device=dev)
    updates["face_inv_total_area"] = torch.as_tensor(inv_total, device=dev)
    acc = scene.accel
    if acc is not None:
        # the loader's accel type again, over the queried faces only:
        # scene queries dispatch on it
        nq = scene.n_query_faces or p.shape[0]
        p0 = p[:nq, 0]
        e1 = p[:nq, 1] - p0
        e2 = p[:nq, 2] - p0
        if isinstance(acc, HybridAccel):
            # as JAX rebuilds a hybrid: the grid's closest hits and
            # bvh_tiled's any-hit
            acc = HybridAccel(closest=grid_mod.build(p0, e1, e2, device=dev),
                              anyhit=bvh_tiled.build(p0, e1, e2,
                                                     device=dev))
        elif isinstance(acc, cellserve.CellServe):
            acc = cellserve.build(p0, e1, e2, pair_slots=acc.pair_slots,
                                  device=dev)
        else:
            acc = {bvh_serve.BVHServe: bvh_serve.build,
                   bvh_tiled.BVHTiled: bvh_tiled.build,
                   bvh_xla.BVHXLA: bvh_xla.build,
                   grid_mod.GridAccel: grid_mod.build}[type(acc)](
                p0, e1, e2, device=dev)
        updates["accel"] = acc
    if scene.proto_accels:
        # prototype faces may share edited vertices: each prototype's
        # cellserve again
        updates["proto_accels"] = tuple(
            None if pa is None else cellserve.build(
                p[b:b + c, 0], p[b:b + c, 1] - p[b:b + c, 0],
                p[b:b + c, 2] - p[b:b + c, 0], device=dev)
            for pa, (b, c) in zip(scene.proto_accels, scene.proto_ranges))
    return scene.replace(**updates)


def traverse(scene) -> SceneParameters:
    """mi.traverse analog."""
    return SceneParameters(scene)
