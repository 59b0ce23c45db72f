"""Scene: flat SoA tables + dispatch hub — counterpart of
``mitsuba3_tpu/render/scene.py`` (the parts a triangle scene with the
port's BSDFs and textures, area lights (cone-sampled on spheres,
directionalarea), point, spot, directional and projector lights, an
environment map and participating media reaches).

The JAX Scene's static fields are plain fields here; the per-face
attribute table is built once from the leaves when the Scene is made. A
scene with media adds the faces' (interior, exterior) medium columns to
it; -2 (``NO_TRANSITION``) marks a face whose crossing keeps the medium.

Implicit geometry is merged after the accel's hit, as in JAX: instances
(``render/instancing.py``; their prototype faces live past
``n_query_faces`` in prototype space), then the analytic rows
(``ops/analytic.py``; prim F + row), then each SDF grid
(``ops/sdf.py``; prim F + A + k), F counting every face. An analytic or
SDF lane reads its mip LOD (``duv_scale``) and vertex color from the
clamped last face, as JAX does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from .. import emitters as em_pkg
from ..core import math as m
from ..core import spectral
from ..core import warp
from ..core.distr import pick
from ..core.frame import Frame
from ..core.gather import take_rows
from ..core.struct import struct
from ..core.vec import Vec2, Vec3
from ..emitters import envmap as env_mod
from ..ops import analytic, bvh_serve, bvh_tiled, bvh_xla, cellserve
from ..ops import grid as grid_mod
from ..ops import intersect as ops_intersect
from ..ops import sdf as sdf_mod
from ..render.film import FilmConfig
from ..sensors import SensorConfig, SensorData
from . import instancing
from . import texture as tex_mod
from .records import (DirectionSample, PreliminaryIntersection, Ray,
                      SurfaceInteraction)

TRI_CHUNK = 256  # large-scene face padding granularity
TRI_PAD = 8      # small-scene face padding granularity
FAR = 1e7        # distance standing in for "at infinity"

# per-face attribute table columns (gather_face_attrs rows)
A_P0, A_E1, A_E2 = 0, 3, 6       # xyz each
A_UV = 9                         # uv0, uv1, uv2
A_INV_AREA, A_EMITTER, A_BSDF, A_SHAPE = 15, 16, 17, 18
A_NS = 19                        # per-corner shading normals, 9 columns
A_MED = 28                       # interior, exterior medium (with media)
# then the per-corner vertex colors, 9 columns (Scene.a_vc)


# accel type -> its (closest, any-hit) queries, each taking (accel, o, d,
# maxt, active)
ACCEL_QUERIES = {
    cellserve.CellServe: (cellserve.intersect_cells,
                          cellserve.occluded_cells),
    bvh_serve.BVHServe: (bvh_serve.intersect_bvh, bvh_serve.occluded_bvh),
    bvh_tiled.BVHTiled: (bvh_tiled.intersect_bvh, bvh_tiled.occluded_bvh),
    bvh_xla.BVHXLA: (bvh_xla.intersect_bvh, bvh_xla.occluded_bvh),
    grid_mod.GridAccel: (grid_mod.intersect_grid, grid_mod.occluded_grid),
}


@struct
class HybridAccel:
    """Closest-hit and any-hit queries on two structures (JAX's
    HybridAccel): the DDA grid's closest hits with bvh_tiled's any-hit
    rounds (kernel K4), as ``update()`` rebuilds them, or any two of the
    accels of ACCEL_QUERIES."""
    closest: Any = None
    anyhit: Any = None


def reached_slots(face_bsdf, face_shape, analytic_prims=None,
                  sdf_rows=None):
    """The BSDF slots a hit can name (numpy): the faces' but padding's
    (face_shape -1), the analytic rows' and the SDF rows'."""
    slots = [np.asarray(face_bsdf)[np.asarray(face_shape) >= 0]]
    for rows, col in ((analytic_prims, 16), (sdf_rows, 14)):
        if rows is not None:
            slots.append(np.round(np.asarray(rows)[:, col]).astype(np.int32))
    return np.concatenate(slots)


def _soa(p):
    """(p0, e1, e2) as Vec3 of [F] from corner positions [F, 3, 3]."""
    p0 = Vec3(p[:, 0, 0], p[:, 0, 1], p[:, 0, 2])
    p1 = Vec3(p[:, 1, 0], p[:, 1, 1], p[:, 1, 2])
    p2 = Vec3(p[:, 2, 0], p[:, 2, 1], p[:, 2, 2])
    return p0, p1 - p0, p2 - p0


@struct
class _RefPoint:
    """A reference point of NEE from a medium vertex (or of a delta
    emitter's re-evaluation); `t` gives the lane count, `wavelengths` the
    path's (spectral variant)."""
    p: Vec3
    t: torch.Tensor
    wavelengths: Vec3 | None = None


@struct
class Scene:
    # geometry (world space)
    vertices: torch.Tensor            # [V, 3] f32
    faces: torch.Tensor               # [F, 3] i32 (F padded)
    face_shape: torch.Tensor          # [F] i32, -1 on padding
    face_bsdf: torch.Tensor           # [F] i32 bsdf slot
    face_emitter: torch.Tensor        # [F] i32 emitter index or -1
    face_inv_total_area: torch.Tensor  # [F] f32
    face_uv: torch.Tensor             # [F, 3, 2]
    face_normals: torch.Tensor        # [F, 3, 3]; zeros = flat shading
    # emitters
    em_radiance: torch.Tensor         # [E, 3]
    ef_face: torch.Tensor             # [FE] i32 emissive face ids
    ef_cdf: torch.Tensor              # [FE] global CDF, ends at n_area / E
    env_data: torch.Tensor            # [He, We, 3]
    env_warp: Any                     # SlicedMarginal2D (S = 1)
    env_scale: torch.Tensor           # scalar
    de_params: torch.Tensor | None    # [D, 20] delta emitter rows
    # BSDFs, sensor, accel
    bsdf_params: torch.Tensor         # [B, N_PARAMS]
    sensor: SensorData | tuple        # a batch sensor: one per sub-sensor
    # an accel of ACCEL_QUERIES or a HybridAccel; None: the dense
    # all-triangles test (scenes of at most 8192 faces, or MI3T_ACCEL=none)
    accel: Any
    # derived from bsdf_params by bsdfs.dispatch_tables (update() redoes it):
    # (BSDF module name, texture ids its rows hold) and the BSDF types each
    # dispatch can meet
    bsdf_textures: tuple
    bsdf_reach: tuple
    textures: tuple = ()              # [Hi, Wi, 3] each (a volume's
    #                                   [D, H, W, 3]), differentiable
    texture_mips: tuple = ()          # per texture: a tuple of levels
    # measured BSDF tables (bsdfs/measured.py): per table a dict of
    # tensors and the two SlicedMarginal2D warps "lum" and "vndf"
    measured_tables: tuple = ()
    face_colors: torch.Tensor | None = None  # [F, 3, 3]; None: no mesh
    #                                   carries vertex colors
    # participating media (media/, phase/)
    medium_params: torch.Tensor | None = None  # [M, N_MPARAMS]
    medium_grids: tuple = ()          # [D, H, W] density grids
    phase_tables: tuple = ()          # [K] tabulated phase pdfs
    medium_to_grid: torch.Tensor | None = None  # [M, 3, 4] world->grid
    face_medium: torch.Tensor | None = None    # [F, 2] (interior,
    #                                   exterior), -1 vacuum, -2 no change
    medium_types: tuple = ()
    phase_types: tuple = ()
    sensor_medium: int = -1           # the camera rays' medium
    # sphere area emitters: (cx, cy, cz, r) per area emitter (r = 0 for
    # the others), None without one; NEE cone-samples those slots
    em_sphere: torch.Tensor | None = None
    em_sphere_slots: tuple = ()
    em_directional: tuple = ()        # directionalarea emitter slots
    # texture ids (k + 1) the projector rows of de_params name
    # (emitters.projector_textures; update() redoes it)
    projector_textures: tuple = ()
    # implicit geometry: analytic rows [A, analytic.N_COLS], SDF grids
    # [D, H, W] with their rows [S, sdf.SDF_COLS]; instances and, per
    # prototype, its (base, count) face range and its accel (None: dense)
    analytic_prims: torch.Tensor | None = None
    sdf_grids: tuple = ()
    sdf_rows: torch.Tensor | None = None
    instances: instancing.InstanceTable | None = None
    proto_accels: tuple = ()
    proto_ranges: tuple = ()
    n_query_faces: int = 0            # 0: every face is queried directly
    # the spectral variant: sampled-spectrum emitters' SPDs [E, SPD_N]
    # (rows of the slots em_spd_slots), sampled-spectrum reflectances'
    # [S, SPD_N] (texture id -(k + 2) names row k)
    em_spd: torch.Tensor | None = None
    bsdf_spd: torch.Tensor | None = None
    em_spd_slots: tuple = ()
    spectral: bool = False            # hero-wavelength transport
    # static configuration
    n_emitters: int = 0
    n_area_emitters: int = 0
    env_emitter: int = -1
    delta_emitter_types: tuple = ()
    bsdf_types: tuple = ()
    bsdf_flags: tuple = ()
    texture_meta: tuple = ()          # per texture: (wrap, filter, mipmap,
    #                                   uv transform or world->local 3x4)
    adapter_max_depth: int = 1        # longest adapter chain (mask, blend)
    film: FilmConfig = dataclasses.field(default_factory=FilmConfig)
    sensor_config: SensorConfig = dataclasses.field(
        default_factory=SensorConfig)
    integrator: Any = None
    spp: int = 64
    sampler_type: str = "independent"
    face_table: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.face_table = self._face_table()

    @property
    def has_media(self) -> bool:
        return len(self.medium_types) > 0

    @property
    def a_vc(self) -> int:
        """First vertex-color column of the face table."""
        return A_MED + 2 if self.has_media else A_MED

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    # ------------------------------------------------------------------
    # Geometry access
    # ------------------------------------------------------------------

    def triangle_soa(self, query_only: bool = True):
        """(p0, e1, e2) as Vec3 of [F]; padding faces are degenerate. With
        query_only (the intersector's view) the prototype faces past
        n_query_faces are left out: instances reach them."""
        f = (self.faces[:self.n_query_faces]
             if query_only and self.n_query_faces else self.faces)
        return _soa(self.vertices[f.long()])

    def proto_soa(self, p: int):
        """(p0, e1, e2) of prototype p's faces, in prototype space."""
        base, count = self.proto_ranges[p]
        return _soa(self.vertices[self.faces[base:base + count].long()])

    def _face_table(self):
        """[F, 28] per-face attribute rows (columns A_*; int columns as
        exact f32), then a scene with media's two medium columns and the
        vertex colors' nine."""
        p0, e1, e2 = self.triangle_soa(query_only=False)
        uv = self.face_uv
        ns = self.face_normals
        cols = [p0.x, p0.y, p0.z, e1.x, e1.y, e1.z, e2.x, e2.y, e2.z,
                uv[:, 0, 0], uv[:, 0, 1], uv[:, 1, 0], uv[:, 1, 1],
                uv[:, 2, 0], uv[:, 2, 1],
                self.face_inv_total_area,
                self.face_emitter.to(torch.float32),
                self.face_bsdf.to(torch.float32),
                self.face_shape.to(torch.float32)]
        cols += [ns[:, i, j] for i in range(3) for j in range(3)]
        if self.has_media:
            fm = (self.face_medium.to(torch.float32)
                  if self.face_medium is not None
                  else torch.full((p0.x.shape[0], 2), -1.0,
                                  device=p0.x.device))
            cols += [fm[:, 0], fm[:, 1]]
        if self.face_colors is not None:
            vc = self.face_colors
            cols += [vc[:, i, j] for i in range(3) for j in range(3)]
        return torch.stack(cols, dim=1)

    def gather_face_attrs(self, prim):
        """Per-lane face attributes as SoA rows [K, N] (one row take per
        lane)."""
        return take_rows(self.face_table, prim).T

    # ------------------------------------------------------------------
    # Intersection
    # ------------------------------------------------------------------

    def _queries(self):
        """(closest, any-hit) queries of the scene's accel, each taking
        (o, d, maxt, active): a HybridAccel's closest side for the one and
        its any-hit side for the other; the dense test over every
        triangle, in TRI_CHUNK chunks, without an accel."""
        if self.accel is None:
            tris = self.triangle_soa()

            def closest(o, d, maxt, active=None):
                return ops_intersect.intersect_naive(
                    o, d, maxt, *tris, active=active, chunk=TRI_CHUNK)

            def anyhit(o, d, maxt, active=None):
                return ops_intersect.occluded_naive(
                    o, d, maxt, *tris, active=active, chunk=TRI_CHUNK)
            return closest, anyhit
        acc_c, acc_a = ((self.accel.closest, self.accel.anyhit)
                        if isinstance(self.accel, HybridAccel)
                        else (self.accel, self.accel))
        return (functools.partial(ACCEL_QUERIES[type(acc_c)][0], acc_c),
                functools.partial(ACCEL_QUERIES[type(acc_a)][1], acc_a))

    @property
    def n_analytic(self) -> int:
        return (0 if self.analytic_prims is None
                else self.analytic_prims.shape[0])

    def ray_intersect_preliminary(self, ray: Ray, active=None):
        t, prim, uv, valid = self._queries()[0](ray.o, ray.d, ray.maxt,
                                                active=active)
        inst_idx = None
        if self.instances is not None:
            ti, pri, uvi, ii, vi = instancing.intersect_instances(
                self, ray.o, ray.d, ray.maxt,
                torch.ones_like(valid) if active is None else active)
            better = vi & (~valid | (ti < t))
            t = torch.where(better, ti, t)
            prim = torch.where(better, pri, prim)
            uv = Vec2(torch.where(better, uvi.x, uv.x),
                      torch.where(better, uvi.y, uv.y))
            valid = valid | better
            prim = torch.where(valid, prim, -1)
            inst_idx = torch.where(better, ii, -1)
        f_count = self.faces.shape[0]
        merges = []
        if self.n_analytic:
            # the table and the rays go in detached, as the triangle query's
            # do: the hit's t and uv carry no gradient, and surface_fields
            # re-attaches p and n to the rows (ROADMAP queue 3)
            o_det = Vec3(ray.o.x.detach(), ray.o.y.detach(), ray.o.z.detach())
            d_det = Vec3(ray.d.x.detach(), ray.d.y.detach(), ray.d.z.detach())
            merges.append((f_count, lambda cap: analytic.intersect_analytic(
                self.analytic_prims.detach(), o_det, d_det, cap.detach(),
                active=active)))
        for k, grid in enumerate(self.sdf_grids):
            def sdf_hit(cap, k=k, grid=grid):
                ts, ux, uy, vs = sdf_mod.intersect_sdf(
                    grid, self.sdf_rows[k].detach(), ray.o, ray.d, cap,
                    active=active)
                return ts, 0, Vec2(ux, uy), vs
            merges.append((f_count + self.n_analytic + k, sdf_hit))
        for base, query in merges:
            # each is capped at the hit so far and wins on a smaller t only
            ta, aidx, uva, va = query(torch.where(valid, t, ray.maxt))
            better = va & (~valid | (ta < t))
            t = torch.where(better, ta, t)
            prim = torch.where(better, base + aidx, prim)
            uv = Vec2(torch.where(better, uva.x, uv.x),
                      torch.where(better, uva.y, uv.y))
            valid = valid | better
            if inst_idx is not None:
                inst_idx = torch.where(better, -1, inst_idx)
        if merges:
            prim = torch.where(valid, prim, -1)
        return PreliminaryIntersection(
            t=t, prim_uv=uv, prim_index=prim,
            shape_index=torch.where(valid, prim, -1),
            instance_index=inst_idx)

    def ray_test(self, ray: Ray, active=None):
        occ = self._queries()[1](ray.o, ray.d, ray.maxt, active=active)
        if self.instances is not None:
            act = (torch.ones_like(occ) if active is None else active) & ~occ
            occ = occ | instancing.occluded_instances(
                self, ray.o, ray.d, ray.maxt, act)
        if self.n_analytic:
            occ = occ | analytic.intersect_analytic(
                self.analytic_prims.detach(), ray.o, ray.d, ray.maxt,
                active=active)[3]
        for k, grid in enumerate(self.sdf_grids):
            occ = occ | sdf_mod.intersect_sdf(
                grid, self.sdf_rows[k].detach(), ray.o, ray.d, ray.maxt,
                active=active)[3]
        return occ

    def compute_surface_interaction(self, ray: Ray,
                                    pi: PreliminaryIntersection):
        """Hit recomputation from barycentrics + per-face attribute fetch.
        Returns (si, attrs) with attrs 'bsdf', 'emitter' (i32 [N]) and
        'inv_total_area' (f32 [N])."""
        prim = torch.clamp(pi.prim_index, 0, self.faces.shape[0] - 1)
        a = self.gather_face_attrs(prim)
        tp0 = Vec3(a[A_P0], a[A_P0 + 1], a[A_P0 + 2])
        te1 = Vec3(a[A_E1], a[A_E1 + 1], a[A_E1 + 2])
        te2 = Vec3(a[A_E2], a[A_E2 + 1], a[A_E2 + 2])
        b1 = pi.prim_uv.x
        b2 = pi.prim_uv.y
        p = tp0 + te1 * b1 + te2 * b2
        ng = te1.cross(te2).normalize()
        # shading normal: barycentric vertex-normal interpolation; all-zero
        # corner normals mean flat shading
        w0 = 1.0 - b1 - b2
        n0, n1, n2 = A_NS, A_NS + 3, A_NS + 6
        ns = Vec3(a[n0] * w0 + a[n1] * b1 + a[n2] * b2,
                  a[n0 + 1] * w0 + a[n1 + 1] * b1 + a[n2 + 1] * b2,
                  a[n0 + 2] * w0 + a[n1 + 2] * b1 + a[n2 + 2] * b2)
        has_ns = ns.squared_norm() > 1e-12
        ns = Vec3.where(has_ns, ns.normalize(), ng)
        if self.instances is not None and pi.instance_index is not None:
            # an instanced hit's prototype face lies in prototype space: the
            # position goes through its instance's to_world, the normals
            # through its inverse transpose; the transforms are not
            # differentiable (as in JAX)
            ii = pi.instance_index
            k = torch.clamp(ii, 0, self.instances.proto_of.shape[0] - 1)
            iw = self.instances.to_world.detach()[k.long()]
            nm = self.instances.n_mat.detach()[k.long()]
            is_inst = ii >= 0
            p = Vec3.where(is_inst, instancing.affine_apply(iw, p), p)
            ng = Vec3.where(is_inst,
                            instancing.linear9_apply(nm, ng).normalize(), ng)
            ns = Vec3.where(is_inst,
                            instancing.linear9_apply(nm, ns).normalize(), ns)
        uv = Vec2(a[A_UV] * w0 + a[A_UV + 2] * b1 + a[A_UV + 4] * b2,
                  a[A_UV + 1] * w0 + a[A_UV + 3] * b1 + a[A_UV + 5] * b2)
        valid = pi.is_valid()

        def as_int(x):
            return torch.round(x).to(torch.int32)

        shape_idx = torch.where(valid, as_int(a[A_SHAPE]), -1)
        bsdf_idx = as_int(a[A_BSDF])
        emitter_idx = torch.where(valid, as_int(a[A_EMITTER]), -1)
        inv_total_area = a[A_INV_AREA]
        med = ([as_int(a[A_MED]), as_int(a[A_MED + 1])] if self.has_media
               else None)
        f_count = self.faces.shape[0]
        implicit = []   # (lanes, p, n, (shape, bsdf, medium in, out) rows)
        if self.n_analytic:
            # analytic lanes: p and n recomputed differentiably from the
            # rows (sphere.cpp / disk.cpp compute_surface_interaction)
            is_an = valid & (pi.prim_index >= f_count)
            aidx = torch.clamp(pi.prim_index - f_count, 0,
                               self.n_analytic - 1)
            pa, nga, _, rows = analytic.surface_fields(
                self.analytic_prims, aidx, pi.prim_uv, ray.o, ray.d, pi.t)
            implicit.append((is_an, pa, nga, rows[15:20]))
            uv = Vec2(torch.where(is_an, pi.prim_uv.x, uv.x),
                      torch.where(is_an, pi.prim_uv.y, uv.y))
        for k, grid in enumerate(self.sdf_grids):
            is_sdf = valid & (pi.prim_index == f_count + self.n_analytic + k)
            row = self.sdf_rows[k]
            pw, nw = sdf_mod.surface_fields(grid, row, ray.o, ray.d, pi.t,
                                            active=is_sdf)
            implicit.append((is_sdf, pw, nw, [row[13], row[14], None,
                                              row[15], row[16]]))
        for lanes, pk, nk, r in implicit:
            p = Vec3.where(lanes, pk, p)
            ng = Vec3.where(lanes, nk, ng)
            ns = Vec3.where(lanes, nk, ns)
            shape_idx = torch.where(lanes, as_int(r[0]), shape_idx)
            bsdf_idx = torch.where(lanes, as_int(r[1]), bsdf_idx)
            emitter_idx = torch.where(lanes, -1, emitter_idx)
            inv_total_area = torch.where(lanes, 0.0, inv_total_area)
            if med is not None:
                med = [torch.where(lanes, as_int(r[3]), med[0]),
                       torch.where(lanes, as_int(r[4]), med[1])]
        sh_frame = Frame.from_normal(ns)
        wi = sh_frame.to_local(-ray.d)

        duv_scale = None
        if any(meta[2] for meta in self.texture_meta):
            # per-face uv density |d(uv)| / |d(p)| for the mip LOD (constant
            # on an affinely parameterised triangle)
            duv1 = Vec2(a[A_UV + 2] - a[A_UV], a[A_UV + 3] - a[A_UV + 1])
            duv2 = Vec2(a[A_UV + 4] - a[A_UV], a[A_UV + 5] - a[A_UV + 1])
            uv_area = torch.abs(duv1.x * duv2.y - duv1.y * duv2.x)
            duv_scale = torch.sqrt(m.safe_div(uv_area,
                                              te1.cross(te2).norm()))
        vcolor = None
        if self.face_colors is not None:
            # the interpolated vertex attribute (mesh_attribute.cpp eval)
            c0, c1, c2 = self.a_vc, self.a_vc + 3, self.a_vc + 6
            vcolor = Vec3(a[c0] * w0 + a[c1] * b1 + a[c2] * b2,
                          a[c0 + 1] * w0 + a[c1 + 1] * b1 + a[c2 + 1] * b2,
                          a[c0 + 2] * w0 + a[c1 + 2] * b1 + a[c2 + 2] * b2)

        si = SurfaceInteraction(
            p=p, t=pi.t, n=ng, sh_frame=sh_frame, uv=uv, wi=wi,
            shape_index=shape_idx, prim_index=pi.prim_index,
            wavelengths=ray.wl, vcolor=vcolor, duv_scale=duv_scale)
        attrs = {"bsdf": bsdf_idx, "emitter": emitter_idx,
                 "inv_total_area": inv_total_area}
        if med is not None:
            attrs["medium_interior"], attrs["medium_exterior"] = med
        return si, attrs

    @staticmethod
    def target_medium(si, attrs, d: Vec3):
        """The medium on the far side when leaving a surface along world
        direction d (interaction.h target_medium: entering the shape when
        d points against the geometric normal)."""
        return torch.where(si.n.dot(d) < 0.0, attrs["medium_interior"],
                           attrs["medium_exterior"])

    # ------------------------------------------------------------------
    # Emitter sampling
    # ------------------------------------------------------------------

    def gather_em_radiance(self, em_idx) -> Vec3:
        """[N] emitter slots -> radiance Vec3 (one row take per lane). Slots
        past the table (delta emitters hold no row) take its last row, where
        JAX's one-hot gather gives 0; every caller replaces those lanes."""
        last = self.em_radiance.shape[0] - 1
        r = take_rows(self.em_radiance, torch.clamp(em_idx, max=last))
        return Vec3(r[:, 0], r[:, 1], r[:, 2])

    def has_nee_emitters(self):
        """True if NEE can select any emitter (area, delta or
        environment): the shadow-ray gate."""
        return bool(self.ef_face.shape[0] or self.env_emitter >= 0 or (
            self.de_params is not None and self.de_params.shape[0]))

    def sample_emitter_direction_from(self, ref_p: Vec3, sample1,
                                      sample2: Vec2, wavelengths=None):
        """NEE direction sampling from any reference point (a surface or a
        medium vertex) without a visibility test; `wavelengths` the path's
        in the spectral variant. Returns (DirectionSample, unshadowed
        weight Vec3)."""
        return self._sample_emitter_core(
            _RefPoint(p=ref_p, t=ref_p.x, wavelengths=wavelengths), sample1,
            sample2)

    def sample_emitter_direction(self, si: SurfaceInteraction, sample1,
                                 sample2: Vec2, active=None,
                                 test_visibility=True):
        """NEE direction sampling plus (optionally) the shadow-ray test.
        Returns (DirectionSample, weight Vec3)."""
        ds, weight = self._sample_emitter_core(si, sample1, sample2)
        ok = ds.pdf > 0.0
        if active is not None:
            ok = ok & active
        if test_visibility and self.has_nee_emitters():
            occluded = self.ray_test(si.spawn_ray_to(ds.p), active=ok)
            ok = ok & ~occluded
        ds = ds.replace(pdf=torch.where(ok, ds.pdf, 0.0))
        return ds, weight.mask(ok)

    def _sample_area(self, si, sample1, sample2: Vec2, e_total: int):
        """An emissive triangle from the global area-weighted CDF, a
        uniform point on it, and the solid-angle pdf from si.p. Returns
        (d, p, ng, pdf_sa, radiance, em_idx, dist, uv, prim)."""
        face = self.ef_face[pick(self.ef_cdf, sample1).long()]
        a = self.gather_face_attrs(face)
        fp0 = Vec3(a[A_P0], a[A_P0 + 1], a[A_P0 + 2])
        fe1 = Vec3(a[A_E1], a[A_E1 + 1], a[A_E1 + 2])
        fe2 = Vec3(a[A_E2], a[A_E2 + 1], a[A_E2 + 2])
        # square_to_uniform_triangle (warp.h), componentwise
        tsq = m.safe_sqrt(1.0 - sample2.x)
        b1 = 1.0 - tsq
        b2 = tsq * sample2.y
        p = fp0 + fe1 * b1 + fe2 * b2
        ng = fe1.cross(fe2).normalize()
        d_un = p - si.p
        dist2 = d_un.squared_norm()
        d = d_un * torch.rsqrt(torch.clamp(dist2, min=1e-30))
        cos_emitter = -ng.dot(d)
        pdf_sa = m.safe_div(a[A_INV_AREA] / e_total * dist2, cos_emitter)
        pdf_sa = torch.where(cos_emitter > 0.0, pdf_sa, 0.0)
        em_idx = torch.round(a[A_EMITTER]).to(torch.int32)
        radiance = self.gather_em_radiance(em_idx)
        # NEE toward a directionalarea emitter contributes 0: it emits
        # along its normal only (directionalarea.cpp)
        for slot in self.em_directional:
            radiance = radiance.mask(em_idx != slot)
        dist = m.safe_sqrt(dist2)
        if self.em_sphere_slots:
            cone = self._sample_sphere_cone(si.p, em_idx, sample2, e_total)
            use, d_c, p_c, ng_c, dist_c, pdf_c = cone
            d = Vec3.where(use, d_c, d)
            p = Vec3.where(use, p_c, p)
            ng = Vec3.where(use, ng_c, ng)
            dist = torch.where(use, dist_c, dist)
            pdf_sa = torch.where(use, pdf_c, pdf_sa)
        return (d, p, ng, pdf_sa, radiance, em_idx, dist, Vec2(b1, b2), face)

    def _sphere_cone(self, ref_p: Vec3, em_idx, e_total: int):
        """Per lane: (is a sphere emitter's slot seen from outside it,
        center, radius, |center - ref_p|^2, sin^2 and cos of the cone's
        half-angle, the cone's NEE pdf)."""
        sp = take_rows(self.em_sphere,
                       torch.clamp(em_idx, 0, self.em_sphere.shape[0] - 1))
        is_sph = torch.zeros_like(em_idx, dtype=torch.bool)
        for slot in self.em_sphere_slots:
            is_sph = is_sph | (em_idx == slot)
        c = Vec3(sp[:, 0], sp[:, 1], sp[:, 2])
        r_sph = sp[:, 3]
        dc2 = (c - ref_p).squared_norm()
        outside = m.safe_sqrt(dc2) > r_sph * 1.0005
        sin2max = torch.clamp(r_sph * r_sph / torch.clamp(dc2, min=1e-20),
                              0.0, 1.0)
        cosmax = m.safe_sqrt(1.0 - sin2max)
        # 2 pi (1 - cos) as sin^2 / (1 + cos), for stability
        solid = (2.0 * m.Pi) * sin2max / (1.0 + cosmax)
        pdf = m.safe_div(1.0, e_total * torch.clamp(solid, min=1e-12))
        return is_sph & outside, c, r_sph, dc2, cosmax, pdf

    def _sample_sphere_cone(self, ref_p: Vec3, em_idx, sample2: Vec2,
                            e_total: int):
        """Cone sampling of a sphere emitter's subtended solid angle
        (sphere.cpp sample_direction): the point lies on the true sphere,
        which its inscribed tessellation never occludes. Returns (lanes
        that use it, d, p, n, dist, solid-angle pdf)."""
        use, c, r_sph, dc2, cosmax, pdf = self._sphere_cone(ref_p, em_idx,
                                                            e_total)
        to_c = c - ref_p
        dir_c = to_c * torch.rsqrt(torch.clamp(dc2, min=1e-20))
        local = warp.square_to_uniform_cone(sample2, cosmax)
        d = Frame.from_normal(dir_c).to_world(local)
        b_half = d.dot(to_c)
        disc = b_half * b_half - (dc2 - r_sph * r_sph)
        t_near = b_half - m.safe_sqrt(torch.clamp(disc, min=0.0))
        p = ref_p + d * t_near
        ng = (p - c) * m.safe_div(1.0, r_sph)
        return use, d, p, ng, t_near, pdf

    def _sample_emitter_core(self, si, sample1, sample2: Vec2):
        """The unit interval of `sample1` is split into the area emitters'
        mass (the global area-weighted CDF, n_area/E), one 1/E slot per
        delta emitter and a final 1/E environment slot (uniform emitter
        selection, scene.cpp). `si` needs only `.p` and `.t`."""
        n = si.t.shape[0]
        dev = si.t.device
        n_area = self.ef_face.shape[0]
        n_delta = self.de_params.shape[0] if self.de_params is not None else 0
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        none = torch.full((n,), -1, dtype=torch.int32, device=dev)
        if not self.has_nee_emitters():
            z3 = Vec3(zeros, zeros, zeros)
            ds = DirectionSample(
                p=z3, n=z3, uv=Vec2(zeros, zeros), pdf=zeros,
                delta=torch.zeros(n, dtype=torch.bool, device=dev), d=z3,
                dist=zeros, emitter_index=none, prim_index=none)
            return ds, z3

        e_total = max(self.n_emitters, 1)
        area_prob = self.ef_cdf[-1] if n_area else 0.0
        delta_mass = n_delta / e_total
        is_delta_lane = torch.zeros(n, dtype=torch.bool, device=dev)
        prim = none
        uv = sample2

        if n_area:
            (d, p, ng, pdf_sa, radiance, em_idx, dist, uv,
             prim) = self._sample_area(si, sample1, sample2, e_total)

        if n_delta:
            pick_delta = (sample1 >= area_prob) & (
                sample1 < area_prob + delta_mass)
            k = torch.clamp(((sample1 - area_prob) * e_total).to(torch.int32),
                            0, n_delta - 1)
            d_d, p_d, n_d, rad_d, dist_d = self._eval_delta_emitter(si, k)
            pdf_d = torch.where(rad_d.any_positive(), 1.0 / e_total, 0.0)
            em_d = self.n_area_emitters + k
            if n_area:
                d = Vec3.where(pick_delta, d_d, d)
                p = Vec3.where(pick_delta, p_d, p)
                ng = Vec3.where(pick_delta, n_d, ng)
                pdf_sa = torch.where(pick_delta, pdf_d, pdf_sa)
                radiance = Vec3.where(pick_delta, rad_d, radiance)
                em_idx = torch.where(pick_delta, em_d, em_idx)
                dist = torch.where(pick_delta, dist_d, dist)
            else:
                d, p, ng, pdf_sa, radiance, dist = (d_d, p_d, n_d, pdf_d,
                                                    rad_d, dist_d)
                em_idx = torch.where(pick_delta, em_d, -1)
            is_delta_lane = pick_delta

        if self.env_emitter >= 0:
            nonenv_mass = area_prob + delta_mass
            rest = 1.0 - nonenv_mass
            rest = (torch.clamp(rest, min=1e-8)
                    if isinstance(rest, torch.Tensor) else max(rest, 1e-8))
            s1_env = torch.clamp((sample1 - nonenv_mass) / rest,
                                 0.0, 1.0 - 1e-7)
            d_env, pdf_env, rad_env = env_mod.sample_env_dir(self, s1_env,
                                                             sample2)
            pdf_env = pdf_env / e_total
            p_env = si.p + d_env * FAR
            if n_area or n_delta:
                pick_env = sample1 >= nonenv_mass
                d = Vec3.where(pick_env, d_env, d)
                p = Vec3.where(pick_env, p_env, p)
                ng = Vec3.where(pick_env, -d_env, ng)
                pdf_sa = torch.where(pick_env, pdf_env, pdf_sa)
                radiance = Vec3.where(pick_env, rad_env, radiance)
                em_idx = torch.where(pick_env, self.env_emitter, em_idx)
                dist = torch.where(pick_env, FAR, dist)
                is_delta_lane = is_delta_lane & ~pick_env
            else:
                d, p, ng = d_env, p_env, -d_env
                pdf_sa = pdf_env
                radiance = rad_env
                em_idx = torch.full((n,), self.env_emitter, dtype=torch.int32,
                                    device=dev)
                dist = torch.full((n,), FAR, dtype=torch.float32, device=dev)
                uv = sample2

        ok = pdf_sa > 0.0
        inv_pdf = torch.where(ok, 1.0 / torch.clamp(pdf_sa, min=1e-20), 0.0)
        radiance = self.spectral_radiance(radiance, em_idx,
                                          getattr(si, "wavelengths", None))
        weight = radiance * inv_pdf
        area_lane = (em_idx >= 0) & (em_idx < max(self.n_area_emitters,
                                                  n_area and 1))
        ds = DirectionSample(
            p=p, n=ng, uv=uv, pdf=torch.where(ok, pdf_sa, 0.0),
            delta=is_delta_lane, d=d, dist=dist, emitter_index=em_idx,
            prim_index=torch.where(area_lane, prim, -1))
        return ds, weight.mask(ok)

    def _eval_delta_emitter(self, si, k):
        """Direction toward delta emitter slot k (src/emitters/{point,
        spot,directional}.cpp), each lane by its slot's type. Returns
        (d, p, n, radiance, dist); the radiance folds in a point or spot
        light's 1/dist² falloff, so the NEE weight is radiance / pick pmf."""
        types = self.delta_emitter_types
        r = take_rows(self.de_params, k).T
        pos = Vec3(r[0], r[1], r[2])
        intensity = Vec3(r[3], r[4], r[5])
        axis = Vec3(r[6], r[7], r[8])
        t =torch.as_tensor(types, dtype=torch.int32, device=k.device)[
            torch.clamp(k, 0, len(types) - 1).long()]
        is_dir = t == em_pkg.DIRECTIONAL
        d_un = pos - si.p
        dist2 = torch.clamp(d_un.squared_norm(), min=1e-12)
        d = Vec3.where(is_dir, -axis, d_un * torch.rsqrt(dist2))
        dist = torch.where(is_dir, FAR, torch.sqrt(dist2))
        p = Vec3.where(is_dir, si.p + d * FAR, pos)
        rad = Vec3.where(is_dir, intensity, intensity * (1.0 / dist2))
        if em_pkg.SPOT in types:
            # spot.cpp:143-150: linear-in-angle falloff past the beam width
            cos_theta = (-d).dot(axis)
            beam = torch.clamp((r[10] - torch.arccos(
                torch.clamp(cos_theta, -1.0, 1.0))) * r[11], max=1.0)
            falloff = torch.where(cos_theta > r[9],
                                  torch.clamp(beam, min=0.0), 0.0)
            rad = Vec3.where(t == em_pkg.SPOT, rad * falloff, rad)
        if em_pkg.PROJECTOR in types:
            # projector.cpp: the emitter-space direction maps to film uv
            # through tan(fov / 2); the irradiance texture (row [12], id
            # + 1; 0 = white) is looked up bilinearly with repeat wrap
            ax_x = Vec3(r[13], r[14], r[15])
            ax_y = Vec3(r[16], r[17], r[18])
            tanf = torch.clamp(r[19], min=1e-6)
            dl = -d
            lz = torch.clamp(dl.dot(axis), min=1e-6)
            lx = dl.dot(ax_x) / (lz * tanf)
            ly = dl.dot(ax_y) / (lz * tanf)
            inside = ((lx.abs() <= 1.0) & (ly.abs() <= 1.0)
                      & (dl.dot(axis) > 0.0))
            uv = Vec2((lx + 1.0) * 0.5, (ly + 1.0) * 0.5)
            one = torch.ones_like(lz)
            tex_rgb = Vec3(one, one, one)
            tex_id = torch.round(r[12]).to(torch.int32)
            for kk in self.projector_textures:
                val = tex_mod.eval_bilinear(self.textures[kk - 1], uv)
                tex_rgb = Vec3.where(tex_id == kk, val, tex_rgb)
            proj = (rad * tex_rgb).mask(inside)
            rad = Vec3.where(t == em_pkg.PROJECTOR, proj, rad)
        return d, p, -d, rad, dist

    def pdf_emitter_direction_hit(self, prev_p: Vec3, si: SurfaceInteraction,
                                  attrs):
        """Solid-angle pdf of having NEE-sampled the point `si` from
        `prev_p` (MIS weight for BSDF-sampled emitter hits)."""
        if self.n_emitters == 0:
            return torch.zeros_like(si.t)
        d_un = si.p - prev_p
        dist2 = d_un.squared_norm()
        d = d_un * torch.rsqrt(torch.clamp(dist2, min=1e-30))
        cos_emitter = -si.n.dot(d)
        pdf_area = attrs["inv_total_area"] / max(self.n_emitters, 1)
        pdf_sa = m.safe_div(pdf_area * dist2, cos_emitter)
        pdf_sa = torch.where(cos_emitter > 0.0, pdf_sa, 0.0)
        em_idx = attrs["emitter"]
        if self.em_sphere_slots:
            # NEE cone-samples sphere emitters seen from outside: the MIS
            # pdf of a BSDF hit on one is the cone's density
            use, *_, pdf_cone = self._sphere_cone(
                prev_p, em_idx, max(self.n_emitters, 1))
            pdf_sa = torch.where(use, pdf_cone, pdf_sa)
        return torch.where((em_idx >= 0) & si.is_valid(), pdf_sa, 0.0)

    def pdf_emitter_direction_miss(self, d: Vec3):
        """Solid-angle NEE pdf for a ray that escaped to the environment."""
        if self.env_emitter < 0:
            return torch.zeros_like(d.x)
        return env_mod.pdf_env_dir(self, d) / max(self.n_emitters, 1)

    def eval_emitter(self, si: SurfaceInteraction, attrs) -> Vec3:
        """Radiance of the emitter at a surface hit (one-sided)."""
        if self.n_emitters == 0:
            return Vec3.zeros(si.t.shape[0], si.t.device)
        em_idx = attrs["emitter"]
        emissive = (em_idx >= 0) & si.is_valid()
        # a directionalarea emitter radiates along its exact normal only,
        # which no sampled ray hits (directionalarea.cpp eval = 0)
        for slot in self.em_directional:
            emissive = emissive & (em_idx != slot)
        front = si.wi.z > 0.0
        radiance = self.spectral_radiance(
            self.gather_em_radiance(torch.clamp(em_idx, min=0)), em_idx,
            getattr(si, "wavelengths", None))
        return radiance.mask(emissive & front)

    def spectral_radiance(self, radiance: Vec3, em_idx, wavelengths):
        """An emitter's RGB radiance at the path's wavelengths: upsampled,
        or on the slots of em_spd_slots their SPD (the spectral variant;
        unchanged in RGB, where `wavelengths` is None)."""
        if wavelengths is None:
            return radiance
        radiance = spectral.rgb_to_spectrum(radiance, wavelengths,
                                            reflectance=False)
        for slot in self.em_spd_slots:
            radiance = Vec3.where(em_idx == slot, spectral.eval_spd(
                self.em_spd[slot], wavelengths), radiance)
        return radiance

    def eval_env(self, d: Vec3, wavelengths: Vec3 | None = None) -> Vec3:
        """Environment radiance for escaped rays (upsampled to
        `wavelengths` in the spectral variant)."""
        rad = env_mod.eval_env(self, d)
        if wavelengths is not None:
            rad = spectral.rgb_to_spectrum(rad, wavelengths,
                                           reflectance=False)
        return rad

    def texture_ids(self, bsdf_name: str):
        """The texture ids (k + 1 for textures[k], -1 for vertex colors)
        the rows of BSDF type `bsdf_name` hold (none for a type without
        rows, such as diffuse called by a user's BSDF module)."""
        return dict(self.bsdf_textures).get(bsdf_name, ())

    def gather_bsdf_params(self, bsdf_idx):
        """[N] bsdf slots -> SoA param rows [N_PARAMS, N]."""
        return take_rows(self.bsdf_params, bsdf_idx).T

    def gather_medium_params(self, med_idx):
        """[N] medium indices -> SoA param rows [N_MPARAMS, N] (one row
        take per lane); vacuum lanes (index < 0) get a row of zeros, as
        JAX's one-hot gather gives them."""
        m_count = self.medium_params.shape[0]
        if m_count == 0:
            return torch.zeros((self.medium_params.shape[1],
                                med_idx.shape[0]), device=med_idx.device)
        rows = take_rows(self.medium_params,
                         torch.clamp(med_idx, 0, m_count - 1))
        return torch.where((med_idx >= 0)[:, None], rows, 0.0).T
