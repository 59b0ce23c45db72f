"""Participating media — counterpart of ``mitsuba3_tpu/media/__init__.py``
(src/render/medium.cpp, src/media/{homogeneous, heterogeneous}.cpp).

Media are rows of the scene's ``medium_params`` table plus, for
heterogeneous media, density grids in ``scene.medium_grids``. The
null-scattering collision loop is fused into a bounded loop of
``track_steps`` steps so that the volumetric integrators advance one
*real* event per bounce, as in the JAX package. Every lane draws the same
number of samples per call (two per step, or one in ``transmittance``),
done lanes included: the primal and the PRB replay then walk one PCG32
stream, bit-equal to JAX's. A call draws them all at once
(``sampler.next_1d_block``).

Medium parameter row (``N_MPARAMS`` wide):
  [0:3]   sigma_t RGB (differentiable)     [3:6]  albedo RGB (differentiable)
  [6]     scale                            [7]    phase parameter (HG g)
  [8]     majorant (heterogeneous: scale * max density * max sigma_t)
  [9]     grid slot + 1 (0 = no grid)      [10]   sample_emitters flag
  [12:18] SGGX S (Sxx, Syy, Szz, Sxy, Sxz, Syz)
  [18]    tabulated-phase table slot + 1
  [19]    blendphase weight, [20] / [21] its nested phase type ids

A trilinear density lookup gathers one row of the grid's cell table
([cells, 8] corner values) per lane. JAX rebuilds that table inside every
tracking step and XLA hoists it; eager torch would rebuild it 48 times a
bounce, so ``cell_table`` builds it once per grid tensor and keeps it
while the tensor lives (a tensor that requires grad gets a fresh table,
unless ``ad/prbvolpath.py`` registered its pass's table). JAX interpolates
z first up to ``CELLS_ZYX_MAX`` cells and x first above it (its
8-gather ``_sample_grid``); the lookup keeps both orders, so the values
are JAX's at every grid size.
"""
from __future__ import annotations

import itertools

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from ..bsdfs import slot_table
from ..core.gather import take_rows
from ..core.struct import struct
from ..core.vec import Vec3
from ..render import sampler as sampler_mod

HOMOGENEOUS = 0
HETEROGENEOUS = 1

N_MPARAMS = 24

# bounded step count of the delta- and ratio-tracking loops
MAX_TRACK_STEPS = 48

# finite stand-in for 'unbounded' distances (keeps inf out of gradients)
BIG_T = 1e8

# tracking steps between checks for an early end (each check waits for
# the device)
DONE_CHECK = 8

# JAX's cell-table lookup (z-first) threshold; above it, x-first order
CELLS_ZYX_MAX = 4_000_000

# grid tensor -> (version, [cells, 8] table)
_CELLS = WeakTensorKeyDictionary()


@struct
class MediumInteraction:
    """``t = inf``: no real collision (the ray left the medium segment)."""
    p: Vec3
    t: torch.Tensor
    wi: Vec3
    medium_index: torch.Tensor

    def is_valid(self):
        return torch.isfinite(self.t)


def index_spectrum(v: Vec3, channel):
    """Per-lane channel select (volpath.cpp index_spectrum)."""
    return torch.where(channel == 0, v.x, torch.where(channel == 1, v.y, v.z))


def has_heterogeneous(scene) -> bool:
    return HETEROGENEOUS in scene.medium_types


def _lane_is_het(scene, med_idx):
    types = slot_table(tuple(scene.medium_types), med_idx.device)
    return types[torch.clamp(med_idx, 0, len(scene.medium_types) - 1)
                 .long()] == HETEROGENEOUS


# ---------------------------------------------------------------------------
# Density grids
# ---------------------------------------------------------------------------

def gather_to_grid(scene, med_idx):
    """Per-lane world->grid affine rows [12, N]; zeros for vacuum lanes
    (JAX's one-hot gather)."""
    m_count = scene.medium_to_grid.shape[0]
    flat = scene.medium_to_grid.reshape(m_count, 12)
    rows = take_rows(flat, torch.clamp(med_idx, 0, m_count - 1))
    return torch.where((med_idx >= 0)[:, None], rows, 0.0).T


def _to_grid(a, p: Vec3) -> Vec3:
    return Vec3(a[0] * p.x + a[1] * p.y + a[2] * p.z + a[3],
                a[4] * p.x + a[5] * p.y + a[6] * p.z + a[7],
                a[8] * p.x + a[9] * p.y + a[10] * p.z + a[11])


def _inside(p: Vec3):
    return ((p.x >= 0.0) & (p.x <= 1.0) & (p.y >= 0.0) & (p.y <= 1.0)
            & (p.z >= 0.0) & (p.z <= 1.0))


def sample_grid(grid, p: Vec3):
    """Trilinear sample of a [D, H, W] grid at grid-space p (x->W, y->H,
    z->D; zero outside [0,1]^3) by eight gathers: JAX's ``_sample_grid``,
    the oracle of the cell lookup and the lookup of grids thinner than 2."""
    d, h, w = grid.shape
    fx = torch.clamp(p.x, 0.0, 1.0) * (w - 1)
    fy = torch.clamp(p.y, 0.0, 1.0) * (h - 1)
    fz = torch.clamp(p.z, 0.0, 1.0) * (d - 1)
    x0 = torch.clamp(torch.floor(fx), 0, w - 1).to(torch.int32)
    y0 = torch.clamp(torch.floor(fy), 0, h - 1).to(torch.int32)
    z0 = torch.clamp(torch.floor(fz), 0, d - 1).to(torch.int32)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    z1 = torch.clamp(z0 + 1, max=d - 1)
    tx = fx - x0
    ty = fy - y0
    tz = fz - z0
    flat = grid.reshape(-1)

    def at(zi, yi, xi):
        return flat[((zi * h + yi) * w + xi).long()]

    c00 = at(z0, y0, x0) * (1 - tx) + at(z0, y0, x1) * tx
    c01 = at(z0, y1, x0) * (1 - tx) + at(z0, y1, x1) * tx
    c10 = at(z1, y0, x0) * (1 - tx) + at(z1, y0, x1) * tx
    c11 = at(z1, y1, x0) * (1 - tx) + at(z1, y1, x1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    return torch.where(_inside(p), c0 * (1 - tz) + c1 * tz, 0.0)


def build_cells(g):
    """[(D-1)(H-1)(W-1), 8] cell-corner rows of grid `g` (JAX's
    ``_cell_rows``): corners in (z, y, x) bit order."""
    d, h, w = g.shape
    out = g.new_empty((d - 1, h - 1, w - 1, 8))
    # each corner written in place: no copy of the grid per corner (a
    # 256^3 grid's table alone is 0.53 GB)
    for k, (z, y, x) in enumerate(itertools.product((0, 1), repeat=3)):
        out[..., k] = g[z:d - 1 + z, y:h - 1 + y, x:w - 1 + x]
    return out.reshape(-1, 8)


def register_cells(grid, cells):
    """Make `cells` the table that lookups in `grid` use while it lives."""
    _CELLS[grid] = (grid._version, cells)


def cell_table(grid):
    """The cell table of `grid`: the one registered or built before for it,
    else a new one (kept unless it carries an autograd graph)."""
    needs_graph = grid.requires_grad and torch.is_grad_enabled()
    hit = _CELLS.get(grid)
    if (hit is not None and hit[0] == grid._version
            and (hit[1].requires_grad or not needs_graph)):
        return hit[1]
    if needs_graph:
        return build_cells(grid)
    with torch.no_grad():
        cells = build_cells(grid)
    register_cells(grid, cells)
    return cells


def sample_grid_cells(cells, shape, p: Vec3, zyx: bool = True):
    """Trilinear sample by ONE row gather from the cell table. `zyx`
    interpolates z, then y, then x (JAX's ``_sample_grid_cells``); else x,
    y, z, which rounds as ``sample_grid`` does."""
    d, h, w = shape
    fx = torch.clamp(p.x, 0.0, 1.0) * (w - 1)
    fy = torch.clamp(p.y, 0.0, 1.0) * (h - 1)
    fz = torch.clamp(p.z, 0.0, 1.0) * (d - 1)
    x0 = torch.clamp(torch.floor(fx), 0, w - 2).to(torch.int32)
    y0 = torch.clamp(torch.floor(fy), 0, h - 2).to(torch.int32)
    z0 = torch.clamp(torch.floor(fz), 0, d - 2).to(torch.int32)
    tx = fx - x0
    ty = fy - y0
    tz = fz - z0
    r = take_rows(cells, (z0 * (h - 1) + y0) * (w - 1) + x0)
    if zyx:
        c0 = r[:, 0:4] * (1 - tz)[:, None] + r[:, 4:8] * tz[:, None]
        c1 = c0[:, 0:2] * (1 - ty)[:, None] + c0[:, 2:4] * ty[:, None]
        val = c1[:, 0] * (1 - tx) + c1[:, 1] * tx
    else:
        cx = r[:, 0::2] * (1 - tx)[:, None] + r[:, 1::2] * tx[:, None]
        cy = cx[:, 0::2] * (1 - ty)[:, None] + cx[:, 1::2] * ty[:, None]
        val = cy[:, 0] * (1 - tz) + cy[:, 1] * tz
    return torch.where(_inside(p), val, 0.0)


def lookup_grid(grid, p: Vec3):
    d, h, w = grid.shape
    if min(d, h, w) < 2:
        return sample_grid(grid, p)
    n_cells = (d - 1) * (h - 1) * (w - 1)
    return sample_grid_cells(cell_table(grid), grid.shape, p,
                             zyx=n_cells <= CELLS_ZYX_MAX)


def eval_density(scene, params, p: Vec3, a=None):
    """Per-lane density: 1 for homogeneous media, the grid's trilinear
    sample for heterogeneous ones. `a` is ``gather_to_grid``'s rows."""
    ones = torch.ones_like(p.x)
    if not has_heterogeneous(scene):
        return ones
    pg = _to_grid(a, p)
    grid_slot = torch.round(params[9]).to(torch.int32)
    density = ones
    for gi, grid in enumerate(scene.medium_grids):
        density = torch.where(grid_slot == gi + 1, lookup_grid(grid, pg),
                              density)
    return density


def get_majorant(scene, med_idx, params) -> Vec3:
    """Combined extinction (majorant) as RGB: sigma_t * scale for
    homogeneous media (no null collisions), the row's bound [8] for
    heterogeneous ones."""
    sig = Vec3(params[0], params[1], params[2]) * params[6]
    if not has_heterogeneous(scene):
        return sig
    is_het = _lane_is_het(scene, med_idx)
    maj = params[8]
    return Vec3(torch.where(is_het, maj, sig.x),
                torch.where(is_het, maj, sig.y),
                torch.where(is_het, maj, sig.z))


def scattering_coefficients(scene, params, p: Vec3, a=None):
    """-> (sigma_s, sigma_t) RGB at p."""
    density = eval_density(scene, params, p, a)
    sigma_t = Vec3(params[0], params[1], params[2]) * (params[6] * density)
    albedo = Vec3(params[3], params[4], params[5])
    return sigma_t * albedo, sigma_t


def intersect_aabb(scene, med_idx, ray_o: Vec3, ray_d: Vec3, a=None):
    """(mint, maxt) of the medium's bounds along the ray: unbounded for
    homogeneous media, the grid volume ([0,1]^3 in grid space) for
    heterogeneous ones."""
    mint = torch.zeros_like(ray_o.x)
    maxt = torch.full_like(ray_o.x, float("inf"))
    if not has_heterogeneous(scene):
        return mint, maxt
    if a is None:
        a = gather_to_grid(scene, med_idx)
    og = _to_grid(a, ray_o)
    dg = Vec3(a[0] * ray_d.x + a[1] * ray_d.y + a[2] * ray_d.z,
              a[4] * ray_d.x + a[5] * ray_d.y + a[6] * ray_d.z,
              a[8] * ray_d.x + a[9] * ray_d.y + a[10] * ray_d.z)

    def inv(c):
        return 1.0 / torch.where(c.abs() < 1e-12, 1e-12, c)

    ix, iy, iz = inv(dg.x), inv(dg.y), inv(dg.z)
    t0 = Vec3(-og.x * ix, -og.y * iy, -og.z * iz)
    t1 = Vec3((1.0 - og.x) * ix, (1.0 - og.y) * iy, (1.0 - og.z) * iz)
    lo = Vec3(torch.minimum(t0.x, t1.x), torch.minimum(t0.y, t1.y),
              torch.minimum(t0.z, t1.z))
    hi = Vec3(torch.maximum(t0.x, t1.x), torch.maximum(t0.y, t1.y),
              torch.maximum(t0.z, t1.z))
    g_mint = lo.max_component()
    g_maxt = hi.min_component()
    hit = g_maxt >= g_mint
    is_het = _lane_is_het(scene, med_idx)
    mint = torch.where(is_het, torch.where(hit, g_mint, float("inf")), mint)
    maxt = torch.where(is_het, torch.where(hit, g_maxt, float("-inf")), maxt)
    return mint, maxt


# ---------------------------------------------------------------------------
# Free-flight sampling: the next REAL collision (fused null scattering)
# ---------------------------------------------------------------------------

def track_steps(scene) -> int:
    """Trip count of the tracking loops: heterogeneous media null-scatter;
    homogeneous ones never do (sigma_n = 0), so one step suffices."""
    return MAX_TRACK_STEPS if has_heterogeneous(scene) else 1


def _all_done(step: int, done) -> bool:
    """Every DONE_CHECK steps: have all lanes ended? A done lane's state no
    longer changes and the block has drawn the loop's samples already, so
    leaving the loop then changes neither values nor streams."""
    return step > 0 and step % DONE_CHECK == 0 and bool(done.all())


def _free_flight(u1, m_c):
    return torch.clamp(-torch.log1p(-torch.clamp(u1, max=1.0 - 1e-7)) / m_c,
                       max=BIG_T)


def _mis_step(r_pdf: Vec3, done, step_pdf: Vec3, pdf_c, esc,
              ev: Vec3) -> Vec3:
    """The chain-pdf ratios pdf_c / pdf_hero after one step: times its
    distance part and its event classification part `ev` (1 on escape)."""
    r_dist = step_pdf * (1.0 / torch.clamp(pdf_c, min=1e-30))
    return Vec3.where(done, r_pdf, r_pdf * r_dist * Vec3.where(~esc, ev, 1.0))


def sample_real_interaction(scene, med_idx, ray, t_surf, rng, channel,
                            active, spectral_mis: bool = False):
    """The next *real* scattering event along `ray` inside medium `med_idx`
    with the nearest surface at `t_surf` (volpath.cpp:213-246 fused into one
    bounded loop). Returns (mei, weight Vec3, rng): on a real collision
    (``mei.t`` finite) the null events' transmittance ratios times
    sigma_s / real_prob; on escape the ratio-tracked transmittance to
    min(t_surf, medium exit).

    Decisions (distances, null/real classification, pdfs in denominators)
    are detached; numerators stay attached, so the weight is
    differentiable with the same control flow (PRB's detached sampling).
    ``spectral_mis``: single-sample MIS over the three channel techniques
    (volpathmis.cpp), the weight times 3 / sum_c(pdf_c / pdf_hero)."""
    n = ray.o.x.shape[0]
    dev = ray.o.x.device
    params = scene.gather_medium_params(med_idx)
    a = gather_to_grid(scene, med_idx) if has_heterogeneous(scene) else None
    mint, maxt = intersect_aabb(scene, med_idx, ray.o, ray.d, a)
    # keep every intermediate finite: inf - inf in a branch not taken
    # poisons reverse-mode gradients (NaN * 0)
    mint = torch.clamp(mint, 0.0, BIG_T).detach()
    maxt = torch.clamp(torch.minimum(torch.minimum(maxt, t_surf), ray.maxt),
                       -BIG_T, BIG_T).detach()
    maj = get_majorant(scene, med_idx, params)
    maj_det = Vec3(maj.x.detach(), maj.y.detach(), maj.z.detach())
    maj_safe = maj_det.maximum(1e-20)
    m_c = torch.clamp(index_spectrum(maj_det, channel), min=1e-20)
    runnable = active & (maxt > mint)

    t = torch.where(runnable, mint, maxt)
    w = Vec3.ones(n, dev)
    r_pdf = Vec3.ones(n, dev)
    real = torch.zeros(n, dtype=torch.bool, device=dev)
    done = ~runnable
    steps = track_steps(scene)
    rng, u = sampler_mod.next_1d_block(rng, 2 * steps)
    for i in range(steps):
        if _all_done(i, done):
            break
        u1, u2 = u[2 * i], u[2 * i + 1]
        t_new = t + _free_flight(u1, m_c)
        esc = t_new >= maxt
        seg = torch.minimum(t_new, maxt) - torch.minimum(t, maxt)
        tr = (maj * (-seg)).exp()
        tr_c = index_spectrum(tr, channel).detach()
        pdf_c = torch.where(esc, tr_c, tr_c * m_c)
        w_step = w * tr * (1.0 / torch.clamp(pdf_c, min=1e-30))
        sigma_s, sigma_t = scattering_coefficients(scene, params,
                                                   ray.at(t_new), a)
        sigma_n = (maj - sigma_t).maximum(0.0)
        sn_det = Vec3(sigma_n.x.detach(), sigma_n.y.detach(),
                      sigma_n.z.detach())
        pn = sn_det / maj_safe
        if spectral_mis:
            # channel c classifies null/real with its own coefficients, so
            # the per-channel chain pdfs diverge and MIS has techniques to
            # average
            null_prob = torch.clamp(index_spectrum(pn, channel),
                                    1e-6, 1.0 - 1e-6)
        else:
            null_prob = torch.clamp(pn.mean(), 0.0, 1.0 - 1e-6)
        is_null = u2 < null_prob
        real_prob = torch.clamp(1.0 - null_prob, min=1e-6)
        if spectral_mis:
            st_det = Vec3(sigma_t.x.detach(), sigma_t.y.detach(),
                          sigma_t.z.detach())
            pr = st_det / maj_safe
            pn_h = torch.clamp(index_spectrum(pn, channel), min=1e-12)
            pr_h = torch.clamp(index_spectrum(pr, channel), min=1e-12)
            tr_det = Vec3(tr.x.detach(), tr.y.detach(), tr.z.detach())
            step_pdf = Vec3.where(esc, tr_det, maj_det * tr_det)
            ev = Vec3.where(is_null, pn * (1.0 / pn_h), pr * (1.0 / pr_h))
            r_pdf = _mis_step(r_pdf, done, step_pdf, pdf_c, esc, ev)
        # null_prob can be exactly 0 (homogeneous media): the clamp keeps
        # 0 * inf out of the branch not taken
        w_null = w_step * sigma_n * (1.0 / torch.clamp(null_prob, min=1e-6))
        w_real = w_step * sigma_s * (1.0 / real_prob)
        new_real = ~done & ~esc & ~is_null
        t = torch.where(done, t, t_new)
        w = Vec3.where(done, w, Vec3.where(
            esc, w_step, Vec3.where(is_null, w_null, w_real)))
        real = real | new_real
        done = done | esc | new_real
    # lanes whose bounded loop never ended: absorbed
    w = w.mask(done | ~runnable)
    if spectral_mis:
        mis_w = 3.0 / torch.clamp(r_pdf.x + r_pdf.y + r_pdf.z, min=1e-30)
        w = Vec3.where(runnable, w * mis_w, w)
    w = Vec3.where(runnable, w, Vec3.ones(n, dev))
    t_final = torch.where(real & runnable, t, float("inf"))
    mei = MediumInteraction(
        p=ray.at(torch.where(torch.isfinite(t_final), t_final, 0.0)),
        t=t_final, wi=-ray.d, medium_index=med_idx)
    return mei, w, rng


def transmittance(scene, med_idx, ray_o: Vec3, ray_d: Vec3, t_end, rng,
                  channel, active, spectral_mis: bool = False):
    """RGB transmittance over [0, t_end] inside medium `med_idx`:
    exp(-sigma_t d) for homogeneous media (no draws), ratio tracking
    (volpath.cpp:488-517, one draw per step) for heterogeneous ones."""
    n = ray_o.x.shape[0]
    dev = ray_o.x.device
    params = scene.gather_medium_params(med_idx)
    het = has_heterogeneous(scene)
    a = gather_to_grid(scene, med_idx) if het else None
    mint, maxt = intersect_aabb(scene, med_idx, ray_o, ray_d, a)
    mint = torch.clamp(mint, 0.0, BIG_T).detach()
    maxt = torch.clamp(torch.minimum(maxt, t_end), -BIG_T, BIG_T).detach()
    seg_len = torch.clamp(maxt - mint, min=0.0)
    sig_t_homo = Vec3(params[0], params[1], params[2]) * params[6]
    tr_homo = (sig_t_homo * (-torch.where(active, seg_len, 0.0))).exp()
    if not het:
        return Vec3.where(active, tr_homo, Vec3.ones(n, dev)), rng

    maj = get_majorant(scene, med_idx, params)
    maj_det = Vec3(maj.x.detach(), maj.y.detach(), maj.z.detach())
    m_c = torch.clamp(index_spectrum(maj_det, channel), min=1e-20)
    runnable = active & (seg_len > 0.0)
    t = torch.where(runnable, mint, maxt)
    w = Vec3.ones(n, dev)
    r_pdf = Vec3.ones(n, dev)
    done = ~runnable
    rng, u = sampler_mod.next_1d_block(rng, MAX_TRACK_STEPS)
    for i, u1 in enumerate(u):
        if _all_done(i, done):
            break
        t_new = t + _free_flight(u1, m_c)
        esc = t_new >= maxt
        seg = torch.minimum(t_new, maxt) - torch.minimum(t, maxt)
        tr = (maj * (-seg)).exp()
        tr_c = index_spectrum(tr, channel).detach()
        pdf_c = torch.where(esc, tr_c, tr_c * m_c)
        w_step = w * tr * (1.0 / torch.clamp(pdf_c, min=1e-30))
        _, sigma_t = scattering_coefficients(scene, params,
                                             ray_o + ray_d * t_new, a)
        sigma_n = (maj - sigma_t).maximum(0.0)
        if spectral_mis:
            # each collision is a null event whose per-channel technique
            # pdf carries sigma_n_c / maj_c
            tr_det = Vec3(tr.x.detach(), tr.y.detach(), tr.z.detach())
            step_pdf = Vec3.where(esc, tr_det, maj_det * tr_det)
            pn = (Vec3(sigma_n.x.detach(), sigma_n.y.detach(),
                       sigma_n.z.detach()) / maj_det.maximum(1e-20))
            pn_h = torch.clamp(index_spectrum(pn, channel), min=1e-12)
            r_pdf = _mis_step(r_pdf, done, step_pdf, pdf_c, esc,
                              pn * (1.0 / pn_h))
        w_coll = w_step * sigma_n   # ratio-tracking null weight
        t = torch.where(done, t, t_new)
        w = Vec3.where(done, w, Vec3.where(esc, w_step, w_coll))
        done = done | esc
    w = w.mask(done)
    if spectral_mis:
        mis_w = 3.0 / torch.clamp(r_pdf.x + r_pdf.y + r_pdf.z, min=1e-30)
        w = Vec3.where(runnable, w * mis_w, w)
    out = Vec3.where(_lane_is_het(scene, med_idx), w, tr_homo)
    return Vec3.where(active & (med_idx >= 0), out, Vec3.ones(n, dev)), rng
