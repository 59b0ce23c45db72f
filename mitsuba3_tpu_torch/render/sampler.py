"""Samplers — counterpart of ``mitsuba3_tpu/render/sampler.py``
(src/samplers/{independent, stratified, multijitter, ldsampler,
orthogonal}.cpp).

One PCG32 stream per lane, seeded by TEA on (seed, global sample key),
where the key is ``pixel_id * spp + sample_idx``: a lane's stream depends
only on its pixel and sample, never on its position in the wavefront.
The structured samplers stratify on the lane's sample index and a
per-pixel hash (Kensler's permutation, the (0,2)-sequence, Bose's
orthogonal array) and take their jitter from the same PCG32 stream, so
every type draws the same PCG32 numbers in the same order.

uint32 lanes are int64 tensors masked to 32 bits (``core/random.py``);
every product and sum that wraps in the JAX package's uint32 arithmetic
is masked here, so the streams are bit-equal. The sampler type, spp, the
orthogonal grid's resolution and the dimension counter are host values
(every lane draws in lockstep); ``sample_idx``, ``pixel_hash`` and the
orthogonal sampler's ``bose_row`` are per-lane leaves, which the
``independent`` sampler does not keep.
"""
from __future__ import annotations

import math

import torch

from ..core.random import M32, PCG32, bits_to_float01, mul32, sample_tea_32
from ..core.struct import struct
from ..core.vec import Vec2

TYPES = ("independent", "stratified", "multijitter", "ldsampler",
         "orthogonal")


@struct
class Sampler:
    rng: PCG32
    dim: int = 0             # dimension counter (all lanes draw in lockstep)
    sample_idx: torch.Tensor | None = None  # [N] index within the pixel
    pixel_hash: torch.Tensor | None = None  # [N] pass-independent hash
    # orthogonal: the lane's row of the array, a permutation of its sample
    # index that every dimension shares
    bose_row: torch.Tensor | None = None
    spp: int = 0
    stype: str = "independent"
    res: int = 0             # orthogonal-array grid resolution


def _orthogonal_res(spp: int) -> int:
    """The smallest prime res with res^2 >= spp (orthogonal.cpp:93-110)."""
    def is_prime(v):
        return v > 1 and all(v % q for q in range(2, int(v ** 0.5) + 1))
    res = 2
    while res * res < max(int(spp), 1) or not is_prime(res):
        res += 1
    return res


def seed(seed_value: int, sample_idx, pixel_id, spp: int,
         stype: str = "independent", base_seed: int = 0) -> Sampler:
    """sampler.seed(seed, wavefront) (integrator.cpp:312). `sample_idx`
    (< spp) and `pixel_id` are int64 tensors of the wavefront's lanes;
    `base_seed` (the render's seed, not the pass seed) keys the per-pixel
    hash of the structured samplers."""
    if stype not in TYPES:
        raise ValueError(f"unknown sampler type {stype!r}")
    return _seeded(seed_value, (mul_spp(pixel_id, spp) + sample_idx) & M32,
                   sample_idx, pixel_id, spp, stype, base_seed)


def seed_lanes(seed_value: int, n: int, device) -> Sampler:
    """The anonymous seeding of JAX's ``seed(seed, n)`` (no sample index or
    pixel id), as the light tracer seeds its paths: an independent sampler
    whose streams are keyed by the lane index."""
    key = torch.arange(n, dtype=torch.int64, device=device)
    return _seeded(seed_value, key, None, None, 0, "independent", 0)


def _seeded(seed_value, key, sample_idx, pixel_id, spp: int, stype: str,
            base_seed: int) -> Sampler:
    v0, v1 = sample_tea_32(torch.full_like(key, int(seed_value) & M32), key)
    zeros = torch.zeros_like(v0)
    rng = PCG32.seed(zeros, v0, zeros, v1)
    if stype == "independent":
        return Sampler(rng=rng, spp=int(spp))
    # pass-independent (strata agree across the passes of one render) but
    # seed-dependent (renders with different seeds decorrelate)
    pixel_hash, _ = sample_tea_32(
        (pixel_id + 0x1234567) & M32,
        ((int(base_seed) & M32) * 0x9e3779b9 + 0x85ebca6b) & M32)
    if stype != "orthogonal":
        return Sampler(rng=rng, sample_idx=sample_idx, pixel_hash=pixel_hash,
                       spp=int(spp), stype=stype)
    res = _orthogonal_res(spp)
    row = _permute_kensler(sample_idx % (res * res), res * res,
                           pixel_hash ^ 0x94d049bb)
    return Sampler(rng=rng, sample_idx=sample_idx, pixel_hash=pixel_hash,
                   bose_row=row, spp=int(spp), stype=stype, res=res)


def mul_spp(pixel_id, spp: int):
    return (pixel_id * max(int(spp), 1)) & M32


def _permute_kensler(i, l: int, p):
    """Kensler 2013 cycle-walking permutation of [0, l) keyed by `p`
    (uint32 lanes in int64), for l <= 2^31. For a power-of-two l the
    scramble's final mask keeps every value below l, so the cycle walk's
    steps change nothing and are skipped."""
    if l <= 1:
        return torch.zeros_like(i)
    if l > 1 << 31:
        raise ValueError(f"Kensler permutation of length {l} > 2^31")
    w = l - 1
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    # The scramble ends masked to w = 2^k - 1, and each of its steps is
    # bitwise, a right shift of bits under w, or a product mod 2^32, whose
    # low k bits depend only on its operands' low k bits: so it runs mod
    # 2^k, where a product of two values below 2^31 fits in int64.
    # Adjacent constant products are folded (mod 2^32); the p-dependent
    # terms are shared by every step of the walk.
    pm, p16, p8, p23, p2 = (t & w for t in (p, p >> 16, p >> 8, p >> 23,
                                            p >> 2))
    p27 = (((1 | (p >> 27)) & w) * (0x6935fa69 & w)) & w
    c1, c2, c3, c4 = (c & w for c in (0xe170893d, 0x0929eb3f, 0x74dcca23,
                                      0x9e501cc3 * 0xc860a3df))

    def scramble(i):
        i = ((i ^ pm) * c1) & w
        i = i ^ p16
        i = i ^ (i >> 4)
        i = ((i ^ p8) * c2) & w
        i = i ^ p23
        i = i ^ (i >> 1)
        i = (i * p27) & w
        i = i ^ (i >> 11)
        i = (i * c3) & w
        i = ((i ^ p2) * c4) & w
        return i ^ (i >> 5)

    out = scramble(i)
    if w + 1 != l:
        for _ in range(7):
            out = torch.where(out >= l, scramble(out), out)
        return ((out + p) & M32) % l
    return (out + p) & w


def _reverse_bits32(x):
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    return ((x << 16) & M32) | (x >> 16)


def _sobol2(i, scramble, n_bits: int):
    """Second dimension of the (0,2)-sequence for indices below
    2^n_bits (the higher bits of i are zero and add nothing)."""
    r = scramble
    v = 1 << 31
    for b in range(n_bits):
        r = r ^ (((i >> b) & 1) * v)
        v ^= v >> 1
    return r


def _bose(s: Sampler, j: int, jitter):
    """Bose orthogonal-array construction, strength 2
    (orthogonal.cpp:214-243): dimension j of the lane's array row."""
    res = s.res
    p = s.pixel_hash ^ 0x94d049bb
    a_i0 = s.bose_row // res
    a_i1 = s.bose_row % res
    if j == 0:
        a_ij, a_ik = a_i0, a_i1
    elif j == 1:
        a_ij, a_ik = a_i1, a_i0
    else:
        k = j - 1 if j % 2 else j + 1
        a_ij = ((a_i0 + mul32(a_i1, (j - 1) & M32)) & M32) % res
        a_ik = ((a_i0 + mul32(a_i1, (k - 1) & M32)) & M32) % res
    stratum = _permute_kensler(
        a_ij, res, mul32(p, ((j + 1) * 0x51633e2d) & M32))
    sub_stratum = _permute_kensler(
        a_ik, res, mul32(p, ((j + 1) * 0x68bc21eb) & M32))
    rf = float(res)
    return (stratum.to(torch.float32)
            + (sub_stratum.to(torch.float32) + jitter) / rf) / rf


def _stratum_size(spp: int) -> int:
    k = int(math.sqrt(spp))
    return k if k * k == spp else 0


def next_1d(s: Sampler):
    rng, u = s.rng.next_float32()
    out = s.replace(rng=rng, dim=s.dim + 1)
    if s.stype == "independent" or s.spp <= 1:
        return out, u
    if s.stype in ("stratified", "multijitter"):
        p = s.pixel_hash ^ ((s.dim * 0x51633e2d) & M32)
        j = _permute_kensler(s.sample_idx, s.spp, p)
        return out, (j.to(torch.float32) + u) / s.spp
    if s.stype == "ldsampler":
        scr, _ = sample_tea_32(s.pixel_hash, s.dim)
        return out, bits_to_float01(_reverse_bits32(s.sample_idx) ^ scr)
    return out, _bose(s, s.dim, u)


def next_1d_block(s: Sampler, k: int):
    """k consecutive ``next_1d`` draws at once -> (sampler, [k, N]),
    bit-equal to the k calls: one jump-ahead of the PCG32 stream for the
    independent sampler (a tracking loop's draws in a few operations
    instead of k x 63), the calls themselves for the structured ones."""
    if s.stype == "independent" or s.spp <= 1:
        rng, u = s.rng.next_float32_block(k)
        return s.replace(rng=rng, dim=s.dim + k), u
    draws = []
    for _ in range(k):
        s, u = next_1d(s)
        draws.append(u)
    return s, torch.stack(draws)


def advance(s: Sampler, k: int) -> Sampler:
    """The sampler after k ``next_1d`` draws whose values are not needed:
    every sampler type draws one PCG32 number per dimension."""
    if k == 0:
        return s
    return s.replace(rng=s.rng.advance(k), dim=s.dim + k)


def next_2d(s: Sampler):
    rng, ux = s.rng.next_float32()
    rng, uy = rng.next_float32()
    out = s.replace(rng=rng, dim=s.dim + 2)
    if s.stype == "independent" or s.spp <= 1:
        return out, Vec2(ux, uy)
    k = _stratum_size(s.spp)
    f32 = torch.float32
    if s.stype == "stratified" and k:
        p = s.pixel_hash ^ ((s.dim * 0x68bc21eb) & M32)
        j = _permute_kensler(s.sample_idx, s.spp, p)
        return out, Vec2(((j % k).to(f32) + ux) / k,
                         ((j // k).to(f32) + uy) / k)
    if s.stype == "multijitter" and k:
        # Kensler CMJ: shuffled x within columns, y within rows
        p = s.pixel_hash ^ ((s.dim * 0x02e5be93) & M32)
        sidx = _permute_kensler(s.sample_idx, s.spp, p)
        sx = sidx % k
        sy = sidx // k
        jx = _permute_kensler(sx, k, mul32(p, 0x68bc21eb) ^ sy)
        jy = _permute_kensler(sy, k, mul32(p, 0x51633e2d) ^ sx)
        return out, Vec2((sx.to(f32) + (jy.to(f32) + ux) / k) / k,
                         (sy.to(f32) + (jx.to(f32) + uy) / k) / k)
    if s.stype == "ldsampler":
        scr1, scr2 = sample_tea_32(s.pixel_hash, s.dim)
        return out, Vec2(
            bits_to_float01(_reverse_bits32(s.sample_idx) ^ scr1),
            bits_to_float01(_sobol2(s.sample_idx, scr2,
                                    max(s.spp - 1, 1).bit_length())))
    if s.stype == "orthogonal":
        return out, Vec2(_bose(s, s.dim, ux), _bose(s, s.dim + 1, uy))
    # non-square spp: 1D-stratified per axis
    p = s.pixel_hash ^ ((s.dim * 0x68bc21eb) & M32)
    jf = _permute_kensler(s.sample_idx, s.spp, p).to(f32)
    return out, Vec2((jf + ux) / s.spp, (jf + uy) / s.spp)
