"""Vectorized PCG32 + TEA hashing — counterpart of ``mitsuba3_tpu/core/random.py``.

Bit-equal to the JAX package. PyTorch has no unsigned 32-bit add, shift or
compare on every backend, so each 32-bit lane is kept in an int64 tensor
masked with ``0xFFFFFFFF`` after every operation that can leave
[0, 2^32). Products are split so that no int64 intermediate exceeds 2^49:
an unmasked int64 product of two 32-bit lanes would overflow.
"""
from __future__ import annotations

import functools

import torch

from .struct import struct

M32 = 0xFFFFFFFF
PCG32_DEFAULT_STREAM_HI = 0xda3e39cb
PCG32_DEFAULT_STREAM_LO = 0x94b95bdb
PCG32_MULT_HI = 0x5851f42d
PCG32_MULT_LO = 0x4c957f2d


def mul32(a, b):
    """(a * b) mod 2^32 for 32-bit lanes held in int64."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & M32


def umul32_wide(a, b):
    """Full 64-bit product of two 32-bit lanes -> (hi, lo)."""
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = lh + (ll >> 16) + (hl & 0xFFFF)
    lo = ((mid << 16) | (ll & 0xFFFF)) & M32
    hi = (hh + (hl >> 16) + (mid >> 16)) & M32
    return hi, lo


def u64_add(a_hi, a_lo, b_hi, b_lo):
    lo = (a_lo + b_lo) & M32
    carry = (lo < a_lo).to(torch.int64)
    hi = (a_hi + b_hi + carry) & M32
    return hi, lo


def u64_mul(a_hi, a_lo, b_hi, b_lo):
    """(a * b) mod 2^64 for (hi, lo) pairs."""
    hi, lo = umul32_wide(a_lo, b_lo)
    hi = (hi + mul32(a_lo, b_hi) + mul32(a_hi, b_lo)) & M32
    return hi, lo


def bits_to_float01(bits):
    """U[0,1) from the top 23 bits: (bits >> 9) | 0x3f800000, minus 1."""
    f = ((bits >> 9) | 0x3f800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def _output(old_hi, old_lo):
    """PCG32's output function on a state: ((state >> 18) ^ state) >> 27,
    rotated right by state >> 59."""
    x_lo = old_lo ^ (((old_hi << 14) & M32) | (old_lo >> 18))
    x_hi = old_hi ^ (old_hi >> 18)
    xorshifted = (x_lo >> 27) | ((x_hi << 5) & M32)
    rot = old_hi >> 27
    return (xorshifted >> rot) | ((xorshifted << ((-rot) & 31)) & M32)


@functools.lru_cache(maxsize=64)
def _jump_tables(k: int, device):
    """(A_hi, A_lo, C_hi, C_lo), each [k + 1] int64 on `device`: the
    jump-ahead multipliers and increments of j = 0..k PCG32 steps."""
    mult = (PCG32_MULT_HI << 32) | PCG32_MULT_LO
    a, c = [1], [0]
    for _ in range(k):
        a.append(a[-1] * mult % (1 << 64))
        c.append((c[-1] * mult + 1) % (1 << 64))
    return tuple(torch.tensor([v >> 32 if hi else v & M32 for v in vals],
                              dtype=torch.int64, device=device)
                 for vals, hi in ((a, True), (a, False), (c, True),
                                  (c, False)))


@struct
class PCG32:
    """SoA PCG32 state: one generator per lane, 32-bit halves in int64."""
    state_hi: torch.Tensor
    state_lo: torch.Tensor
    inc_hi: torch.Tensor
    inc_lo: torch.Tensor

    @staticmethod
    def seed(initstate_hi, initstate_lo, initseq_hi, initseq_lo):
        """pcg32_srandom_r: state=0; inc=(seq<<1)|1; step; state+=init; step."""
        inc_hi = ((initseq_hi << 1) & M32) | (initseq_lo >> 31)
        inc_lo = ((initseq_lo << 1) & M32) | 1
        zeros = torch.zeros_like(inc_lo)
        rng = PCG32(state_hi=zeros, state_lo=zeros, inc_hi=inc_hi,
                    inc_lo=inc_lo)
        rng, _ = rng.next_uint32()
        sh, sl = u64_add(rng.state_hi, rng.state_lo, initstate_hi,
                         initstate_lo)
        rng = rng.replace(state_hi=sh, state_lo=sl)
        rng, _ = rng.next_uint32()
        return rng

    def next_uint32(self):
        """Advance every lane. Returns (new_rng, bits)."""
        old_hi, old_lo = self.state_hi, self.state_lo
        mh, ml = u64_mul(old_hi, old_lo, PCG32_MULT_HI, PCG32_MULT_LO)
        nh, nl = u64_add(mh, ml, self.inc_hi, self.inc_lo)
        return self.replace(state_hi=nh, state_lo=nl), _output(old_hi, old_lo)

    def next_uint32_block(self, k: int):
        """k draws per lane at once -> (rng advanced k steps, bits [k, N]),
        bit-equal to k calls of ``next_uint32``: the j-th state is
        A_j state + C_j inc (mod 2^64), A_j = MULT^j and
        C_j = MULT^(j-1) + ... + 1 (the LCG's jump-ahead)."""
        a_hi, a_lo, c_hi, c_lo = _jump_tables(k, self.state_hi.device)
        mh, ml = u64_mul(self.state_hi[None], self.state_lo[None],
                         a_hi[:, None], a_lo[:, None])
        ch, cl = u64_mul(self.inc_hi[None], self.inc_lo[None],
                         c_hi[:, None], c_lo[:, None])
        sh, sl = u64_add(mh, ml, ch, cl)           # states 0..k, [k+1, N]
        return (self.replace(state_hi=sh[k], state_lo=sl[k]),
                _output(sh[:k], sl[:k]))

    def advance(self, k: int):
        """The stream k draws ahead (the draws themselves skipped)."""
        a_hi, a_lo, c_hi, c_lo = _jump_tables(k, self.state_hi.device)
        mh, ml = u64_mul(self.state_hi, self.state_lo, a_hi[k], a_lo[k])
        ch, cl = u64_mul(self.inc_hi, self.inc_lo, c_hi[k], c_lo[k])
        sh, sl = u64_add(mh, ml, ch, cl)
        return self.replace(state_hi=sh, state_lo=sl)

    def next_float32(self):
        rng, bits = self.next_uint32()
        return rng, bits_to_float01(bits)

    def next_float32_block(self, k: int):
        rng, bits = self.next_uint32_block(k)
        return rng, bits_to_float01(bits)


def sample_tea_32(v0, v1, rounds: int = 4):
    """TEA hash (random.h:77-90): two 32-bit lanes -> two mixed lanes."""
    total = 0
    for _ in range(rounds):
        total = (total + 0x9e3779b9) & M32
        v0 = (v0 + (((((v1 << 4) & M32) + 0xa341316c) & M32)
                    ^ ((v1 + total) & M32)
                    ^ (((v1 >> 5) + 0xc8013ea4) & M32))) & M32
        v1 = (v1 + (((((v0 << 4) & M32) + 0xad90777d) & M32)
                    ^ ((v0 + total) & M32)
                    ^ (((v0 >> 5) + 0x7e95761e) & M32))) & M32
    return v0, v1
