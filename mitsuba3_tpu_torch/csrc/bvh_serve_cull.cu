// K2 and K6 on Hopper: the bvh_serve cull kernel (nearest unvisited leaves).
//
// Replaces mitsuba3_tpu/ops/bvh_serve.py:_cull_kernel, the Pallas TPU
// kernel launched by _cull. Its plain PyTorch version is cull_plain in
// mitsuba3_tpu_torch/ops/bvh_serve.py; the wrapper cull there launches this
// kernel for CUDA tensors with TOPK 1 or 2.
//
// With TOPK = 8 it also replaces mitsuba3_tpu/ops/attic/bvh_queue.py:
// _cull_topk_kernel (launched by _cull_topk), which computes the same
// function with a queue of KQ = 8 keys: its 8 repeated min extractions over
// a chunk's keys and its running 8 give the 8 smallest, since ids are
// distinct. The wrapper cull_topk of mitsuba3_tpu_torch/ops/attic/
// bvh_queue.py launches it, and its plain version is cull_topk_plain there.
//
// What it computes. For each ray (origin, direction, best t so far `tb`,
// last served key `lk`) and each leaf box, the slab test gives
// (t_near, t_far) and entry = max(t_near, 0) (+0.0 for -0.0). The packed
// key is (f32 bits of entry with the low 16 bits cleared) | (leaf id + 1).
// A key counts when t_near <= t_far, entry < tb, key > lk and leaf id + 1
// <= n_leaves (the pad boxes hold inverted +/-BIG bounds whose slab
// arithmetic overflows and would pass). The output is each ray's TOPK
// smallest counting keys, ascending, padded with NONE = 0x7FFFFFFF.
//
// What bounds it on the H100. Per ray and leaf the test is ~29 fp32 and
// integer operations on 24 bytes of box; the boxes (terrain64k: 768 x 24 B)
// sit in L2, and each ray reads 28 B and writes 4 B per rank, so the kernel
// is bound by operations on the leaves that the data needs: per live ray,
// each chunk's union box and the real leaves of the chunks it enters.
// Late in a query most rays are done, and bvh_serve's round loop gives a
// ray that is done the cursor NONE. What a test costs beyond its
// operations is what the design cuts: work for rays that cannot yield a
// key, 32-ray groups that no ray of enters a chunk, the pad leaves of the
// last chunk, and, in a render's many narrow late launches (a few
// thousand rays, set by one CTA's latency), a single warp walking every
// leaf of every chunk it enters.
//
// Design. One CTA of 4 warps per 32 rays: each warp holds the same 32 rays,
// one per lane, and tests a quarter of each chunk's leaves (warp w the
// leaves 32 w .. 32 w + 31 of the chunk), keeping an ascending list of its
// TOPK smallest keys per ray in registers (an insertion; ids are distinct,
// so it equals the Pallas chunk extract-and-merge). At the end warp 0
// merges the four lists through shared memory: the TOPK smallest of the
// union are the TOPK smallest of the four lists' keys. So a narrow launch
// spreads over four times the warps, with no barrier before the merge.
// - Inert rays. A ray with lk == NONE can yield no key (an int32 key never
//   exceeds 0x7FFFFFFF), nor can one with tb <= 0 (entry >= 0). Such a ray
//   enters no chunk; a CTA whose rays are all inert writes NONE without
//   looking at a chunk. bvh_serve sorts finished rays to the end of the
//   width, so a late round has many such CTAs. The rule is exact for every
//   caller, K6's included.
// - Chunks. Leaves come in chunks of 128. A ray enters a chunk when it
//   passes the slab test of the chunk's union box (the supernode); the
//   CTA skips a chunk that none of its 32 rays enters (__any_sync; the
//   Pallas kernel skips a chunk for a block of 512). The skip is exact: a
//   leaf box lies inside its chunk's union box, and the slab arithmetic
//   (sub, mul by a fixed-sign inverse, min, max) is monotone under
//   rounding, so a ray that fails the union box fails every leaf box of the
//   chunk.
// - Staging. Lane l of warp w loads the box of leaf 32 w + l of the next
//   chunk it takes into registers (coalesced row loads) while the warp
//   tests the current chunk, and stores it into the warp's own shared slot
//   as 8 floats, (lo.xyz, hi.x) and (hi.yz, -, -): a thread reads a box
//   with one 128-bit and one 64-bit broadcast load, and the warps never
//   wait for each other.
// - Leaves. A warp's loop stops at the chunk's last real leaf
//   (n_leaves - 128 c) in place of a per-leaf id test, and
//   lk < key < (the list's largest key) is one unsigned compare of
//   key - (lk + 1) against a limit kept with the list.
// The slab test is sub, mul, min and max only, so the keys are bit-equal to
// the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int LC = 128;       // leaves per chunk
constexpr int RCHUNK = 512;   // rays per block of the caller (width unit)
constexpr int WARPS = 4;      // warps per CTA, each over a quarter chunk
constexpr int LW = LC / WARPS;  // leaves per warp per chunk = 32 lanes
constexpr int THREADS = 32 * WARPS;
constexpr int BOX_F = 8;      // floats per staged box: lo.xyz hi.x | hi.yz
constexpr int NONE = 0x7FFFFFFF;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float inv_dir(float c) {
  return 1.0f / (fabsf(c) < 1e-9f ? (c < 0.0f ? -1e-9f : 1e-9f) : c);
}

// Slab test of box (lo xyz, hi xyz) against the ray; the operation order
// is the plain version's.
__device__ __forceinline__ void slab_test(
    float lox, float loy, float loz, float hix, float hiy, float hiz,
    float ox, float oy, float oz, float ix, float iy, float iz, float& tn,
    float& tf) {
  float t0 = (lox - ox) * ix, t1 = (hix - ox) * ix;
  tn = fminf(t0, t1);
  tf = fmaxf(t0, t1);
  t0 = (loy - oy) * iy;
  t1 = (hiy - oy) * iy;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (loz - oz) * iz;
  t1 = (hiz - oz) * iz;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
}

struct Ray {
  float ox, oy, oz, ix, iy, iz, tb;
  bool busy;  // can yield a key: lk != NONE and tb > 0
};

// The first chunk after c that a ray of the warp enters, or n_chunks.
__device__ __forceinline__ int next_chunk(int c, int n_chunks,
                                          const float* __restrict__ sup,
                                          int supw, const Ray& r) {
  for (++c; c < n_chunks; ++c) {
    bool enters = false;
    if (r.busy) {
      float tn, tf;
      slab_test(__ldg(sup + c), __ldg(sup + supw + c),
                __ldg(sup + 2 * supw + c), __ldg(sup + 3 * supw + c),
                __ldg(sup + 4 * supw + c), __ldg(sup + 5 * supw + c), r.ox,
                r.oy, r.oz, r.ix, r.iy, r.iz, tn, tf);
      enters = tn <= tf && (tn > 0.0f ? tn : 0.0f) < r.tb;
    }
    if (__any_sync(FULL, enters)) return c;
  }
  return n_chunks;
}

// Insert `key` into the ascending list `keys`, dropping its largest key;
// the caller has checked key < keys[TOPK - 1]. Selects only, so the list
// stays in registers.
template <int TOPK>
__device__ __forceinline__ void insert(int (&keys)[TOPK], int key) {
#pragma unroll
  for (int s = TOPK - 1; s > 0; --s)
    keys[s] = keys[s - 1] > key ? keys[s - 1]
                                : (keys[s] > key ? key : keys[s]);
  keys[0] = min(keys[0], key);
}

template <int TOPK>
__global__ void __launch_bounds__(THREADS)
cull_kernel(const float* __restrict__ bounds, const float* __restrict__ sup,
            int m6, int supw, int n_leaves, const float* __restrict__ geo,
            const int* __restrict__ lk, long long npad,
            int* __restrict__ best) {
  __shared__ __align__(16) float box[WARPS][LW * BOX_F];
  __shared__ int part[WARPS - 1][TOPK][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = static_cast<long long>(blockIdx.x) * 32 + lane;
  // geo is [R >= 7, npad]: ox oy oz dx dy dz tb
  const int last = lk[ray];
  Ray r;
  r.tb = geo[6 * npad + ray];
  r.busy = last != NONE && r.tb > 0.0f;
  int keys[TOPK];
#pragma unroll
  for (int k = 0; k < TOPK; ++k) keys[k] = NONE;
  if (__any_sync(FULL, r.busy)) {  // the same answer in every warp
    r.ox = geo[ray];
    r.oy = geo[npad + ray];
    r.oz = geo[2 * npad + ray];
    r.ix = inv_dir(geo[3 * npad + ray]);
    r.iy = inv_dir(geo[4 * npad + ray]);
    r.iz = inv_dir(geo[5 * npad + ray]);
    // last < key < keys[TOPK - 1] <=> key - base < lim, unsigned (exact for
    // every int32 last below keys[TOPK - 1]); an inert ray takes nothing
    const unsigned base = static_cast<unsigned>(last) + 1u;
    unsigned lim = r.busy ? static_cast<unsigned>(NONE) - base : 0u;
    const int n_chunks = m6 / LC;
    float* slot = box[warp];
    // this lane's leaf of chunk c, and how many leaves of it this warp has
    auto leaf_of = [&](int c) { return c * LC + warp * LW + lane; };
    auto count = [&](int c) {
      return max(0, min(LW, n_leaves - c * LC - warp * LW));
    };
    float nb[6];
    int c = next_chunk(-1, n_chunks, sup, supw, r);
    if (c < n_chunks && lane < count(c)) {
#pragma unroll
      for (int k = 0; k < 6; ++k) nb[k] = __ldg(bounds + k * m6 + leaf_of(c));
    }
    while (c < n_chunks) {
      const int n = count(c);
      __syncwarp();  // every lane is done with the previous chunk's boxes
      if (lane < n) {
        *reinterpret_cast<float4*>(slot + lane * BOX_F) =
            make_float4(nb[0], nb[1], nb[2], nb[3]);
        *reinterpret_cast<float2*>(slot + lane * BOX_F + 4) =
            make_float2(nb[4], nb[5]);
      }
      __syncwarp();
      const int cn = next_chunk(c, n_chunks, sup, supw, r);
      if (cn < n_chunks && lane < count(cn)) {
#pragma unroll
        for (int k = 0; k < 6; ++k)
          nb[k] = __ldg(bounds + k * m6 + leaf_of(cn));
      }
      const int id0 = c * LC + warp * LW + 1;
      for (int i = 0; i < n; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(slot + i * BOX_F);
        const float2 b = *reinterpret_cast<const float2*>(slot + i * BOX_F + 4);
        float tn, tf;
        slab_test(a.x, a.y, a.z, a.w, b.x, b.y, r.ox, r.oy, r.oz, r.ix, r.iy,
                  r.iz, tn, tf);
        const float entry = tn > 0.0f ? tn : 0.0f;
        const int key = static_cast<int>(
            (static_cast<unsigned>(__float_as_int(entry)) & 0xFFFF0000u) |
            static_cast<unsigned>(id0 + i));
        if (tn <= tf && entry < r.tb &&
            static_cast<unsigned>(key) - base < lim) {
          insert(keys, key);
          lim = static_cast<unsigned>(keys[TOPK - 1]) - base;
        }
      }
      c = cn;
    }
  }
  // merge the four lists into warp 0's
  if (warp > 0) {
#pragma unroll
    for (int k = 0; k < TOPK; ++k) part[warp - 1][k][lane] = keys[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int w = 0; w < WARPS - 1; ++w) {
#pragma unroll
      for (int k = 0; k < TOPK; ++k) {
        const int key = part[w][k][lane];
        if (key < keys[TOPK - 1]) insert(keys, key);
      }
    }
#pragma unroll
    for (int k = 0; k < TOPK; ++k) best[k * npad + ray] = keys[k];
  }
}

}  // namespace

// bounds [8, m6] f32 (rows lo xyz, hi xyz, 2 pad); sup [8, supw] f32 chunk
// union boxes (same rows); geo [R >= 7, npad] f32 rows ox oy oz dx dy dz tb;
// lk [npad] i32; best [topk, npad] i32 out, npad = 512 * n_blocks; topk 1
// or 2 (bvh_serve) or 8 (bvh_queue). Launches on `stream` and returns the
// launch's cudaError_t (0 = success; cudaErrorInvalidValue for another
// topk).
extern "C" int bvh_serve_cull(const float* bounds, const float* sup, int m6,
                              int supw, int n_leaves, const float* geo,
                              const int* lk, int n_blocks, int* best,
                              int topk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long npad = static_cast<long long>(n_blocks) * RCHUNK;
  const int grid = n_blocks * (RCHUNK / 32);
  if (topk == 1) {
    cull_kernel<1><<<grid, THREADS, 0, s>>>(bounds, sup, m6, supw,
                                              n_leaves, geo, lk, npad, best);
  } else if (topk == 2) {
    cull_kernel<2><<<grid, THREADS, 0, s>>>(bounds, sup, m6, supw,
                                              n_leaves, geo, lk, npad, best);
  } else if (topk == 8) {
    cull_kernel<8><<<grid, THREADS, 0, s>>>(bounds, sup, m6, supw,
                                              n_leaves, geo, lk, npad, best);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
