// K4 on Hopper: the bvh_tiled round kernel (closest-hit and any-hit).
//
// Replaces mitsuba3_tpu/ops/bvh_tiled.py:_mt_kernel, the Pallas TPU kernel
// launched by _run_round. Its plain PyTorch version is run_round_plain in
// mitsuba3_tpu_torch/ops/bvh_tiled.py; the wrapper run_round there launches
// this kernel for CUDA tensors.
//
// What it computes. Rays are coherence-sorted and cut into tiles of 1024.
// Each tile has, for this round, 16 leaf slots sorted by the conservative
// entry distance of its frustum (leaf id -1 = none). Starting from the
// previous round's best (t, prim, u, v) per ray, the tile walks its slots
// in order. Before each slot it takes the tile's worst running t (the max
// over its 1024 rays, after the previous slot's writes) and skips the slot
// if the leaf id is < 0 or its entry is beyond that worst t. Otherwise every
// ray runs Moller-Trumbore against the leaf's triangles (a slab is
// [16, 128] f32: rows 0-8 p0, e1, e2 xyz, row 9 the prim id as f32):
// a hit needs det != 0, u >= 0, v >= 0, u + v <= 1 and t in [0, best].
// Closest mode: the slab's smallest t, ties to the largest prim id, and a
// hit replaces the best even at equal t (so a later slot wins a tie).
// Any-hit mode: an occluded ray gets prim 1 and t -1, which lowers the
// tile's worst t and ends its own later tests. Slab columns after the last
// one with a prim id >= 0 are padding (zero edges, det = 0, never a hit)
// and are not tested.
//
// What bounds it on the H100. terrain64k's whole slab table (759 leaves x
// 8 KB = 6.2 MB) sits in the 50 MB L2, and each taken slot feeds up to
// 128 x 1024 tests of 52 fp32 operations, so a taken slot is bound by fp32
// arithmetic (the bound counts 52 operations per test of a real triangle).
// What a test costs beyond those 52 is what the design below cuts: the
// shared-memory loads and barriers around it, the padding columns, and in
// any-hit mode the lanes that idle behind a ray that is already occluded.
// A render's later rounds leave few tiles with slots to take, and then a
// tile's own latency sets the launch's time: more threads per tile won
// over fewer loads per test there (measured over a terrain64k render:
// closest mode with 256 threads x 4 rays or 512 x 2 was slower than
// 1024 x 1, and any-hit mode slower at 128, 256 or 512 threads than at
// 1024, which needs the slab in shared memory to fit its registers). Built
// with -fmad=false, so every operation rounds as in the plain version;
// 1.0f / det is IEEE division.
//
// Design, closest mode: a CTA of 1024 threads per tile, each thread holding
// one ray and its running best in registers. A taken slot's slab is staged
// with cp.async into shared memory as three float4 per triangle,
// (p0.xyz, id), (e1.xyz, -), (e2.xyz, -), so a thread reads a triangle
// with three broadcast 128-bit loads (10 32-bit loads in the row layout). The next candidate slot (the next with leaf >= 0 and
// entry <= the current worst, which only falls) is copied into a second
// buffer while the current one is tested; the barrier of the worst-t
// reduction publishes it, and if the falling worst skips it the right slab
// is staged then. One barrier per taken slot, and the slot decision stays
// the tile's, as in the plain version.
//
// Design, any-hit mode: lanes over triangles, not lanes over rays. A CTA
// of 1024 threads per tile keeps the tile's rays (o, d, t) in shared
// memory (28 KB) and stages each taken slot's slab there in the layout
// above; lane i of a warp tests the columns i, i + 32, ... Warps take
// batches of 32 rays from a shared counter, skip those already occluded or
// inactive (t < 0) with one ballot, and test each live ray against the
// slab's real columns 32 at a time, with __any_sync after each group: the
// first group with a hit occludes the ray and the warp moves on. No lane
// waits behind a finished ray, and a ray overshoots its first hit by
// fewer than 32 tests. Two barriers per taken slot: the staged slab's and
// the worst-t reduction's.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE = 1024;     // rays per tile = threads per CTA
constexpr int KT = 128;        // triangles per leaf slab
constexpr int SLOTS = 16;      // leaf slots per tile per round
constexpr int SLAB_ROWS = 16;  // rows of a slab in device memory
constexpr int USED_ROWS = 10;  // p0, e1, e2 (xyz each) and the prim id
constexpr int GROUPS = KT / 32;  // 32-column groups of a slab
constexpr int TRI_F = 12;      // floats per staged triangle (3 float4)
constexpr unsigned FULL = 0xffffffffu;

// Where slab row r (0..9) goes in a staged triangle: p0 xyz at 0-2, the id
// at 3, e1 xyz at 4-6, e2 xyz at 8-10.
__device__ __forceinline__ int tri_pos(int r) {
  return r == 9 ? 3 : r + r / 3;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy a slab's 10 used rows into `buf` in the staged-triangle layout
// (every thread of the CTA takes part; completes at cp_async_wait_all).
__device__ __forceinline__ void stage_slab(float* buf, const float* src) {
  for (int e = threadIdx.x; e < USED_ROWS * KT; e += TILE)
    cp_async4(buf + (e % KT) * TRI_F + tri_pos(e / KT), src + e);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One past the last column of a staged slab with a prim id >= 0 (0 if
// none); every lane of the warp gets it.
__device__ __forceinline__ int real_cols(const float* buf) {
  const int lane = threadIdx.x & 31;
  for (int g = GROUPS - 1; g >= 0; --g) {
    const unsigned m = __ballot_sync(
        FULL, static_cast<int>(buf[(g * 32 + lane) * TRI_F + 3]) >= 0);
    if (m) return g * 32 + 32 - __clz(m);
  }
  return 0;
}

// Max of x over the CTA; every thread gets it. `red` holds one value per
// warp; callers alternate between two of them, so that one barrier
// suffices (a buffer is written again only after the next barrier).
__device__ __forceinline__ float tile_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float y = red[0];
#pragma unroll
  for (int w = 1; w < TILE / 32; ++w) y = fmaxf(y, red[w]);
  return y;
}

// The first slot after `l` that the tile takes at worst t `worst`, or SLOTS.
__device__ __forceinline__ int next_slot(int l, float worst, const int* leaf,
                                         const float* entry) {
  for (++l; l < SLOTS; ++l)
    if (leaf[l] >= 0 && entry[l] <= worst) break;
  return l;
}

// Moller-Trumbore of one ray against one triangle, in the plain version's
// operation order. Returns whether (det != 0, u, v) make a hit before the
// t-range test, with t, u and v.
__device__ __forceinline__ bool mt_test(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float p0x, float p0y, float p0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        float& t, float& u, float& v) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok = det != 0.0f;
  const float dinv = ok ? 1.0f / det : 0.0f;
  const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * dinv;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (dx * qvx + dy * qvy + dz * qvz) * dinv;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * dinv;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

template <bool CLOSEST>
__global__ void mt_kernel(const int* __restrict__ leaf_ids,
                          const float* __restrict__ entries,
                          const float* __restrict__ tris,
                          const float* __restrict__ o3,
                          const float* __restrict__ d3,
                          const float* __restrict__ t_in,
                          const int* __restrict__ prim_in,
                          const float* __restrict__ u_in,
                          const float* __restrict__ v_in, long long npad,
                          float* __restrict__ t_out,
                          int* __restrict__ prim_out,
                          float* __restrict__ u_out,
                          float* __restrict__ v_out);

// Closest mode: one ray per thread, slabs double-buffered in shared memory.
template <>
__global__ void __launch_bounds__(TILE, 1) mt_kernel<true>(
    const int* __restrict__ leaf_ids, const float* __restrict__ entries,
    const float* __restrict__ tris, const float* __restrict__ o3,
    const float* __restrict__ d3, const float* __restrict__ t_in,
    const int* __restrict__ prim_in, const float* __restrict__ u_in,
    const float* __restrict__ v_in, long long npad,
    float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ __align__(16) float slab[2][KT * TRI_F];
  __shared__ float red[2][TILE / 32];
  __shared__ int s_leaf[SLOTS];
  __shared__ float s_entry[SLOTS];
  const long long ray = static_cast<long long>(blockIdx.x) * TILE +
                        threadIdx.x;
  const float ox = o3[ray], oy = o3[npad + ray], oz = o3[2 * npad + ray];
  const float dx = d3[ray], dy = d3[npad + ray], dz = d3[2 * npad + ray];
  float best = t_in[ray], best_u = u_in[ray], best_v = v_in[ray];
  int best_p = prim_in[ray];
  if (threadIdx.x < SLOTS) {
    s_leaf[threadIdx.x] = leaf_ids[blockIdx.x * SLOTS + threadIdx.x];
    s_entry[threadIdx.x] = entries[blockIdx.x * SLOTS + threadIdx.x];
  }
  int par = 0;
  float worst = tile_max(best, red[par]);
  int l = next_slot(-1, worst, s_leaf, s_entry);
  int b = 0;
  if (l < SLOTS) {
    stage_slab(slab[0],
               tris + static_cast<long long>(s_leaf[l]) * (SLAB_ROWS * KT));
    cp_async_wait_all();
    __syncthreads();
  }
  while (l < SLOTS) {
    // slab[b] holds slot l's leaf; prefetch the next candidate into the
    // other buffer (nobody reads it: its last reader passed the barrier)
    const int cand = next_slot(l, worst, s_leaf, s_entry);
    if (cand < SLOTS)
      stage_slab(slab[b ^ 1], tris + static_cast<long long>(s_leaf[cand]) *
                                         (SLAB_ROWS * KT));
    const float4* tri = reinterpret_cast<const float4*>(slab[b]);
    const int n = real_cols(slab[b]);
    // this slot's winner; tw starts at the best t, which makes
    // "t < tw || (t == tw && id > pw)" the plain version's "t <= best,
    // then smallest t, ties to the largest id"
    float tw = best, uw = 0.0f, vw = 0.0f;
    int pw = -1;
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      const float4 a = tri[3 * j], e1 = tri[3 * j + 1], e2 = tri[3 * j + 2];
      const int id = static_cast<int>(a.w);
      float t, u, v;
      const bool ok = mt_test(ox, oy, oz, dx, dy, dz, a.x, a.y, a.z, e1.x,
                              e1.y, e1.z, e2.x, e2.y, e2.z, t, u, v);
      if (ok && t >= 0.0f && (t < tw || (t == tw && id > pw))) {
        tw = t;
        pw = id;
        uw = u;
        vw = v;
      }
    }
    if (pw >= 0) {
      best = tw;
      best_p = pw;
      best_u = uw;
      best_v = vw;
    }
    if (cand < SLOTS) cp_async_wait_all();
    par ^= 1;
    // the barrier also publishes the prefetched slab
    worst = tile_max(best, red[par]);
    const int nxt = next_slot(l, worst, s_leaf, s_entry);
    if (nxt < SLOTS && nxt != cand) {  // the falling worst skipped cand
      stage_slab(slab[b ^ 1], tris + static_cast<long long>(s_leaf[nxt]) *
                                         (SLAB_ROWS * KT));
      cp_async_wait_all();
      __syncthreads();
    }
    l = nxt;
    b ^= 1;
  }
  t_out[ray] = best;
  prim_out[ray] = best_p;
  u_out[ray] = best_u;
  v_out[ray] = best_v;
}

// Any-hit mode: rays and the slab in shared memory, lanes over columns.
template <>
__global__ void __launch_bounds__(TILE, 1) mt_kernel<false>(
    const int* __restrict__ leaf_ids, const float* __restrict__ entries,
    const float* __restrict__ tris, const float* __restrict__ o3,
    const float* __restrict__ d3, const float* __restrict__ t_in,
    const int* __restrict__ prim_in, const float* __restrict__ u_in,
    const float* __restrict__ v_in, long long npad,
    float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ __align__(16) float slab[KT * TRI_F];
  __shared__ float s_ray[6][TILE];
  __shared__ float s_t[TILE];
  __shared__ float red[2][TILE / 32];
  __shared__ int s_next[2];
  __shared__ int s_leaf[SLOTS];
  __shared__ float s_entry[SLOTS];
  const int lane = threadIdx.x & 31;
  const int i = threadIdx.x;  // this thread's ray slot in the tile
  const long long ray = static_cast<long long>(blockIdx.x) * TILE + i;
  for (int c = 0; c < 3; ++c) {
    s_ray[c][i] = o3[c * npad + ray];
    s_ray[3 + c][i] = d3[c * npad + ray];
  }
  const float t0 = t_in[ray];
  s_t[i] = t0;
  if (threadIdx.x < SLOTS) {
    s_leaf[threadIdx.x] = leaf_ids[blockIdx.x * SLOTS + threadIdx.x];
    s_entry[threadIdx.x] = entries[blockIdx.x * SLOTS + threadIdx.x];
  }
  if (threadIdx.x < 2) s_next[threadIdx.x] = 0;
  int par = 0;
  float worst = tile_max(t0, red[par]);
  const float4* tri = reinterpret_cast<const float4*>(slab);
  for (int l = next_slot(-1, worst, s_leaf, s_entry); l < SLOTS;
       l = next_slot(l, worst, s_leaf, s_entry)) {
    int* counter = &s_next[par];
    if (threadIdx.x == 0) s_next[par ^ 1] = 0;
    stage_slab(slab,
               tris + static_cast<long long>(s_leaf[l]) * (SLAB_ROWS * KT));
    cp_async_wait_all();
    __syncthreads();
    const int n = real_cols(slab);
    const int groups = (n + 31) / 32;
    float m = -CUDART_INF_F;
    for (;;) {
      int b0 = 0;
      if (lane == 0) b0 = atomicAdd(counter, 32);
      b0 = __shfl_sync(FULL, b0, 0);
      if (b0 >= TILE) break;
      float tl = s_t[b0 + lane];
      for (unsigned live = __ballot_sync(FULL, tl >= 0.0f); live;
           live &= live - 1) {
        const int q = __ffs(live) - 1;
        const int r = b0 + q;
        const float ox = s_ray[0][r], oy = s_ray[1][r], oz = s_ray[2][r];
        const float dx = s_ray[3][r], dy = s_ray[4][r], dz = s_ray[5][r];
        const float tb = s_t[r];
        bool occluded = false;
        for (int g = 0; g < groups; ++g) {
          const int j = g * 32 + lane;
          bool hit = false;
          if (j < n) {
            const float4 a = tri[3 * j], e1 = tri[3 * j + 1],
                         e2 = tri[3 * j + 2];
            float t, u, v;
            hit = mt_test(ox, oy, oz, dx, dy, dz, a.x, a.y, a.z, e1.x, e1.y,
                          e1.z, e2.x, e2.y, e2.z, t, u, v) &&
                  t >= 0.0f && t <= tb;
          }
          if (__any_sync(FULL, hit)) {
            occluded = true;
            break;
          }
        }
        if (occluded) {
          if (lane == 0) s_t[r] = -1.0f;
          if (lane == q) tl = -1.0f;
        }
      }
      m = fmaxf(m, tl);
    }
    par ^= 1;
    worst = tile_max(m, red[par]);  // every warp is done
  }
  const float t = s_t[i];
  t_out[ray] = t;
  prim_out[ray] = (t0 >= 0.0f && t < 0.0f) ? 1 : prim_in[ray];
}

}  // namespace

// leaf_ids [n_tiles, 16] i32 and entries [n_tiles, 16] f32 (this round's
// slots); tris [M, 16, 128] f32; o3, d3 [3, npad] f32; t_in, u_in, v_in
// [npad] f32 and prim_in [npad] i32 with npad = 1024 * n_tiles; outputs
// t_out, prim_out and, in closest mode, u_out, v_out (any-hit leaves them
// alone; they may be null). Launches on `stream` and returns the launch's
// cudaError_t (0 = success).
extern "C" int bvh_tiled_mt(const int* leaf_ids, const float* entries,
                            const float* tris, const float* o3,
                            const float* d3, const float* t_in,
                            const int* prim_in, const float* u_in,
                            const float* v_in, int n_tiles, float* t_out,
                            int* prim_out, float* u_out, float* v_out,
                            int closest, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long npad = static_cast<long long>(n_tiles) * TILE;
  if (closest) {
    mt_kernel<true><<<n_tiles, TILE, 0, s>>>(
        leaf_ids, entries, tris, o3, d3, t_in, prim_in, u_in, v_in, npad,
        t_out, prim_out, u_out, v_out);
  } else {
    mt_kernel<false><<<n_tiles, TILE, 0, s>>>(
        leaf_ids, entries, tris, o3, d3, t_in, prim_in, u_in, v_in, npad,
        t_out, prim_out, u_out, v_out);
  }
  return static_cast<int>(cudaGetLastError());
}
