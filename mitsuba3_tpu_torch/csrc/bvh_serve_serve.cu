// K3 on Hopper: the bvh_serve block serve kernel.
//
// Replaces mitsuba3_tpu/ops/bvh_serve.py:_serve_kernel, the Pallas TPU
// kernel launched by _serve_blocks (tile math: _mt_tile). Its plain PyTorch
// version is serve_blocks_plain in mitsuba3_tpu_torch/ops/bvh_serve.py; the
// wrapper serve_blocks there launches this kernel for CUDA tensors.
//
// What it computes. Rays are sorted by requested leaf and cut into blocks
// of 128. Each ray asks for up to TOPK leaves (leaf[t][ray], rank t; an
// inert ray asks for leaf m6, which no block serves). Block b gets 2 * TOPK
// leaf ids, rank-major: the first and last requested leaf of each rank.
// Slab j of the block, in order, is skipped if its id repeats an earlier
// slab of the block or if no ray of the block wants it (wants = one of its
// ranks asks for that leaf). Otherwise every wanting ray runs
// Moller-Trumbore over the slab's 128 triangles (a slab is [16, 128] f32:
// rows 0-8 p0, e1, e2 xyz, row 9 the prim id as f32): a hit needs det != 0,
// u >= 0, v >= 0, u + v <= 1, t in [0, tb] and id >= 0; the smallest t
// wins, ties to the largest id. The ray keeps the slab's hit only if its t
// is strictly below what earlier slabs gave, and ORs its wanting ranks into
// the served-rank bitmask srv. Outputs per ray: t (BIG = 3.4e38 if none),
// prim (-1), u, v, srv.
//
// What bounds it on the H100. A served slab costs, per wanting ray, one
// test of ~53 fp32 operations per real triangle (prim id >= 0; terrain64k's
// leaves hold 86 of 128 on average) against 5 KB of slab read from L2
// (terrain64k's slab table is 6.2 MB): the kernel is bound by fp32
// operations on the slabs that are served, and by the 32 B of ray state
// read and 20 B written per ray otherwise. What a test costs beyond its
// operations is what the design cuts: padding columns, slabs staged but
// not served (many blocks have first leaf = last leaf, and a block of
// inert rays wants nothing), and shared-memory loads. Built with
// -fmad=false, so every operation rounds as in the plain version;
// 1.0f / det is IEEE division.
//
// Design. One CTA of 16 warps per block: 4 groups of 32 rays, one ray per
// lane, and 4 warps per group that hold the same rays and split each slab's
// columns (warp w of a group tests columns w, w + 4, ...). A render's many
// late launches serve few blocks, and then a block's latency sets the
// launch's time: with one warp per 32 rays walking every column, K3 took
// 10.2 ms per terrain64k render against 6.8 ms with the split, for +4 % on
// a full-width round. (Compacting (ray, slab) pairs across warps would
// save the few lanes that idle in mixed warps, about 4 % of the tests on
// terrain64k.)
// - Decide first. From the slab ids and its ray's ranks (in registers),
//   each thread finds which slabs its ray wants; one warp OR and one shared
//   atomicOr per group give the block's wanted slabs, duplicates removed.
//   A block whose rays want nothing writes its outputs and exits.
// - Stage what is served. Each wanted slab is copied by cp.async into its
//   own shared buffer as three float4 per triangle, (p0.xyz, id),
//   (e1.xyz, -), (e2.xyz, -), one commit group per slab, all issued at
//   once: slab k + 1 is in flight while slab k is tested.
// - Test to the last real column. A warp ballot over the staged ids finds
//   the slab's last real column; no column after it is tested, while
//   earlier ones keep their id >= 0 test. A warp none of whose rays wants
//   the slab skips it.
// - Fold. After each slab the first warp of a group takes the group's four
//   partial results from shared memory, by the in-slab rule, and folds the
//   slab into its rays' best.
// The tie rules are the plain version's: in a slab the smallest t, ties to
// the largest id (one compare per test, and the same rule between a
// group's warps); a later slab replaces only with a strictly smaller t. So
// t, prim, u, v and srv are bit-equal to it.

#include <cuda_runtime.h>

namespace {

constexpr int BLK = 128;       // rays per block (one CTA)
constexpr int GROUPS = BLK / 32;  // 32-ray groups of a block
constexpr int SPLIT = 4;       // warps per group, over a slab's columns
constexpr int THREADS = 32 * GROUPS * SPLIT;
constexpr int K = 128;         // triangles per slab
constexpr int SLAB_ROWS = 16;  // rows of a slab in device memory
constexpr int USED_ROWS = 10;  // p0, e1, e2 (xyz each) and the prim id
constexpr int TRI_F = 12;      // floats per staged triangle (3 float4)
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

// Where slab row r (0..9) goes in a staged triangle: p0 xyz at 0-2, the id
// at 3, e1 xyz at 4-6, e2 xyz at 8-10.
__device__ __forceinline__ int tri_pos(int r) {
  return r == 9 ? 3 : r + r / 3;
}

// Copy a slab's 10 used rows into `buf` in the staged-triangle layout as
// one commit group (every thread of the CTA takes part).
__device__ __forceinline__ void stage_slab(float* buf, const float* src) {
  for (int e = threadIdx.x; e < USED_ROWS * K; e += THREADS) {
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(buf + (e % K) * TRI_F + tri_pos(e / K)));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + e)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `n` of this thread's commit groups are pending.
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// One past the last column of a staged slab with a prim id >= 0 (0 if
// none); every lane of the warp gets it.
__device__ __forceinline__ int real_cols(const float* buf) {
  const int lane = threadIdx.x & 31;
  for (int g = K / 32 - 1; g >= 0; --g) {
    const unsigned m = __ballot_sync(
        FULL, static_cast<int>(buf[(g * 32 + lane) * TRI_F + 3]) >= 0);
    if (m) return g * 32 + 32 - __clz(m);
  }
  return 0;
}

template <int TOPK>
__global__ void __launch_bounds__(THREADS)
serve_kernel(const float* __restrict__ tris, const int* __restrict__ blk_ids,
             const float* __restrict__ rays, const int* __restrict__ leaf,
             long long npad, float* __restrict__ t_out,
             int* __restrict__ p_out, float* __restrict__ u_out,
             float* __restrict__ v_out, int* __restrict__ srv_out) {
  constexpr int NSL = 2 * TOPK;
  static_assert(NSL <= 4, "wait_pending covers at most 4 groups");
  __shared__ __align__(16) float slab[NSL][K * TRI_F];
  __shared__ float4 part[GROUPS * SPLIT][32];  // (t, prim, u, v) per warp
  __shared__ unsigned s_wanted;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp / SPLIT, col0 = warp % SPLIT;
  const long long ray = static_cast<long long>(blockIdx.x) * BLK +
                        group * 32 + lane;
  int lids[NSL];
#pragma unroll
  for (int j = 0; j < NSL; ++j) lids[j] = blk_ids[blockIdx.x * NSL + j];
  int want_leaf[TOPK];
#pragma unroll
  for (int t = 0; t < TOPK; ++t) want_leaf[t] = leaf[t * npad + ray];
  // per slab, the ranks of this ray that want it; which slabs it wants;
  // which slabs repeat an earlier id
  int bits[NSL];
  unsigned mine = 0, dup = 0;
#pragma unroll
  for (int j = 0; j < NSL; ++j) {
    bits[j] = 0;
#pragma unroll
    for (int t = 0; t < TOPK; ++t)
      if (want_leaf[t] == lids[j]) bits[j] |= 1 << t;
    if (bits[j]) mine |= 1u << j;
#pragma unroll
    for (int j2 = 0; j2 < j; ++j2)
      if (lids[j2] == lids[j]) dup |= 1u << j;
  }
  if (threadIdx.x == 0) s_wanted = 0;
  __syncthreads();
  const unsigned warp_wants = __reduce_or_sync(FULL, mine);
  if (lane == 0 && col0 == 0 && warp_wants) atomicOr(&s_wanted, warp_wants);
  __syncthreads();
  const unsigned take = s_wanted & ~dup;

  float best_t = BIG;
  int best_p = -1;
  float best_u = 0.0f, best_v = 0.0f;
  int srv = 0;
  if (take) {
    int n_taken = 0;
#pragma unroll
    for (int j = 0; j < NSL; ++j)
      if (take >> j & 1)
        stage_slab(slab[n_taken++],
                   tris + static_cast<long long>(lids[j]) * (SLAB_ROWS * K));
    // rays is [R >= 7, npad]: ox oy oz dx dy dz tb
    const float ox = rays[ray], oy = rays[npad + ray];
    const float oz = rays[2 * npad + ray];
    const float dx = rays[3 * npad + ray], dy = rays[4 * npad + ray];
    const float dz = rays[5 * npad + ray], tb = rays[6 * npad + ray];
    int k = 0;
#pragma unroll
    for (int j = 0; j < NSL; ++j) {
      if (!(take >> j & 1)) continue;
      wait_pending(n_taken - 1 - k);
      __syncthreads();  // slab k is visible; the last fold is done
      const float* cur = slab[k++];
      const bool wanted = __any_sync(FULL, bits[j] != 0);
      float tmin = BIG;
      int pw = -1;
      float uw = 0.0f, vw = 0.0f;
      if (wanted) {
        const int n = real_cols(cur);
        const float4* tri = reinterpret_cast<const float4*>(cur);
#pragma unroll 2
        for (int i = col0; i < n; i += SPLIT) {
          const float4 a = tri[3 * i], e1 = tri[3 * i + 1],
                       e2 = tri[3 * i + 2];
          const float pvx = dy * e2.z - dz * e2.y;
          const float pvy = dz * e2.x - dx * e2.z;
          const float pvz = dx * e2.y - dy * e2.x;
          const float det = e1.x * pvx + e1.y * pvy + e1.z * pvz;
          const bool ok = det != 0.0f;
          const float dinv = ok ? 1.0f / det : 0.0f;
          const float tvx = ox - a.x, tvy = oy - a.y, tvz = oz - a.z;
          const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * dinv;
          const float qvx = tvy * e1.z - tvz * e1.y;
          const float qvy = tvz * e1.x - tvx * e1.z;
          const float qvz = tvx * e1.y - tvy * e1.x;
          const float v = (dx * qvx + dy * qvy + dz * qvz) * dinv;
          const float t = (e2.x * qvx + e2.y * qvy + e2.z * qvz) * dinv;
          const int id = static_cast<int>(a.w);
          const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                           t >= 0.0f && t <= tb && id >= 0;
          if (hit && (t < tmin || (t == tmin && id > pw))) {
            tmin = t;
            pw = id;
            uw = u;
            vw = v;
          }
        }
      }
      part[warp][lane] = make_float4(tmin, __int_as_float(pw), uw, vw);
      __syncthreads();
      if (col0 == 0 && bits[j]) {
        // the slab's best over the group's warps: smallest t, ties to the
        // largest id, as inside a warp
#pragma unroll
        for (int w = 1; w < SPLIT; ++w) {
          const float4 c = part[warp + w][lane];
          const int id = __float_as_int(c.y);
          if (c.x < tmin || (c.x == tmin && id > pw)) {
            tmin = c.x;
            pw = id;
            uw = c.z;
            vw = c.w;
          }
        }
        if (tmin < best_t) {
          best_t = tmin;
          best_p = pw;
          best_u = uw;
          best_v = vw;
        }
        srv |= bits[j];
      }
    }
  }
  if (col0 == 0) {
    t_out[ray] = best_t;
    p_out[ray] = best_p;
    u_out[ray] = best_u;
    v_out[ray] = best_v;
    srv_out[ray] = srv;
  }
}

}  // namespace

// tris [M, 16, 128] f32; blk_ids [n_blocks, 2 * topk] i32 (leaf ids in
// [0, M)); rays [R >= 7, npad] f32 rows ox oy oz dx dy dz tb; leaf
// [topk, npad] i32; outputs t, u, v [npad] f32 and prim, srv [npad] i32,
// npad = 128 * n_blocks; topk 1 or 2. Launches on `stream` and returns the
// launch's cudaError_t (0 = success; cudaErrorInvalidValue for another
// topk).
extern "C" int bvh_serve_serve(const float* tris, const int* blk_ids,
                               const float* rays, const int* leaf,
                               int n_blocks, int topk, float* t_out,
                               int* p_out, float* u_out, float* v_out,
                               int* srv_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long npad = static_cast<long long>(n_blocks) * BLK;
  if (topk == 1) {
    serve_kernel<1><<<n_blocks, THREADS, 0, s>>>(
        tris, blk_ids, rays, leaf, npad, t_out, p_out, u_out, v_out, srv_out);
  } else if (topk == 2) {
    serve_kernel<2><<<n_blocks, THREADS, 0, s>>>(
        tris, blk_ids, rays, leaf, npad, t_out, p_out, u_out, v_out, srv_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
