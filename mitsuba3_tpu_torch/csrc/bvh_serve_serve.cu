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
// Design. One CTA of 128 threads per block, one thread per ray. The CTA
// stages all 2 * TOPK slabs' 10 used rows (5 KB each) in shared memory at
// once, then walks them; "no ray wants it" is __syncthreads_or over the
// block, and every thread reads the triangles as broadcasts.
//
// What bounds it on the H100. A served slab costs 128 x 128 triangle tests
// of ~50 fp32 operations against 5 KB of slab read from L2 (terrain64k's
// slab table is 6.2 MB); the kernel is bound by fp32 operations on the
// slabs that are served, and by the 32 B of ray state read and 20 B written
// per ray otherwise. chip_smoke.py measures both terms of the bound. Built
// with -fmad=false, so every operation rounds as in the plain version;
// 1.0f / det is IEEE division.

#include <cuda_runtime.h>

namespace {

constexpr int BLK = 128;       // rays per block = threads per CTA
constexpr int K = 128;         // triangles per slab
constexpr int SLAB_ROWS = 16;  // rows of a slab in device memory
constexpr int USED_ROWS = 10;  // p0, e1, e2 (xyz each) and the prim id
constexpr float BIG = 3.4e38f;

template <int TOPK>
__global__ void __launch_bounds__(BLK)
serve_kernel(const float* __restrict__ tris, const int* __restrict__ blk_ids,
             const float* __restrict__ rays, const int* __restrict__ leaf,
             long long npad, float* __restrict__ t_out,
             int* __restrict__ p_out, float* __restrict__ u_out,
             float* __restrict__ v_out, int* __restrict__ srv_out) {
  constexpr int NSL = 2 * TOPK;
  __shared__ float slab[NSL][USED_ROWS][K];
  __shared__ int lids[NSL];
  const int lane = threadIdx.x;
  const long long ray = static_cast<long long>(blockIdx.x) * BLK + lane;
  if (lane < NSL) lids[lane] = blk_ids[blockIdx.x * NSL + lane];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NSL; ++j) {
    const float* src = tris + static_cast<long long>(lids[j]) *
                                  (SLAB_ROWS * K);
#pragma unroll
    for (int k = 0; k < USED_ROWS; ++k) slab[j][k][lane] = src[k * K + lane];
  }
  // rays is [R >= 7, npad]: ox oy oz dx dy dz tb
  const float ox = rays[ray], oy = rays[npad + ray], oz = rays[2 * npad + ray];
  const float dx = rays[3 * npad + ray], dy = rays[4 * npad + ray];
  const float dz = rays[5 * npad + ray], tb = rays[6 * npad + ray];
  int want_leaf[TOPK];
#pragma unroll
  for (int t = 0; t < TOPK; ++t) want_leaf[t] = leaf[t * npad + ray];
  __syncthreads();

  float best_t = BIG;
  int best_p = -1;
  float best_u = 0.0f, best_v = 0.0f;
  int srv = 0;
#pragma unroll
  for (int j = 0; j < NSL; ++j) {
    const int lid = lids[j];
    bool dup = false;
#pragma unroll
    for (int j2 = 0; j2 < j; ++j2) dup = dup || lids[j2] == lid;
    int bits = 0;
#pragma unroll
    for (int t = 0; t < TOPK; ++t)
      if (want_leaf[t] == lid) bits |= 1 << t;
    if (!__syncthreads_or(bits != 0) || dup || bits == 0) continue;
    float tmin = BIG;
    int pw = -1;
    float uw = 0.0f, vw = 0.0f;
#pragma unroll 4
    for (int i = 0; i < K; ++i) {
      const float p0x = slab[j][0][i], p0y = slab[j][1][i];
      const float p0z = slab[j][2][i];
      const float e1x = slab[j][3][i], e1y = slab[j][4][i];
      const float e1z = slab[j][5][i];
      const float e2x = slab[j][6][i], e2y = slab[j][7][i];
      const float e2z = slab[j][8][i];
      const float pvx = dy * e2z - dz * e2y;
      const float pvy = dz * e2x - dx * e2z;
      const float pvz = dx * e2y - dy * e2x;
      const float det = e1x * pvx + e1y * pvy + e1z * pvz;
      const bool ok = det != 0.0f;
      const float dinv = ok ? 1.0f / det : 0.0f;
      const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
      const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * dinv;
      const float qvx = tvy * e1z - tvz * e1y;
      const float qvy = tvz * e1x - tvx * e1z;
      const float qvz = tvx * e1y - tvy * e1x;
      const float v = (dx * qvx + dy * qvy + dz * qvz) * dinv;
      const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * dinv;
      const int id = static_cast<int>(slab[j][9][i]);
      const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                       t >= 0.0f && t <= tb && id >= 0;
      if (hit && (t < tmin || (t == tmin && id > pw))) {
        tmin = t;
        pw = id;
        uw = u;
        vw = v;
      }
    }
    if (tmin < best_t) {
      best_t = tmin;
      best_p = pw;
      best_u = uw;
      best_v = vw;
    }
    srv |= bits;
  }
  t_out[ray] = best_t;
  p_out[ray] = best_p;
  u_out[ray] = best_u;
  v_out[ray] = best_v;
  srv_out[ray] = srv;
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
    serve_kernel<1><<<n_blocks, BLK, 0, s>>>(tris, blk_ids, rays, leaf, npad,
                                             t_out, p_out, u_out, v_out,
                                             srv_out);
  } else if (topk == 2) {
    serve_kernel<2><<<n_blocks, BLK, 0, s>>>(tris, blk_ids, rays, leaf, npad,
                                             t_out, p_out, u_out, v_out,
                                             srv_out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
