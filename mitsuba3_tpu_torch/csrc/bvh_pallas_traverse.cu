// K5 on Hopper: the bvh_pallas packet traversal kernel (closest-hit and
// any-hit).
//
// Replaces mitsuba3_tpu/ops/attic/bvh_pallas.py:_traverse_kernel, the
// Pallas TPU kernel launched by _run. Its plain PyTorch version is
// traverse_plain in mitsuba3_tpu_torch/ops/attic/bvh_pallas.py; the wrapper
// traverse there launches this kernel for CUDA tensors.
//
// What it computes. Rays come in tiles of 1024; each tile walks the binary
// SAH BVH as one packet, from the root, with a stack of node ids shared by
// the tile. A popped node is visited when ANY ray of the tile passes its
// slab test (t_near <= t_far, t_far >= 0, t_near <= the ray's best t, with
// 1 / d taken as 1 / +-1e-20 where |d| < 1e-20). A visited inner node pushes
// its first child, then its second, so the second is popped next. A
// visited leaf tests all its triangles against every ray of the tile
// (Moller-Trumbore; a hit needs det != 0, u >= 0, v >= 0, u + v <= 1 and t
// in [0, best]). Closest mode: the leaf's smallest t, ties to the largest
// column, replaces the ray's best whenever the leaf has a hit, so a hit at
// the same t in a later leaf wins; the slot is leaf * 128 + column. Any-hit
// mode: a ray with a hit gets slot 1 and t -1, which drops it from later box
// tests. Rays start from their maxt (slot -1, u = v = 0).
//
// Design. One CTA of 1024 threads per tile, one thread per ray, which keeps
// its ray, 1 / d and its best (t, slot, u, v) in registers. The stack (128
// ids) and its pointer live in shared memory; thread 0 pushes and pops
// between barriers. The visit decision is __syncthreads_or(ray passes),
// which is also the barrier after which thread 0 may change the stack.
// Node boxes and metadata are read from global memory at the same address
// by every thread (broadcast; the 1513-node tree of terrain64k is 48 KB and
// stays in L1/L2). A visited leaf stages its 9 used rows (4.6 KB) in shared
// memory and every thread reads them as broadcasts, over the leaf's real
// triangles only (node_meta holds the count; the padding columns are zero
// triangles, which never hit).
//
// What bounds it on the H100. Per (tile, visited node) 1024 slab tests of
// ~25 fp32 operations, and per (tile, visited leaf) up to 128 x 1024
// triangle tests of ~52: the kernel is bound by fp32 operations, and the
// nodes a tile visits run one after another. chip_smoke.py measures both
// terms of the bound. Built with -fmad=false, so every operation rounds as
// in the plain version; 1.0f / x is IEEE division.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;     // rays per tile = threads per CTA
constexpr int STACK = 128;     // traversal stack depth
constexpr int K = 128;         // triangles per leaf slab
constexpr int SLAB_ROWS = 16;  // rows of a slab in device memory
constexpr int USED_ROWS = 9;   // p0, e1, e2 (xyz each)
constexpr float EPS = 1e-20f;
constexpr float BIG = 3.4e38f;

__device__ __forceinline__ float inv_dir(float c) {
  return 1.0f / (fabsf(c) < EPS ? (c >= 0.0f ? EPS : -EPS) : c);
}

template <bool CLOSEST>
__global__ void __launch_bounds__(TILE)
traverse_kernel(const float* __restrict__ nb, const int* __restrict__ nm,
                const float* __restrict__ tris, const float* __restrict__ o3,
                const float* __restrict__ d3, const float* __restrict__ mt,
                long long npad, float* __restrict__ t_out,
                int* __restrict__ slot_out, float* __restrict__ u_out,
                float* __restrict__ v_out) {
  __shared__ float slab[USED_ROWS][K];
  __shared__ int stack[STACK];
  __shared__ int sp;
  const long long ray = static_cast<long long>(blockIdx.x) * TILE +
                        threadIdx.x;
  const float ox = o3[ray], oy = o3[npad + ray], oz = o3[2 * npad + ray];
  const float dx = d3[ray], dy = d3[npad + ray], dz = d3[2 * npad + ray];
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  float best = mt[ray];
  int slot = -1;
  float best_u = 0.0f, best_v = 0.0f;
  if (threadIdx.x == 0) {
    stack[0] = 0;
    sp = 1;
  }
  __syncthreads();

  for (;;) {
    const int s = sp;
    if (s == 0) break;  // uniform: every thread read the same sp
    const int node = stack[s - 1];
    const float* b = nb + 8 * node;
    float t0 = (b[0] - ox) * ix, t1 = (b[3] - ox) * ix;
    float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
    t0 = (b[1] - oy) * iy;
    t1 = (b[4] - oy) * iy;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    t0 = (b[2] - oz) * iz;
    t1 = (b[5] - oz) * iz;
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
    const bool pass = tn <= tf && tf >= 0.0f && tn <= best;
    const int meta1 = nm[2 * node], meta2 = nm[2 * node + 1];
    // also a barrier: every thread has read sp and the stack top and is
    // done with the previous leaf's slab
    if (!__syncthreads_or(pass)) {
      if (threadIdx.x == 0) sp = s - 1;
      __syncthreads();
      continue;
    }
    if (meta1 >= 0) {  // inner node: push both children
      if (threadIdx.x == 0) {
        stack[s - 1] = meta1;
        stack[s] = meta2;
        sp = s + 1;
      }
      __syncthreads();
      continue;
    }
    const int leaf = -meta1 - 1;
    const int count = meta2 < K ? meta2 : K;
    const float* src = tris + static_cast<long long>(leaf) * (SLAB_ROWS * K);
    for (int i = threadIdx.x; i < USED_ROWS * K; i += TILE)
      slab[i / K][i % K] = src[i];
    if (threadIdx.x == 0) sp = s - 1;
    __syncthreads();
    if (best < 0.0f) continue;  // t in [0, best] is empty
    float tmin = BIG, uw = 0.0f, vw = 0.0f;
    int col = -1;
    for (int j = 0; j < count; ++j) {
      const float p0x = slab[0][j], p0y = slab[1][j], p0z = slab[2][j];
      const float e1x = slab[3][j], e1y = slab[4][j], e1z = slab[5][j];
      const float e2x = slab[6][j], e2y = slab[7][j], e2z = slab[8][j];
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
      const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                       t >= 0.0f && t <= best;
      if (!hit) continue;
      if (!CLOSEST) {
        col = j;
        break;
      }
      if (t <= tmin) {  // columns ascend: an equal t goes to the larger one
        tmin = t;
        col = j;
        uw = u;
        vw = v;
      }
    }
    if (col < 0) continue;
    if (CLOSEST) {
      best = tmin;
      slot = leaf * K + col;
      best_u = uw;
      best_v = vw;
    } else {
      best = -1.0f;
      slot = 1;
    }
  }
  t_out[ray] = best;
  slot_out[ray] = slot;
  if (CLOSEST) {
    u_out[ray] = best_u;
    v_out[ray] = best_v;
  }
}

}  // namespace

// nb [n_nodes, 8] f32 node boxes (lo xyz, hi xyz, 2 pad); nm [n_nodes, 2]
// i32 (children, or (-leaf - 1, count) at a leaf); tris [M, 16, 128] f32
// (rows 0-8 p0, e1, e2 xyz); o3, d3 [3, npad] and mt [npad] f32 with
// npad = 1024 * n_tiles; outputs t_out [npad] f32, slot_out [npad] i32 and,
// in closest mode, u_out, v_out [npad] f32 (any-hit leaves them alone).
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int bvh_pallas_traverse(const float* nb, const int* nm,
                                   const float* tris, const float* o3,
                                   const float* d3, const float* mt,
                                   int n_tiles, float* t_out, int* slot_out,
                                   float* u_out, float* v_out, int closest,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long npad = static_cast<long long>(n_tiles) * TILE;
  if (closest) {
    traverse_kernel<true><<<n_tiles, TILE, 0, s>>>(
        nb, nm, tris, o3, d3, mt, npad, t_out, slot_out, u_out, v_out);
  } else {
    traverse_kernel<false><<<n_tiles, TILE, 0, s>>>(
        nb, nm, tris, o3, d3, mt, npad, t_out, slot_out, u_out, v_out);
  }
  return static_cast<int>(cudaGetLastError());
}
