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
// ray runs Moller-Trumbore against the leaf's 128 triangles (a slab is
// [16, 128] f32: rows 0-8 p0, e1, e2 xyz, row 9 the prim id as f32):
// a hit needs det != 0, u >= 0, v >= 0, u + v <= 1 and t in [0, best].
// Closest mode: the slab's smallest t, ties to the largest prim id, and a
// hit replaces the best even at equal t (so a later slot wins a tie).
// Any-hit mode: an occluded ray gets prim 1 and t -1, which lowers the
// tile's worst t and ends its own later tests.
//
// Design. One CTA of 1024 threads per tile, one thread per ray, which
// keeps its ray and its running best in registers for the whole round and
// writes them once at the end. The worst t is a block reduction (warp
// shuffles, then one value per warp in shared memory). A slot that is taken
// stages the slab's 10 used rows (5 KB) in shared memory; every thread then
// reads the 128 triangles as broadcasts. The skip test is uniform over the
// CTA, so the barriers never diverge.
//
// What bounds it on the H100. terrain64k's whole slab table (759 leaves x
// 8 KB = 6.2 MB) fits in the 50 MB L2; each staged slab feeds 128 x 1024
// triangle tests of ~50 fp32 operations, so a taken slot is bound by fp32
// arithmetic. Slots skipped by the entry test cost one reduction.
// chip_smoke.py measures the operations and bytes terms of the bound. Built
// with -fmad=false, so every operation rounds as in the plain version;
// 1.0f / det is IEEE division.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;     // rays per tile = threads per CTA
constexpr int KT = 128;        // triangles per leaf slab
constexpr int SLOTS = 16;      // leaf slots per tile per round
constexpr int SLAB_ROWS = 16;  // rows of a slab in device memory
constexpr int USED_ROWS = 10;  // p0, e1, e2 (xyz each) and the prim id
constexpr float BIG = 3.4e38f;

// Max of x over the CTA; every thread gets the result. `red` holds one
// value per warp.
__device__ float block_max(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  __syncthreads();  // every thread is done with red and with the slab
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float y = red[threadIdx.x & 31];  // TILE / 32 = 32 warps
  for (int off = 16; off > 0; off >>= 1)
    y = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, off));
  return y;
}

template <bool CLOSEST>
__global__ void __launch_bounds__(TILE)
mt_kernel(const int* __restrict__ leaf_ids, const float* __restrict__ entries,
          const float* __restrict__ tris, const float* __restrict__ o3,
          const float* __restrict__ d3, const float* __restrict__ t_in,
          const int* __restrict__ prim_in, const float* __restrict__ u_in,
          const float* __restrict__ v_in, long long npad,
          float* __restrict__ t_out, int* __restrict__ prim_out,
          float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float slab[USED_ROWS][KT];
  __shared__ float red[32];
  const long long ray = static_cast<long long>(blockIdx.x) * TILE +
                        threadIdx.x;
  const float ox = o3[ray], oy = o3[npad + ray], oz = o3[2 * npad + ray];
  const float dx = d3[ray], dy = d3[npad + ray], dz = d3[2 * npad + ray];
  float best = t_in[ray];
  int best_p = prim_in[ray];
  float best_u = CLOSEST ? u_in[ray] : 0.0f;
  float best_v = CLOSEST ? v_in[ray] : 0.0f;

  for (int l = 0; l < SLOTS; ++l) {
    const int leaf = leaf_ids[blockIdx.x * SLOTS + l];
    const float entry = entries[blockIdx.x * SLOTS + l];
    const float worst = block_max(best, red);
    if (leaf < 0 || !(entry <= worst)) continue;  // uniform over the CTA
    const float* src = tris + static_cast<long long>(leaf) * (SLAB_ROWS * KT);
    for (int i = threadIdx.x; i < USED_ROWS * KT; i += TILE)
      slab[i / KT][i % KT] = src[i];
    __syncthreads();
    if (!CLOSEST && best < 0.0f) continue;  // occluded: t in [0, -1] is empty
    float tmin = BIG;
    int pw = -1;
    float uw = 0.0f, vw = 0.0f;
#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
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
        pw = 1;
        break;
      }
      const int id = static_cast<int>(slab[9][j]);
      if (t < tmin || (t == tmin && id > pw)) {
        tmin = t;
        pw = id;
        uw = u;
        vw = v;
      }
    }
    if (CLOSEST && pw >= 0) {
      best = tmin;
      best_p = pw;
      best_u = uw;
      best_v = vw;
    } else if (!CLOSEST && pw >= 0) {
      best = -1.0f;
      best_p = 1;
    }
  }
  t_out[ray] = best;
  prim_out[ray] = best_p;
  if (CLOSEST) {
    u_out[ray] = best_u;
    v_out[ray] = best_v;
  }
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
    mt_kernel<true><<<n_tiles, TILE, 0, s>>>(leaf_ids, entries, tris, o3, d3,
                                            t_in, prim_in, u_in, v_in, npad,
                                            t_out, prim_out, u_out, v_out);
  } else {
    mt_kernel<false><<<n_tiles, TILE, 0, s>>>(leaf_ids, entries, tris, o3,
                                             d3, t_in, prim_in, u_in, v_in,
                                             npad, t_out, prim_out, u_out,
                                             v_out);
  }
  return static_cast<int>(cudaGetLastError());
}
