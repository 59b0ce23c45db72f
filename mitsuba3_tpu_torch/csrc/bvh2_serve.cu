// K8 on Hopper: the bvh2 supernode serve kernel.
//
// Replaces mitsuba3_tpu/ops/attic/bvh2.py:_serve_kernel, the Pallas TPU
// kernel launched by _serve_pallas. Its plain PyTorch version is serve_plain
// in mitsuba3_tpu_torch/ops/attic/bvh2.py (the function of the JAX
// package's XLA branch, _mt_block per served id); the wrapper serve there
// launches this kernel for CUDA tensors.
//
// What it computes. Rays live in chunks of 128; each lane of a chunk wants
// one supernode id (0x7FFFFFFF = none), and the chunk is served up to 4
// distinct ids. For each served id, the lanes that want it REPLACE their
// outputs with the supernode's best hit, a miss included: Moller-Trumbore
// against its 32 triangles (a supernode is [10, 32] f32: rows 0-8 p0, e1,
// e2 xyz, row 9 the prim id as f32, -1 for an empty slot); a hit needs det
// != 0, u >= 0, v >= 0, u + v <= 1, t in [0, tbest] and a prim id >= 0;
// the smallest t wins, ties to the largest prim id; a miss is (BIG, -1, 0,
// 0). Lanes served nothing keep (BIG, -1, 0, 0). An id past the supernode
// table (a padding supernode of the cull) is a miss, as the JAX package's
// out-of-range gather gives rows of NaN, which hit nothing.
//
// Design. One CTA of 128 threads per chunk, one thread per lane. The Pallas
// kernel gets its 4 blocks pre-gathered by XLA ([C, 4, 10, 32]); here the
// CTA reads each id's rows straight from the [M, 10, 32] table, which
// computes the same function without the copy. A served id that no lane
// wants is skipped by the whole CTA (__syncthreads_or, also the barrier
// before the next staging); otherwise its 10 rows (1.25 KB) are staged in
// shared memory, with its last slot holding a prim id >= 0, and only the
// wanting threads test them, up to that slot (the empty slots after it can
// never hit).
//
// What bounds it on the H100. Per wanting lane one test of ~53 fp32
// operations per real triangle of the supernode (terrain: 21.7 of 32 on
// average) on a 1.25 KB slab from L2 (3022 x 1.25 KB = 3.9 MB): bound by
// fp32 operations. chip_smoke.py measures both terms of
// the bound. Built with -fmad=false, so every operation rounds as in the
// plain version; 1.0f / det is IEEE division.

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 128;    // lanes per chunk = threads per CTA
constexpr int N_SERVE = 4;    // served ids per chunk
constexpr int LEAF = 32;      // triangles per supernode
constexpr int ROWS = 10;      // p0, e1, e2 (xyz each) and the prim id
constexpr int NONE_ID = 0x7FFFFFFF;
constexpr float BIG = 3.4e38f;

__global__ void __launch_bounds__(CHUNK)
serve_kernel(const float* __restrict__ tris, int n_nodes,
             const int* __restrict__ ids, const float* __restrict__ rays,
             const int* __restrict__ want, float* __restrict__ t_out,
             int* __restrict__ p_out, float* __restrict__ u_out,
             float* __restrict__ v_out) {
  __shared__ float slab[ROWS][LEAF];
  __shared__ int n_real[N_SERVE];  // per id: 1 + the last slot with id >= 0
  const long long lane = static_cast<long long>(blockIdx.x) * CHUNK +
                         threadIdx.x;
  if (threadIdx.x < N_SERVE) n_real[threadIdx.x] = 0;
  // rays is [C, 8, CHUNK]: ox oy oz dx dy dz (unused) tbest
  const float* r = rays + static_cast<long long>(blockIdx.x) * 8 * CHUNK +
                   threadIdx.x;
  const float ox = r[0], oy = r[CHUNK], oz = r[2 * CHUNK];
  const float dx = r[3 * CHUNK], dy = r[4 * CHUNK], dz = r[5 * CHUNK];
  const float tbest = r[7 * CHUNK];
  const int w = want[lane];
  float t_o = BIG, u_o = 0.0f, v_o = 0.0f;
  int p_o = -1;

  for (int k = 0; k < N_SERVE; ++k) {
    const int sid = ids[blockIdx.x * N_SERVE + k];
    const bool mine = w == sid && sid != NONE_ID;
    // a barrier too: every thread is done with the previous slab
    if (!__syncthreads_or(mine)) continue;
    if (sid >= n_nodes) {  // a padding supernode: a miss
      if (mine) {
        t_o = BIG;
        p_o = -1;
        u_o = v_o = 0.0f;
      }
      continue;
    }
    const float* src = tris + static_cast<long long>(sid) * (ROWS * LEAF);
    for (int i = threadIdx.x; i < ROWS * LEAF; i += CHUNK) {
      const float x = src[i];
      slab[i / LEAF][i % LEAF] = x;
      if (i / LEAF == 9 && x >= 0.0f) atomicMax(&n_real[k], i % LEAF + 1);
    }
    __syncthreads();
    if (!mine) continue;
    float tmin = BIG, uw = 0.0f, vw = 0.0f;
    int pw = -1;
    // the slots past the last real triangle hold id -1 and never hit
    const int n = n_real[k];
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
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
      const int id = static_cast<int>(slab[9][j]);
      const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                       t >= 0.0f && t <= tbest && id >= 0;
      if (hit && (t < tmin || (t == tmin && id > pw))) {
        tmin = t;
        pw = id;
        uw = u;
        vw = v;
      }
    }
    t_o = tmin;
    p_o = pw;
    u_o = uw;
    v_o = vw;
  }
  t_out[lane] = t_o;
  p_out[lane] = p_o;
  u_out[lane] = u_o;
  v_out[lane] = v_o;
}

}  // namespace

// tris [n_nodes, 10, 32] f32; ids [n_chunks, 4] i32 served ids (0x7FFFFFFF
// = none); rays [n_chunks, 8, 128] f32 rows ox oy oz dx dy dz (unused)
// tbest; want [n_chunks, 128] i32; outputs t_out, u_out, v_out [n_chunks,
// 128] f32 and p_out [n_chunks, 128] i32. Launches on `stream` and returns
// the launch's cudaError_t (0 = success).
extern "C" int bvh2_serve(const float* tris, int n_nodes, const int* ids,
                          const float* rays, const int* want, int n_chunks,
                          float* t_out, int* p_out, float* u_out,
                          float* v_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  serve_kernel<<<n_chunks, CHUNK, 0, s>>>(tris, n_nodes, ids, rays, want,
                                          t_out, p_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}
