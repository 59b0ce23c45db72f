// K7 on Hopper: the bvh_queue serve-multi kernel (a block's scheduled leaf
// slabs folded into every ray of the block).
//
// Replaces mitsuba3_tpu/ops/attic/bvh_queue.py:_serve_multi_kernel, the
// Pallas TPU kernel launched by _serve_multi. Its plain PyTorch version is
// serve_multi_plain in mitsuba3_tpu_torch/ops/attic/bvh_queue.py; the
// wrapper serve_multi there launches this kernel for CUDA tensors.
//
// What it computes. Rays are sorted by the head of their leaf queue and cut
// into blocks of 128. Each block has a schedule of 16 leaf ids (-1 = none)
// that the host simulated from its rays' queues. Every ray of the block
// starts from t = BIG (prim -1, u = v = 0) and a bound tbc = its best t so
// far, and takes every scheduled slab in order, whether or not it asked for
// it: the slab's best hit (Moller-Trumbore; a hit needs det != 0, u >= 0,
// v >= 0, u + v <= 1, t in [0, tbc] and a prim id >= 0; the smallest t
// wins, ties to the largest prim id) replaces the running result only with
// a strictly smaller t, and tbc then drops to the running t. A slab is
// [16, 128] f32: rows 0-8 p0, e1, e2 xyz, row 9 the prim id as f32.
//
// Design. One CTA of 128 threads per block, one thread per ray, which keeps
// its ray and running result in registers. The block's 16 ids are read once
// into shared memory; a -1 slot is skipped by the whole CTA (the Pallas
// kernel still copies leaf 0 there and masks it). A taken slot stages the
// slab's 10 used rows (5 KB) in shared memory, read by every thread as
// broadcasts, and notes its last column with a prim id >= 0: the columns
// after it (a leaf's padding) can never hit, so no thread tests them.
//
// What bounds it on the H100. Per taken slot and ray with tb >= 0, one test
// of ~53 fp32 operations per real triangle of the slab (terrain: 86.6 of
// 128 on average) on a 5 KB slab from L2 (757 leaves x 8 KB = 6.2 MB, in
// the 50 MB L2): the kernel is bound by fp32 operations.
// chip_smoke.py measures both terms of the bound. Built with -fmad=false, so
// every operation rounds as in the plain version; 1.0f / det is IEEE
// division.

#include <cuda_runtime.h>

namespace {

constexpr int BLK = 128;       // rays per block = threads per CTA
constexpr int T = 16;          // scheduled slots per block
constexpr int K = 128;         // triangles per leaf slab
constexpr int SLAB_ROWS = 16;  // rows of a slab in device memory
constexpr int USED_ROWS = 10;  // p0, e1, e2 (xyz each) and the prim id
constexpr float BIG = 3.4e38f;

__global__ void __launch_bounds__(BLK)
serve_multi_kernel(const int* __restrict__ ids, const float* __restrict__ tris,
                   const float* __restrict__ rays, long long npad,
                   float* __restrict__ t_out, int* __restrict__ p_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float slab[USED_ROWS][K];
  __shared__ int lids[T];
  __shared__ int n_real[T];  // per slot: 1 + the last column with id >= 0
  const long long ray = static_cast<long long>(blockIdx.x) * BLK +
                        threadIdx.x;
  if (threadIdx.x < T) {
    lids[threadIdx.x] = ids[blockIdx.x * T + threadIdx.x];
    n_real[threadIdx.x] = 0;
  }
  // rays is [R >= 7, npad]: ox oy oz dx dy dz tb
  const float ox = rays[ray], oy = rays[npad + ray],
              oz = rays[2 * npad + ray];
  const float dx = rays[3 * npad + ray], dy = rays[4 * npad + ray],
              dz = rays[5 * npad + ray];
  float tbc = rays[6 * npad + ray];
  float tcur = BIG, ucur = 0.0f, vcur = 0.0f;
  int pcur = -1;
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int lid = lids[s];
    if (lid < 0) continue;  // uniform over the CTA
    __syncthreads();        // every thread is done with the previous slab
    const float* src = tris + static_cast<long long>(lid) * (SLAB_ROWS * K);
    for (int i = threadIdx.x; i < USED_ROWS * K; i += BLK) {
      const float x = src[i];
      slab[i / K][i % K] = x;
      if (i / K == 9 && x >= 0.0f) atomicMax(&n_real[s], i % K + 1);
    }
    __syncthreads();
    if (tbc < 0.0f) continue;  // t in [0, tbc] is empty
    float tmin = BIG, uw = 0.0f, vw = 0.0f;
    int pw = -1;
    // the columns past the last real triangle hold id -1 and never hit
    const int n = n_real[s];
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
                       t >= 0.0f && t <= tbc && id >= 0;
      if (hit && (t < tmin || (t == tmin && id > pw))) {
        tmin = t;
        pw = id;
        uw = u;
        vw = v;
      }
    }
    if (pw >= 0 && tmin < tcur) {
      tcur = tmin;
      pcur = pw;
      ucur = uw;
      vcur = vw;
    }
    tbc = fminf(tbc, tcur);
  }
  t_out[ray] = tcur;
  p_out[ray] = pcur;
  u_out[ray] = ucur;
  v_out[ray] = vcur;
}

}  // namespace

// ids [n_blocks, 16] i32 leaf ids (-1 = none); tris [M, 16, 128] f32; rays
// [R >= 7, npad] f32 rows ox oy oz dx dy dz tb with npad = 128 * n_blocks;
// outputs t_out, u_out, v_out [npad] f32 and p_out [npad] i32. Launches on
// `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int bvh_queue_serve(const int* ids, const float* tris,
                               const float* rays, int n_blocks, float* t_out,
                               int* p_out, float* u_out, float* v_out,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long npad = static_cast<long long>(n_blocks) * BLK;
  serve_multi_kernel<<<n_blocks, BLK, 0, s>>>(ids, tris, rays, npad, t_out,
                                              p_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}
