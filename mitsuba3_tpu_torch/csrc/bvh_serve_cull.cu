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
// Design. One CTA of 512 threads per 512-ray block, one thread per ray,
// which keeps an ascending list of its TOPK smallest keys in registers (an
// insertion; ids are distinct, so it equals the Pallas chunk
// extract-and-merge). Leaves come in chunks of 128: per chunk every thread
// slab-tests the chunk's union box (the supernode), and the chunk is skipped
// for the whole block exactly when no ray of the block enters it
// (__syncthreads_or), as the Pallas kernel skips it. A chunk that is taken
// stages its 128 boxes (3 KB) in shared memory and every thread reads them
// as broadcasts. The slab test is sub, mul, min and max only, so the keys
// are bit-equal to the plain version's.
//
// What bounds it on the H100. Per ray and leaf the test is ~25 fp32
// operations on 24 bytes of box read from shared memory; the boxes
// (terrain64k: 768 x 24 B) sit in L2, and each ray reads 28 B and writes
// 4 B per rank, so the kernel is bound by fp32 operations, less the chunks
// skipped. chip_smoke.py measures both terms of the bound.

#include <cuda_runtime.h>

namespace {

constexpr int LC = 128;      // leaves per chunk
constexpr int RCHUNK = 512;  // rays per block = threads per CTA
constexpr int NONE = 0x7FFFFFFF;

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

template <int TOPK>
__global__ void __launch_bounds__(RCHUNK)
cull_kernel(const float* __restrict__ bounds, const float* __restrict__ sup,
            int m6, int supw, int n_leaves, const float* __restrict__ geo,
            const int* __restrict__ lk, long long npad,
            int* __restrict__ best) {
  __shared__ float box[6][LC];
  const long long ray = static_cast<long long>(blockIdx.x) * RCHUNK +
                        threadIdx.x;
  // geo is [R >= 7, npad]: ox oy oz dx dy dz tb
  const float ox = geo[ray], oy = geo[npad + ray], oz = geo[2 * npad + ray];
  const float ix = inv_dir(geo[3 * npad + ray]);
  const float iy = inv_dir(geo[4 * npad + ray]);
  const float iz = inv_dir(geo[5 * npad + ray]);
  const float tb = geo[6 * npad + ray];
  const int last = lk[ray];
  int keys[TOPK];
#pragma unroll
  for (int k = 0; k < TOPK; ++k) keys[k] = NONE;

  const int n_chunks = m6 / LC;
  for (int c = 0; c < n_chunks; ++c) {
    float tn, tf;
    slab_test(sup[c], sup[supw + c], sup[2 * supw + c], sup[3 * supw + c],
              sup[4 * supw + c], sup[5 * supw + c], ox, oy, oz, ix, iy, iz,
              tn, tf);
    const bool enters = tn <= tf && (tn > 0.0f ? tn : 0.0f) < tb;
    // a barrier too: every thread is done with the previous chunk's boxes
    if (!__syncthreads_or(enters)) continue;
    for (int k = threadIdx.x; k < 6 * LC; k += RCHUNK)
      box[k / LC][k % LC] = bounds[(k / LC) * m6 + c * LC + k % LC];
    __syncthreads();
    for (int i = 0; i < LC; ++i) {
      slab_test(box[0][i], box[1][i], box[2][i], box[3][i], box[4][i],
                box[5][i], ox, oy, oz, ix, iy, iz, tn, tf);
      const float entry = tn > 0.0f ? tn : 0.0f;
      const int id = c * LC + i + 1;
      const int key = static_cast<int>(
          (static_cast<unsigned>(__float_as_int(entry)) & 0xFFFF0000u) |
          static_cast<unsigned>(id));
      if (!(tn <= tf && entry < tb && key > last && id <= n_leaves) ||
          key >= keys[TOPK - 1])
        continue;
      // insert into the ascending list, dropping its largest key
#pragma unroll
      for (int s = TOPK - 1; s >= 0; --s) {
        if (s > 0 && keys[s - 1] > key) {
          keys[s] = keys[s - 1];
        } else {
          keys[s] = key;
          break;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < TOPK; ++k) best[k * npad + ray] = keys[k];
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
  if (topk == 1) {
    cull_kernel<1><<<n_blocks, RCHUNK, 0, s>>>(bounds, sup, m6, supw,
                                               n_leaves, geo, lk, npad, best);
  } else if (topk == 2) {
    cull_kernel<2><<<n_blocks, RCHUNK, 0, s>>>(bounds, sup, m6, supw,
                                               n_leaves, geo, lk, npad, best);
  } else if (topk == 8) {
    cull_kernel<8><<<n_blocks, RCHUNK, 0, s>>>(bounds, sup, m6, supw,
                                               n_leaves, geo, lk, npad, best);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
