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
// What bounds it on the H100. Per taken slot and ray with tbc >= 0, one
// test of 53 fp32 operations per real triangle of the slab (terrain: 86.6
// of 128 on average) on a 5 KB slab from L2 (757 leaves x 8 KB = 6.2 MB,
// in the 50 MB L2): the kernel is bound by fp32 operations, and
// chip_smoke.py measures both terms of the bound. What the first port of K7
// spent beyond them, and what this design does about it:
// - Staging: each taken slot's 10 rows were copied with plain loads and a
//   barrier, nothing overlapping the copy, though the block's 16 ids are
//   known from the start. Now the next taken slot is staged by cp.async
//   into a second buffer while the current one is tested (the id row by a
//   register load whose value is stored after the tests), one barrier per
//   taken slot.
// - The last real column took 128 shared atomicMax calls on one word per
//   slot; now each warp finds it with ballots over the staged ids.
// - Ten 32-bit shared loads and a float-to-int conversion of the id per
//   test: a triangle is now staged as three float4, (p0, id), (e1, -),
//   (e2, -), with the id converted to an int once per column at staging,
//   and read with three broadcast 128-bit loads.
// - The IEEE reciprocal 1 / det: a range test, a branch to its slow path
//   and a reconvergence per test besides its arithmetic. Now the fast path
//   runs alone and notes the smallest and largest |det| of the pass; a ray
//   whose slab held a det outside the fast path's range tests that slab
//   again with IEEE division (rcp in mt_exact.cuh).
// - Selects: a test keeps the slab's running t, id and column (the tie
//   rule's compares only where t <= the running t), and u and v of the
//   slab's winner are computed again once, where it improves the ray.
// In all, SASS instructions a test (tools/sass_loops.py) fell from 95.2 in
// the first port to 71.5, against the 53 counted operations.
//
// Design. One CTA of 128 threads per block, one thread per ray, which
// keeps its ray and running result in registers, built for eight CTAs an
// SM. The block's 16 ids are read once into shared memory; a -1 slot is
// skipped by the whole CTA (the Pallas kernel still copies leaf 0 there
// and masks it). Measured on bench_bvh's terrain (PERF.md): two
// rays a thread in 64-thread CTAs was 1 % slower on the primary rays'
// schedule and 2.5 % faster on the bounce rays' (on an earlier form of
// this kernel); the tie rule as predicates instead of a branch, or the
// test loop unrolled four times or not at all, was slower. Built with
// -fmad=false, so every operation rounds as in the plain version; 1 / det
// rounds as IEEE division.

#include <cuda_runtime.h>

#include "mt_exact.cuh"

namespace {

constexpr int BLK = 128;       // rays per block = threads per CTA
constexpr int T = 16;          // scheduled slots per block
constexpr int K = 128;         // triangles per leaf slab
constexpr int SLAB_ROWS = 16;  // rows of a slab in device memory
constexpr int XYZ_ROWS = 9;    // p0, e1, e2 (xyz each); row 9 is the id
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

// Issue the copy of a slab's rows 0-8 into `buf` (p0 xyz at floats 0-2 of
// a triangle, e1 at 4-6, e2 at 8-10) as one cp.async group, and load this
// thread's id column, which finish_slab stores.
__device__ __forceinline__ float stage_slab(float4* buf, const float* src) {
  float* dst = reinterpret_cast<float*>(buf);
  for (int e = threadIdx.x; e < XYZ_ROWS * K; e += BLK) {
    const int r = e / K, c = e % K;
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + c * 12 + r + r / 3));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + e)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return __ldg(src + XYZ_ROWS * K + threadIdx.x);
}

// Store the id loaded by stage_slab, as an int, into p0.w of this thread's
// column, and wait for the copy (a barrier must follow).
__device__ __forceinline__ void finish_slab(float4* buf, float idf) {
  buf[3 * threadIdx.x].w = __int_as_float(static_cast<int>(idf));
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One past the last column of a staged slab with a prim id >= 0 (0 if
// none); every lane of the warp gets it.
__device__ __forceinline__ int real_cols(const float4* buf) {
  const int lane = threadIdx.x & 31;
  for (int g = K / 32 - 1; g >= 0; --g) {
    const unsigned m = __ballot_sync(
        FULL, __float_as_int(buf[3 * (g * 32 + lane)].w) >= 0);
    if (m) return g * 32 + 32 - __clz(m);
  }
  return 0;
}

// The first slot after `s` with a leaf id >= 0, or T.
__device__ __forceinline__ int next_taken(int s, const int* lids) {
  for (++s; s < T; ++s)
    if (lids[s] >= 0) break;
  return s;
}

// The best hit of one ray in the first n columns of a staged slab: t in
// [0, tw] (tw starts at the ray's bound), the smallest t, ties to the
// largest id; tw and pw (from -1) become its t and id. Returns its column,
// or -1.
template <bool EXACT>
__device__ __forceinline__ int slab_best(const float4* tri, int n, float ox,
                                         float oy, float oz, float dx,
                                         float dy, float dz, float& tw,
                                         int& pw, Range& rg) {
  int jw = -1;
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    float t, u, v;
    const int id = __float_as_int(tri[3 * j].w);
    // (tw, pw) starts at (bound, -1): "t <= tw" is "t <= bound, then the
    // smallest t", and at t == tw the larger id wins
    const bool take = mt_test<EXACT>(ox, oy, oz, dx, dy, dz, tri + 3 * j, t,
                                     u, v, rg) &&
                      t >= 0.0f && t <= tw && id >= 0 &&
                      (t < tw || id > pw);
    tw = take ? t : tw;
    pw = take ? id : pw;
    jw = take ? j : jw;
  }
  return jw;
}

__global__ void __launch_bounds__(BLK, 8)
serve_multi_kernel(const int* __restrict__ ids, const float* __restrict__ tris,
                   const float* __restrict__ rays, long long npad,
                   float* __restrict__ t_out, int* __restrict__ p_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float4 slab[2][3 * K];
  __shared__ int lids[T];
  if (threadIdx.x < T) lids[threadIdx.x] = ids[blockIdx.x * T + threadIdx.x];
  // rays is [R >= 7, npad]: ox oy oz dx dy dz tb
  const long long ray = static_cast<long long>(blockIdx.x) * BLK +
                        threadIdx.x;
  const float ox = rays[ray], oy = rays[npad + ray],
              oz = rays[2 * npad + ray];
  const float dx = rays[3 * npad + ray], dy = rays[4 * npad + ray],
              dz = rays[5 * npad + ray];
  float tbc = rays[6 * npad + ray];
  float tcur = BIG, ucur = 0.0f, vcur = 0.0f;
  int pcur = -1;
  __syncthreads();

  int s = next_taken(-1, lids);
  if (s < T) {
    finish_slab(slab[0], stage_slab(slab[0], tris + static_cast<long long>(
                                                        lids[s]) *
                                                        (SLAB_ROWS * K)));
    __syncthreads();
  }
  for (int b = 0; s < T; b ^= 1) {
    // slab[b] holds slot s; stage the next taken slot into the other
    // buffer, whose last readers passed the barrier below
    const int nx = next_taken(s, lids);
    float idf = 0.0f;
    if (nx < T)
      idf = stage_slab(slab[b ^ 1], tris + static_cast<long long>(lids[nx]) *
                                               (SLAB_ROWS * K));
    const float4* tri = slab[b];
    const int n = real_cols(tri);
    if (tbc >= 0.0f) {  // t in [0, tbc] is empty otherwise (or tbc NaN)
      // as in the plain version, no hit beyond BIG is taken
      const float bound = fminf(tbc, BIG);
      float tw = bound;
      int pw = -1;
      Range rg;
      int jw = slab_best<false>(tri, n, ox, oy, oz, dx, dy, dz, tw, pw, rg);
      if (rg.slow()) {  // a det outside the fast reciprocal's range
        tw = bound;
        pw = -1;
        jw = slab_best<true>(tri, n, ox, oy, oz, dx, dy, dz, tw, pw, rg);
      }
      if (jw >= 0 && tw < tcur) {
        // the winner's u and v, by the same arithmetic as its test
        float t;
        mt_test<true>(ox, oy, oz, dx, dy, dz, tri + 3 * jw, t, ucur, vcur,
                      rg);
        tcur = tw;
        pcur = pw;
      }
      tbc = fminf(tbc, tcur);
    }
    if (nx < T) finish_slab(slab[b ^ 1], idf);
    __syncthreads();  // slot nx is staged; every warp is done with slot s
    s = nx;
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
