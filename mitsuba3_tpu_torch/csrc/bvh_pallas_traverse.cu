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
// visited leaf tests all its triangles against every ray of the tile whose
// best t is >= 0, whether or not that ray entered the leaf's box
// (Moller-Trumbore; a hit needs det != 0, u >= 0, v >= 0, u + v <= 1 and t
// in [0, best]). Closest mode: the leaf's smallest t, ties to the largest
// column, replaces the ray's best whenever the leaf has a hit, so a hit at
// the same t in a later leaf wins; the slot is leaf * 128 + column. Any-hit
// mode: a ray with a hit gets slot 1 and t -1, which drops it from later
// leaf tests (and from box tests unless its origin lies deep inside the
// box). Rays start from their maxt (slot -1, u = v = 0).
//
// What bounds it on the H100. The work is fixed by the data: per (tile,
// visited node) 1024 slab tests of 25 fp32 operations, and per (tile,
// visited leaf) one test of 52 operations per real triangle for every ray
// whose best t is >= 0 (any-hit: up to its first hit). On bench_bvh's
// terrain that is 96 % to 99 % of the operations, so the kernel is bound
// by fp32 operations (chip_smoke.py counts both terms per launch). The
// node table (1513 nodes, 48 KB) and the slab table (757 leaves, 6.2 MB)
// sit in L1 and L2. What the first port of K5 spent beyond the 52 counted
// operations of a test (86 SASS instructions a test in closest mode, 84 in
// any-hit mode, by tools/sass_loops.py), and what this design does about
// it:
// - Shared loads: nine 32-bit loads per triangle. A visited leaf is now
//   staged by cp.async as three float4 per triangle, (p0, -), (e1, -),
//   (e2, -), real columns only, and read with three broadcast 128-bit
//   loads.
// - The IEEE reciprocal 1 / det: besides its three arithmetic
//   instructions, a range test, a branch to the slow path and a
//   reconvergence per test. Now the fast path runs alone and notes the
//   smallest and largest |det| of the pass (two min/max instructions); a
//   ray whose leaf held a det outside the fast path's range tests that
//   leaf again with IEEE division (rcp in mt_exact.cuh).
// - Selects: the closest test keeps only its running t and column, folds
//   "t <= best, then t <= the leaf's smallest t so far" into one compare
//   against a bound that starts at best, and recomputes u and v of the
//   leaf's winner once.
// - Barriers: two or three per visited node, with thread 0 alone moving
//   the stack. Now one: every thread keeps the stack pointer and the next
//   node in registers (a visited inner node's second child is visited
//   next, so only the first goes to the shared stack, written by thread
//   0 and read after at least one more barrier); the visit decision,
//   __syncthreads_or, is the node's only barrier. A leaf adds one for its
//   staged slab.
//
// Design: a CTA of 1024 threads per tile, each thread holding one ray, its
// 1 / d and best (t, slot, u, v) in registers, in both modes. Any-hit
// mode, besides:
// - A ray tests a leaf's columns in groups of four with one exit test a
//   group, and stops at its first hit (at most three tests past it).
// - Occluded rays leave idle lanes in warps that still test. When at
//   least one warp could be freed (counted at each leaf's staging
//   barrier), the tile's rays are compacted: each thread hands its ray
//   (o, d, best, maxt, index in the tile) through shared memory to the
//   thread at its rank, live rays first. Every ray, occluded or not,
//   still takes part in the visit decision, and each result is written
//   at its ray's own index, so the walk and the outputs do not change.
// Measured on bench_bvh's terrain (PERF.md): testing lanes over
// triangles instead (K4's any-hit scheme: the tile's rays in shared
// memory, warps taking batches of live rays, 32 columns a step with
// __any_sync) was slower on the primary rays and no faster on the bounce
// rays; two rays a thread in 512-thread CTAs, two CTAs an SM, was no
// faster in closest mode on any row and 9 % slower on the sorted bounce
// rays. SASS instructions a test (tools/sass_loops.py): 62.2 closest,
// 61.2 any-hit, against the 52 counted.
//
// What still bounds it: the tiles' work is uneven (on the primary and the
// sorted bounce rays the busiest tile has 1.7 to 2.4 times the mean
// tests), so the last of the 3.9 waves of 512 tiles over 132 SMs leaves
// SMs idle: chip_smoke.py prints the work makespan over the resident CTAs
// beside the bound.
//
// Built with -fmad=false, so every operation rounds as in the plain
// version; 1 / det and 1 / d round as IEEE division.

#include <cuda_runtime.h>

#include "mt_exact.cuh"

namespace {

constexpr int TILE = 1024;     // rays per tile = threads per CTA
constexpr int STACK = 128;     // traversal stack depth
constexpr int K = 128;         // triangles per leaf slab
constexpr int SLAB_ROWS = 16;  // rows of a slab in device memory
constexpr int USED_ROWS = 9;   // p0, e1, e2 (xyz each)
constexpr float EPS = 1e-20f;
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float inv_dir(float c) {
  return 1.0f / (fabsf(c) < EPS ? (c >= 0.0f ? EPS : -EPS) : c);
}

// A node's box: lo xyz, hi xyz (rows of 8 floats, two float4 loads).
struct Box {
  float4 a, b;  // (lox, loy, loz, hix), (hiy, hiz, -, -)
};

__device__ __forceinline__ Box load_box(const float* nb, int node) {
  const float4* p = reinterpret_cast<const float4*>(nb) + 2 * node;
  return {__ldg(p), __ldg(p + 1)};
}

// The plain version's slab test of one ray against a box.
__device__ __forceinline__ bool box_pass(const Box& bx, float ox, float oy,
                                         float oz, float ix, float iy,
                                         float iz, float best) {
  float t0 = (bx.a.x - ox) * ix, t1 = (bx.a.w - ox) * ix;
  float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
  t0 = (bx.a.y - oy) * iy;
  t1 = (bx.b.x - oy) * iy;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  t0 = (bx.a.z - oz) * iz;
  t1 = (bx.b.y - oz) * iz;
  tn = fmaxf(tn, fminf(t0, t1));
  tf = fminf(tf, fmaxf(t0, t1));
  return tn <= tf && tf >= 0.0f && tn <= best;
}

// Stage the first `count` triangles of a leaf's slab into `buf` as three
// float4 per triangle, (p0, -), (e1, -), (e2, -). Every thread of the CTA
// takes part; the copy completes at cp.async.wait_all.
__device__ __forceinline__ void stage_leaf(float4* buf, const float* src,
                                           int count) {
  float* dst = reinterpret_cast<float*>(buf);
  for (int e = threadIdx.x; e < USED_ROWS * K; e += TILE) {
    const int r = e / K, c = e % K;
    if (c >= count) continue;
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + c * 12 + r + r / 3));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + e)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tile's walk. `pass(box)` is this thread's part of the visit test;
// `leaf(id, count)` runs for each visited leaf (every thread calls both
// at the same nodes). The visit decision's __syncthreads_or is the only
// barrier per node: the stack pointer and the next node are registers
// that every thread updates alike, and only a pushed first child goes to
// the shared stack (thread 0 writes it; it is read after at least one
// more visit decision).
template <class Pass, class Leaf>
__device__ __forceinline__ void walk(const float* __restrict__ nb,
                                     const int* __restrict__ nm, int* stack,
                                     Pass pass, Leaf leaf) {
  int node = 0, sp = 0;
  for (;;) {
    const Box bx = load_box(nb, node);
    const int2 meta = __ldg(reinterpret_cast<const int2*>(nm) + node);
    if (__syncthreads_or(pass(bx))) {
      if (meta.x >= 0) {  // inner node: the second child is next
        if (threadIdx.x == 0) stack[sp] = meta.x;
        ++sp;
        node = meta.y;
        continue;
      }
      leaf(-meta.x - 1, meta.y < K ? meta.y : K);
    }
    if (sp == 0) break;
    node = stack[--sp];
  }
}

// The closest hit of one ray in a staged leaf: the last column with the
// smallest t in [0, tw], or -1; tw (which starts at the ray's best) drops
// to that t. "t <= tw" is the plain version's "t <= best, then the
// smallest t, ties to the larger column".
template <bool EXACT>
__device__ __forceinline__ int leaf_closest(const float4* tri, int count,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float& tw, Range& rg) {
  int cw = -1;
#pragma unroll 4
  for (int j = 0; j < count; ++j) {
    float t, u, v;
    const bool take = mt_test<EXACT>(ox, oy, oz, dx, dy, dz, tri + 3 * j, t,
                                     u, v, rg) &&
                      t >= 0.0f && t <= tw;
    tw = take ? t : tw;
    cw = take ? j : cw;
  }
  return cw;
}

__global__ void __launch_bounds__(TILE)
traverse_closest(const float* __restrict__ nb, const int* __restrict__ nm,
                 const float* __restrict__ tris,
                 const float* __restrict__ o3, const float* __restrict__ d3,
                 const float* __restrict__ mt, long long npad,
                 float* __restrict__ t_out, int* __restrict__ slot_out,
                 float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float4 slab[3 * K];
  __shared__ int stack[STACK];
  const long long ray = static_cast<long long>(blockIdx.x) * TILE +
                        threadIdx.x;
  const float ox = o3[ray], oy = o3[npad + ray], oz = o3[2 * npad + ray];
  const float dx = d3[ray], dy = d3[npad + ray], dz = d3[2 * npad + ray];
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  float best = mt[ray], bu = 0.0f, bv = 0.0f;
  int slot = -1;

  walk(
      nb, nm, stack,
      [&](const Box& bx) {
        return box_pass(bx, ox, oy, oz, ix, iy, iz, best);
      },
      [&](int leaf, int count) {
        stage_leaf(slab,
                   tris + static_cast<long long>(leaf) * (SLAB_ROWS * K),
                   count);
        __syncthreads();
        if (!(best >= 0.0f)) return;  // t in [0, best] is empty
        // as in the plain version, no hit beyond BIG is taken
        const float bound = fminf(best, BIG);
        float tw = bound;
        Range rg;
        int cw = leaf_closest<false>(slab, count, ox, oy, oz, dx, dy, dz, tw,
                                     rg);
        if (rg.slow()) {  // a det outside the fast reciprocal's range
          tw = bound;
          cw = leaf_closest<true>(slab, count, ox, oy, oz, dx, dy, dz, tw,
                                  rg);
        }
        if (cw < 0) return;
        // the winner's u and v, by the same arithmetic as its test
        float t;
        mt_test<true>(ox, oy, oz, dx, dy, dz, slab + 3 * cw, t, bu, bv, rg);
        best = tw;
        slot = leaf * K + cw;
      });

  t_out[ray] = best;
  slot_out[ray] = slot;
  u_out[ray] = bu;
  v_out[ray] = bv;
}

// Whether one ray hits a staged leaf with t in [0, best]. The columns go
// in groups of four with one exit test a group: more independent work per
// step than a test-by-test exit, for at most three tests past the first
// hit.
template <bool EXACT>
__device__ __forceinline__ bool leaf_anyhit(const float4* tri, int count,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float best, Range& rg) {
  int j = 0;
  for (; j + 4 <= count; j += 4) {
    bool h = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float t, u, v;
      h |= mt_test<EXACT>(ox, oy, oz, dx, dy, dz, tri + 3 * (j + k), t, u,
                          v, rg) &&
           t >= 0.0f && t <= best;
    }
    if (h) return true;
  }
  for (; j < count; ++j) {
    float t, u, v;
    if (mt_test<EXACT>(ox, oy, oz, dx, dy, dz, tri + 3 * j, t, u, v, rg) &&
        t >= 0.0f && t <= best)
      return true;
  }
  return false;
}

__global__ void __launch_bounds__(TILE)
traverse_anyhit(const float* __restrict__ nb, const int* __restrict__ nm,
                const float* __restrict__ tris, const float* __restrict__ o3,
                const float* __restrict__ d3, const float* __restrict__ mt,
                long long npad, float* __restrict__ t_out,
                int* __restrict__ slot_out) {
  __shared__ float4 slab[3 * K];
  __shared__ int stack[STACK];
  __shared__ float s_ray[9][TILE];  // rays on the move: o, d, best, t0, id
  __shared__ int s_live[TILE / 32];  // live rays of each warp
  __shared__ int s_warps[2];  // warps with a live ray, by leaf parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * TILE;
  int rid = threadIdx.x;  // the tile's ray this thread holds
  float ox = o3[base + rid], oy = o3[npad + base + rid],
        oz = o3[2 * npad + base + rid];
  float dx = d3[base + rid], dy = d3[npad + base + rid],
        dz = d3[2 * npad + base + rid];
  float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  float t0 = mt[base + rid], best = t0;
  if (threadIdx.x < 2) s_warps[threadIdx.x] = 0;  // published by a visit
  int par = 0;

  walk(
      nb, nm, stack,
      [&](const Box& bx) {
        return box_pass(bx, ox, oy, oz, ix, iy, iz, best);
      },
      [&](int leaf, int count) {
        bool live = best >= 0.0f;  // not occluded, t in [0, best] not empty
        const unsigned ballot = __ballot_sync(FULL, live);
        if (lane == 0 && ballot) atomicAdd(&s_warps[par], 1);
        stage_leaf(slab,
                   tris + static_cast<long long>(leaf) * (SLAB_ROWS * K),
                   count);
        const int n_live = __syncthreads_count(live);
        // the other parity's counter was last read before this barrier and
        // is next added to after the next visit decision
        const int busy = s_warps[par];
        if (threadIdx.x == 0) s_warps[par ^ 1] = 0;
        par ^= 1;
        if (busy > (n_live + 31) / 32) {
          // a warp can be freed: move the live rays to the first threads,
          // in order
          if (lane == 0) s_live[warp] = __popc(ballot);
          __syncthreads();
          int before = 0;
          for (int w = 0; w < warp; ++w) before += s_live[w];
          before += __popc(ballot & ((1u << lane) - 1));
          const int to = live ? before : n_live + threadIdx.x - before;
          s_ray[0][to] = ox;
          s_ray[1][to] = oy;
          s_ray[2][to] = oz;
          s_ray[3][to] = dx;
          s_ray[4][to] = dy;
          s_ray[5][to] = dz;
          s_ray[6][to] = best;
          s_ray[7][to] = t0;
          s_ray[8][to] = __int_as_float(rid);
          __syncthreads();
          ox = s_ray[0][threadIdx.x];
          oy = s_ray[1][threadIdx.x];
          oz = s_ray[2][threadIdx.x];
          dx = s_ray[3][threadIdx.x];
          dy = s_ray[4][threadIdx.x];
          dz = s_ray[5][threadIdx.x];
          best = s_ray[6][threadIdx.x];
          t0 = s_ray[7][threadIdx.x];
          rid = __float_as_int(s_ray[8][threadIdx.x]);
          ix = inv_dir(dx);
          iy = inv_dir(dy);
          iz = inv_dir(dz);
          live = best >= 0.0f;
        }
        if (!live) return;
        Range rg;
        bool hit = leaf_anyhit<false>(slab, count, ox, oy, oz, dx, dy, dz,
                                      best, rg);
        if (rg.slow())  // a det outside the fast reciprocal's range
          hit = leaf_anyhit<true>(slab, count, ox, oy, oz, dx, dy, dz, best,
                                  rg);
        if (hit) best = -1.0f;
      });

  t_out[base + rid] = best;
  slot_out[base + rid] = (t0 >= 0.0f && best < 0.0f) ? 1 : -1;
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
    traverse_closest<<<n_tiles, TILE, 0, s>>>(nb, nm, tris, o3, d3, mt, npad,
                                              t_out, slot_out, u_out, v_out);
  } else {
    traverse_anyhit<<<n_tiles, TILE, 0, s>>>(nb, nm, tris, o3, d3, mt, npad,
                                             t_out, slot_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the closest-hit or any-hit kernel that one SM holds at once
// (a negative cudaError_t on failure).
extern "C" int bvh_pallas_traverse_ctas_per_sm(int closest) {
  int n = 0;
  const cudaError_t e =
      closest ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, traverse_closest, TILE, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &n, traverse_anyhit, TILE, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
