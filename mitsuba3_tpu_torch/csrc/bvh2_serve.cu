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
// ids. For each served id, the lanes that want it REPLACE their outputs
// with the supernode's best hit, a miss included: Moller-Trumbore against
// its 32 triangles (a supernode is [10, 32] f32: rows 0-8 p0, e1, e2 xyz,
// row 9 the prim id as f32, -1 for an empty slot); a hit needs det != 0,
// u >= 0, v >= 0, u + v <= 1, t in [0, tbest] and a prim id >= 0; the
// smallest t wins, ties to the largest prim id; a miss is (BIG, -1, 0, 0).
// Lanes served nothing keep (BIG, -1, 0, 0). An id past the supernode
// table (a padding supernode of the cull) is a miss, as the JAX package's
// out-of-range gather gives rows of NaN, which hit nothing.
//
// Why one pass is exact. A lane takes the result of every served slot
// whose id it wants, the last one winning; all such slots hold the same id
// (the host serves distinct ids, and a repeated id gives the same result
// each time), so the lane tests that supernode once: the first slot whose
// id it wants.
//
// What bounds it on the H100. Per wanting lane one test of 53 fp32
// operations per real triangle of the supernode (terrain: 21.7 of 32 on
// average) on a 1.25 KB slab from L2: bound by fp32 operations
// (chip_smoke.py measures both terms of the bound). What the first port
// of K8 spent beyond that, and what this design does about it:
// - Four phases in sequence per CTA, each a __syncthreads_or, a staging of
//   the slab with a 32-way shared atomicMax for its last real column, a
//   barrier and a test loop run by the lanes that wanted that id, while
//   the others waited. Now each lane finds the one slot it wants (four
//   compares), each warp stages the slabs its own lanes want, all at once,
//   and every lane tests its own slab in one loop: no CTA barrier, one
//   __syncwarp, and lanes wanting different slabs test side by side.
// - Staging on the critical path: now the slabs' copies are issued by
//   cp.async before the rays are read, so the two latencies overlap; the
//   last real column comes from a ballot over the id row, which each lane
//   reads for its own column.
// - Work for lanes that test nothing: a warp whose lanes want no id of the
//   table stages nothing and writes misses; a lane that wants nothing, a
//   padding id or an id not served reads no ray.
// - The IEEE reciprocal 1 / det with its range test and branch in every
//   test: now the test of csrc/mt_exact.cuh (the fast path, the slab
//   tested again by IEEE division where |det| fell outside its range),
//   each triangle staged as three float4 (p0 and the id as an int, e1, e2)
//   and read by three 128-bit loads, the tie rule in one compare, and u
//   and v of the winner computed once, as K7 does.
//
// Design. Each warp serves 32 lanes of a chunk on its own, with a shared
// buffer of four slabs; a CTA holds two chunks (8 warps). Measured on the
// bounce row by device time (tools/kernel_variants.py on an H100 80GB
// HBM3 at 700 W, PERF.md): 256-thread CTAs took 0.0104 ms a launch, 128
// threads 0.0113, 64 threads 0.0118, 512 0.0125 and 1024 0.0131; padding
// the slabs against bank conflicts changed nothing; compacting a chunk's
// testing lanes into its first warps (two CTA barriers, slabs staged once
// a chunk) took 0.0119; the first port of K8 took 0.0258. Built with
// -fmad=false, so every operation rounds as in the plain version.

#include <cuda_runtime.h>

#include "mt_exact.cuh"

namespace {

constexpr int CHUNK = 128;   // lanes per chunk
constexpr int N_SERVE = 4;   // served ids per chunk
constexpr int LEAF = 32;     // triangles per supernode = lanes per warp
constexpr int ROWS = 10;     // p0, e1, e2 (xyz each) and the prim id
constexpr int XYZ_ROWS = 9;
constexpr int WARPS = 8;     // warps per CTA: two chunks
constexpr int THREADS = 32 * WARPS;
constexpr int QUARTERS = CHUNK / 32;  // warps per chunk
// float4 per staged slab, three a triangle: four slabs a warp fill the
// 48 KB of static shared memory a CTA may have
constexpr int SLAB_F4 = 3 * LEAF;
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

// Issue the copy of supernode `src`'s rows 0-8 into `buf` (this lane's
// column: p0 xyz at floats 0-2 of its triangle, e1 at 4-6, e2 at 8-10) as
// cp.async copies, and return its column's prim id (row 9) as an int.
__device__ __forceinline__ int stage_slab(float4* buf, const float* src,
                                          int lane) {
  float* dst = reinterpret_cast<float*>(buf + 3 * lane);
#pragma unroll
  for (int r = 0; r < XYZ_ROWS; ++r) {
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(dst + r + r / 3));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + r * LEAF + lane)
                 : "memory");
  }
  return static_cast<int>(__ldg(src + XYZ_ROWS * LEAF + lane));
}

// The best hit of one ray in the first n triangles of a staged slab: t in
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

// at most 64 registers a thread: 1024 threads an SM, so that a round of
// 1024 chunks (131,072 threads) runs in one wave on 132 SMs (and 4 CTAs of
// 48 KB fit an SM's shared memory)
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
bvh2_serve_kernel(const float* __restrict__ tris, int n_nodes,
                  const int* __restrict__ ids, const float* __restrict__ rays,
                  const int* __restrict__ want, long long n_chunks,
                  float* __restrict__ t_out, int* __restrict__ p_out,
                  float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float4 slabs[WARPS][N_SERVE][SLAB_F4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long gw = static_cast<long long>(blockIdx.x) * WARPS + warp;
  const long long chunk = gw / QUARTERS;
  if (chunk >= n_chunks) return;  // the whole warp
  const int col = static_cast<int>(gw % QUARTERS) * 32 + lane;
  const long long out = chunk * CHUNK + col;
  const int w = want[out];
  int sid[N_SERVE];
  int k = -1;  // the first served slot whose id this lane wants
#pragma unroll
  for (int s = N_SERVE - 1; s >= 0; --s) {
    sid[s] = __ldg(ids + chunk * N_SERVE + s);
    if (sid[s] == w) k = s;
  }
  // an id of the table (unsigned: NONE and the padding ids lie past it; a
  // negative id, which no caller makes, is read as none)
  const bool real = k >= 0 && static_cast<unsigned>(w) <
                                  static_cast<unsigned>(n_nodes);
  const unsigned need = __reduce_or_sync(FULL, real ? 1u << k : 0u);

  float t_o = BIG, u_o = 0.0f, v_o = 0.0f;
  int p_o = -1;
  if (need) {
    float4(*buf)[SLAB_F4] = slabs[warp];
    // every load is issued before any is used: the wanted slabs' copies
    // and id columns, then the ray
    int pid[N_SERVE] = {-1, -1, -1, -1};
#pragma unroll
    for (int s = 0; s < N_SERVE; ++s)
      if (need >> s & 1u)
        pid[s] = stage_slab(
            buf[s], tris + static_cast<long long>(sid[s]) * (ROWS * LEAF),
            lane);
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
    float tb = -1.0f;
    if (real) {  // rays is [C, 8, CHUNK]: ox oy oz dx dy dz (unused) tbest
      const float* r = rays + chunk * 8 * CHUNK + col;
      ox = r[0];
      oy = r[CHUNK];
      oz = r[2 * CHUNK];
      dx = r[3 * CHUNK];
      dy = r[4 * CHUNK];
      dz = r[5 * CHUNK];
      tb = r[7 * CHUNK];
    }
    int n = 0;  // one past the last real column of this lane's slab
#pragma unroll
    for (int s = 0; s < N_SERVE; ++s) {
      if (!(need >> s & 1u)) continue;
      buf[s][3 * lane].w = __int_as_float(pid[s]);
      const unsigned m = __ballot_sync(FULL, pid[s] >= 0);
      if (s == k) n = m ? 32 - __clz(m) : 0;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    // t in [0, tb] is empty where tb < 0 (or NaN); as in the plain version
    // no hit beyond BIG is taken
    if (real && tb >= 0.0f) {
      const float4* tri = buf[k];
      const float bound = fminf(tb, BIG);
      float tw = bound;
      int pw = -1;
      Range rg;
      int jw = slab_best<false>(tri, n, ox, oy, oz, dx, dy, dz, tw, pw, rg);
      if (rg.slow()) {  // a det outside the fast reciprocal's range
        tw = bound;
        pw = -1;
        jw = slab_best<true>(tri, n, ox, oy, oz, dx, dy, dz, tw, pw, rg);
      }
      if (jw >= 0) {
        // the winner's u and v, by the same arithmetic as its test
        float t;
        mt_test<true>(ox, oy, oz, dx, dy, dz, tri + 3 * jw, t, u_o, v_o, rg);
        t_o = tw;
        p_o = pw;
      }
    }
  }
  t_out[out] = t_o;
  p_out[out] = p_o;
  u_out[out] = u_o;
  v_out[out] = v_o;
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
  const long long warps = static_cast<long long>(n_chunks) * QUARTERS;
  const unsigned grid = static_cast<unsigned>((warps + WARPS - 1) / WARPS);
  bvh2_serve_kernel<<<grid, THREADS, 0, s>>>(tris, n_nodes, ids, rays, want,
                                             n_chunks, t_out, p_out, u_out,
                                             v_out);
  return static_cast<int>(cudaGetLastError());
}
