// K1 on Hopper: the cellserve serve kernel (closest-hit and any-hit).
//
// Replaces mitsuba3_tpu/ops/cellserve.py:_serve_kernel, the Pallas TPU
// kernel launched by _serve_blocks (tile math: _mt_tile_first). Its plain
// PyTorch version is serve_blocks_plain in mitsuba3_tpu_torch/ops/cellserve.py;
// the wrapper serve_blocks there launches this kernel for CUDA tensors.
//
// What it computes. Pairs (cell, ray) are sorted by cell and cut into
// sub-blocks of 128 pairs. Sub-block s owns the CSR row window
// r0[s] .. r0[s] + nr[s] - 1 of the triangle slab table. A slab is
// [16, 128] f32: rows 0-8 hold p0, e1, e2 (xyz each), row 9 the prim id as
// f32 (-1 marks an empty slot), rows 10-15 are padding. For each pair the
// kernel returns the smallest Moller-Trumbore t > MINT over the hits of its
// window (det != 0, u >= 0, v >= 0, u + v <= 1, id >= 0), or BIG = 3.4e38
// for none. In closest mode it also returns prim/u/v of the first row and,
// within it, the first column that reaches the minimum: a later row wins
// only with a strictly smaller t, as in the Pallas kernel. This keeps a
// triangle binned into several cells of one window from changing the
// answer. Any-hit mode returns t only (the caller compares it with maxt).
//
// What bounds it on the H100. On the TPU the serve was bound by slab DMA
// rows (DESIGN.md, "Serve-kernel layout exploration"). Here terrain64k's
// whole slab table (1318 rows x 8 KB = 10.8 MB) fits in the 50 MB L2, so a
// row that several sub-blocks read again comes from L2, and each row feeds
// 128 x 128 triangle tests of 52 fp32 operations each: the kernel is bound
// by fp32 arithmetic, not by memory (the bound counts the tests of real
// triangles). What a test costs beyond its 52 operations is what the design
// cuts: shared-memory loads, barriers, and the padding columns (id -1) at
// the end of a row, about a third of the window rows' columns. A render's
// later rounds serve few sub-blocks, some with long windows, so a
// sub-block's own latency matters as much as the throughput. Built with
// -fmad=false, so every operation rounds as in the plain version;
// 1.0f / det is IEEE division.
//
// Design. One CTA of 4 warps per sub-block. Every warp holds all 128 pairs,
// 4 per lane (lane + 32 k, so the ray loads stay coalesced), with their
// running best in registers, and the warps split each row's columns: warp w
// tests columns w, w + 4, ... So a test of a triangle against 4 pairs
// costs three broadcast 128-bit shared loads (0.75 loads per test instead
// of 10), and a long window is walked by 4 warps at once. The rows are
// staged with cp.async as three float4 per triangle, (p0.xyz, id),
// (e1.xyz, -), (e2.xyz, -), double-buffered: row r + 1 is in flight while
// row r is tested, with one barrier per row. A warp ballot over the staged
// ids finds the row's last real column; no column after it is tested,
// while earlier ones keep their id >= 0 test (empty slots can sit between
// real ones). Each warp scans its rows and columns in order with a strict
// "<" and notes where its best hit was (row * 128 + column); the fold at
// the end takes the smallest t and, among equal ts, the smallest position,
// which is the first row and, within it, the first column that reaches
// the minimum: exactly the Pallas tie rule. A sub-block with nr == 0
// (sentinel padding) writes BIG, -1, 0, 0.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int K = 128;          // triangles per slab = pairs per sub-block
constexpr int SLAB_ROWS = 16;   // rows of a slab in device memory
constexpr int USED_ROWS = 10;   // p0, e1, e2 (xyz each) and the prim id
constexpr int WARPS = 4;        // warps per sub-block (one CTA)
constexpr int THREADS = WARPS * 32;
constexpr int R = K / 32;       // pairs per lane
constexpr int TRI_F = 12;       // floats per staged triangle (3 float4)
constexpr float BIG = 3.4e38f;
constexpr float MINT = 1e-6f;
constexpr unsigned FULL = 0xffffffffu;

// Where slab row r (0..9) goes in a staged triangle: p0 xyz at 0-2, the id
// at 3, e1 xyz at 4-6, e2 xyz at 8-10.
__device__ __forceinline__ int tri_pos(int r) {
  return r == 9 ? 3 : r + r / 3;
}

// Copy a slab row's 10 used rows into `buf` in the staged-triangle layout
// (every thread of the CTA takes part; completes at cp.async.wait_all).
__device__ __forceinline__ void stage_row(float* buf, const float* src) {
  for (int e = threadIdx.x; e < USED_ROWS * K; e += THREADS) {
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(buf + (e % K) * TRI_F + tri_pos(e / K)));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + e)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool WANT_UV>
__global__ void __launch_bounds__(THREADS, 1)
serve_kernel(const float* __restrict__ tris, const float* __restrict__ rays,
             const int* __restrict__ r0, const int* __restrict__ nr,
             long long np_pad, float* __restrict__ t_out,
             int* __restrict__ p_out, float* __restrict__ u_out,
             float* __restrict__ v_out) {
  // two row buffers of K * TRI_F floats; at the end, the warps' candidates
  // for the fold
  __shared__ __align__(16) float slab[2 * K * TRI_F];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * K;
  // rays is [6, np_pad]: origin xyz, then direction xyz
  float ox[R], oy[R], oz[R], dx[R], dy[R], dz[R];
  float best_t[R], best_u[R], best_v[R];
  int best_p[R], best_key[R];  // key: row * K + column of the best hit
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long pair = base + lane + 32 * k;
    ox[k] = rays[pair];
    oy[k] = rays[np_pad + pair];
    oz[k] = rays[2 * np_pad + pair];
    dx[k] = rays[3 * np_pad + pair];
    dy[k] = rays[4 * np_pad + pair];
    dz[k] = rays[5 * np_pad + pair];
    best_t[k] = BIG;
    best_p[k] = -1;
    best_key[k] = INT_MAX;
    best_u[k] = 0.0f;
    best_v[k] = 0.0f;
  }
  const long long row_begin = r0[blockIdx.x];
  const int n_rows = nr[blockIdx.x];
  if (n_rows > 0) stage_row(slab, tris + row_begin * (SLAB_ROWS * K));
  for (int i = 0; i < n_rows; ++i) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // row i is visible; every warp is done with row i - 1
    if (i + 1 < n_rows)
      stage_row(slab + ((i + 1) & 1) * K * TRI_F,
                tris + (row_begin + i + 1) * (SLAB_ROWS * K));
    const float* cur = slab + (i & 1) * K * TRI_F;
    // one past the row's last column with id >= 0
    int n = 0;
    for (int g = K / 32 - 1; g >= 0 && n == 0; --g) {
      const unsigned m = __ballot_sync(
          FULL, static_cast<int>(cur[(g * 32 + lane) * TRI_F + 3]) >= 0);
      if (m) n = g * 32 + 32 - __clz(m);
    }
    const float4* tri = reinterpret_cast<const float4*>(cur);
#pragma unroll 1
    for (int j = warp; j < n; j += WARPS) {
      const float4 a = tri[3 * j], e1 = tri[3 * j + 1], e2 = tri[3 * j + 2];
      const int id = static_cast<int>(a.w);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float pvx = dy[k] * e2.z - dz[k] * e2.y;
        const float pvy = dz[k] * e2.x - dx[k] * e2.z;
        const float pvz = dx[k] * e2.y - dy[k] * e2.x;
        const float det = e1.x * pvx + e1.y * pvy + e1.z * pvz;
        const bool ok = det != 0.0f;
        const float dinv = ok ? 1.0f / det : 0.0f;
        const float tvx = ox[k] - a.x, tvy = oy[k] - a.y, tvz = oz[k] - a.z;
        const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * dinv;
        const float qvx = tvy * e1.z - tvz * e1.y;
        const float qvy = tvz * e1.x - tvx * e1.z;
        const float qvz = tvx * e1.y - tvy * e1.x;
        const float v = (dx[k] * qvx + dy[k] * qvy + dz[k] * qvz) * dinv;
        const float t = (e2.x * qvx + e2.y * qvy + e2.z * qvz) * dinv;
        const bool hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                         t > MINT && id >= 0;
        if (hit && t < best_t[k]) {
          best_t[k] = t;
          if (WANT_UV) {
            best_key[k] = i * K + j;
            best_p[k] = id;
            best_u[k] = u;
            best_v[k] = v;
          }
        }
      }
    }
  }
  // Fold the warps' candidates: the smallest t, and among equal ts the
  // smallest (row, column), which is the serial scan's first hit.
  __syncthreads();  // every warp is done with the row buffers
  static_assert(5 * WARPS * K <= 2 * K * TRI_F,
                "the fold's scratch fits in the row buffers");
  float* c_t = slab;
  int* c_key = reinterpret_cast<int*>(c_t + WARPS * K);
  int* c_p = c_key + WARPS * K;
  float* c_u = reinterpret_cast<float*>(c_p + WARPS * K);
  float* c_v = c_u + WARPS * K;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int q = warp * K + lane + 32 * k;
    c_t[q] = best_t[k];
    if (WANT_UV) {
      c_key[q] = best_key[k];
      c_p[q] = best_p[k];
      c_u[q] = best_u[k];
      c_v[q] = best_v[k];
    }
  }
  __syncthreads();
  const int pair = threadIdx.x;  // THREADS == K: one pair per thread
  int w_best = 0;
  for (int w = 1; w < WARPS; ++w) {
    const float t = c_t[w * K + pair], tb = c_t[w_best * K + pair];
    if (t < tb ||
        (WANT_UV && t == tb && c_key[w * K + pair] < c_key[w_best * K + pair]))
      w_best = w;
  }
  const int q = w_best * K + pair;
  t_out[base + pair] = c_t[q];
  if (WANT_UV) {
    p_out[base + pair] = c_p[q];
    u_out[base + pair] = c_u[q];
    v_out[base + pair] = c_v[q];
  }
}

}  // namespace

// tris [n_rows, 16, 128] f32; rays [6, np_pad] f32 with np_pad = 128 * n_sub;
// r0, nr [n_sub] i32; t_out [np_pad] f32; with want_uv also p_out [np_pad]
// i32 and u_out, v_out [np_pad] f32 (else they may be null). Launches on
// `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int cellserve_serve(const float* tris, const float* rays,
                               const int* r0, const int* nr, int n_sub,
                               long long np_pad, float* t_out, int* p_out,
                               float* u_out, float* v_out, int want_uv,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static_assert(THREADS == K, "the fold gives each thread one pair");
  if (want_uv) {
    serve_kernel<true><<<n_sub, THREADS, 0, s>>>(tris, rays, r0, nr, np_pad,
                                                 t_out, p_out, u_out, v_out);
  } else {
    serve_kernel<false><<<n_sub, THREADS, 0, s>>>(
        tris, rays, r0, nr, np_pad, t_out, p_out, u_out, v_out);
  }
  return static_cast<int>(cudaGetLastError());
}
