// Mean-shift filter over joint (x, y, Lab) space for Hopper (sm_90a).
//
// Replaces tpuflow/kernels/ms_filter.py::mean_shift_filter_pallas (the TPU
// kernel _ms_kernel). Every pixel is a query; `iters` times, each query
// moves to the mean of the ORIGINAL frame's points at the (2E+1)^2 static
// offsets (dx, dy) from its origin pixel that pass both flat-kernel tests
//
//     (dx - ex)^2 + (dy - ey)^2 <= R^2      (ex, ey: the query's drift)
//     |q - c|^2 <= hr^2                     (c: the query's colour)
//
// summing dx, dy, 1 and the three colour channels in row-major offset
// order, then dividing by the count; an empty window jumps to global (0, 0).
// Points outside the frame carry a colour sentinel farther than hr from
// every real colour, so they fail the colour test without a mask.
//
// What bounds it on the H100: instruction issue and shared-memory loads,
// not bytes. The frame is read once and the outputs written once (~9 MB
// at KITTI size), while each query tests ~1,257 points per iteration at
// R = 20 (~4.7e9 tests over 8 iterations). The design cuts the
// instructions and loads per test, and the tests:
// - Only the disc is walked. In float32, d_sp = fl(fl(fl(dx - ex)^2) +
//   ty2) is monotone in |fl(dx - ex)| on each side of ex, so the offsets
//   of a row dy that pass the spatial test form one run of dx. Its ends
//   come from sqrtf(hs2 - ty2) and are then moved by the exact float32
//   test until they are tight, and clipped to [-E, E]; a row whose ty2
//   exceeds hs2 has none. The inner loop runs the colour test alone, over
//   the points the plain version can add, in its order.
// - A point's colour is one 128-bit shared load: the block stages the
//   three Lab planes interleaved as float4 (L, a, b, 0), with an odd pitch
//   so that lanes on neighbouring rows fall in other banks.
// - dx, dy and 1 are integers, and every partial sum of them is an exact
//   float32 integer (|sum| <= (2E + 1)^2 E < 2^24), so they are summed in
//   int, in any order: a row packs its count and its sum of dx + E into
//   one int (count << 16 | sum), one add per point.
// - An iteration is a function of the query's state (drift and colour)
//   alone, so once an iteration gives the state back bit for bit, every
//   later one would too: the query stops there (86% of the flagship
//   scene's queries have by the 8th iteration; a warp stops when its last
//   lane does).
// - One block per SM: 32 query columns (a warp is one row of queries) by
//   24 rows, fewer where a wide window's tile would not fit. A thread
//   stages STAGE_BATCH points per round trip to device memory.
// Queries never read each other's state, only the original frame, so the
// whole iteration loop runs in one launch on the block's staged tile; each
// thread keeps its query's drift, colour and sums in registers. The build
// disables FMA contraction and the colour sums follow the plain version's
// order (a failed test adds +-0 there, which leaves a sum unchanged), so
// the result is bitwise its plain version.
//
// The wide form (ms_filter_wide_kernel): where one query row's tile does
// not fit a block's shared memory (E >= 53) or the packed row sum cannot
// hold E (E > 127), nothing is staged. Each point's (L, a, b) is read from
// device memory through the read-only cache, the sentinel in place of a
// point outside the frame, on the same row runs in the same order; dx,
// dy and the count are summed in float, term by term in offset order, as
// the plain version sums them, so no bound on E keeps them exact.
//
// Both forms read their points from an input plane of in_h x in_w pixels
// whose pixel (off + y, off + x) is query (y, x) of the h x w output, and
// whose (0, 0) query sits at frame coordinates (row0, col0): the whole
// frame (off 0, origin (0, 0)), or a mesh tile halo'd by E with the
// sentinel already outside the frame (off E; tpuflow's _ms_sharded_fn).
// The empty-window jump and the positions use the frame coordinates.
// Two optional outputs, compiled in a second instantiation of each form
// (EXTRA) so the flagship's filter keeps its code: drift2, each query's
// largest ex^2 + ey^2 before a step (tpuflow's with_drift, reduced by the
// caller), and traj, the (iters, h, w, 2) drift after each step
// (return_trajectory). A query that stops repeats its state in the
// iterations it skips, as the plain version computes them.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;       // query columns of a block: one warp a row
constexpr int MIN_TH = 1;    // query rows of a block, picked per launch
constexpr int MAX_TH = 24;
constexpr int STAGE_BATCH = 8;  // points a thread stages per round trip
// The low 16 bits of a row's packed sum hold the sum of dx + E over its
// points, at most (2E + 1) * 2E, which is below 2^16 for E <= 127.
constexpr int COUNT_SHIFT = 16;
constexpr int MAX_E = 127;

// The staged tile: point i's (L, a, b) as one float4, read in one 128-bit
// shared load.
struct Interleaved {
  static constexpr int BYTES = 16;
  float4* t;
  __device__ Interleaved(void* smem, int) : t((float4*)smem) {}
  __device__ void store(int i, float L, float a, float b) const {
    t[i] = make_float4(L, a, b, 0.f);
  }
  __device__ float4 load(int i) const { return t[i]; }
};
using Layout = Interleaved;

// The spatial test of offset dx in a row whose dy term is ty2, as the plain
// version computes it.
__device__ __forceinline__ bool in_disc(int dx, float ex, float ty2,
                                        float hs2) {
  const float tx = (float)dx - ex;
  return tx * tx + ty2 <= hs2;
}

// The run [lo, hi] of a row's offsets that pass the spatial test (ty2 <=
// hs2), clipped to [-E, E]; lo > hi: none.
__device__ __forceinline__ void row_run(float ex, float ty2, float hs2, int E,
                                        int& lo, int& hi) {
  const float half = sqrtf(hs2 - ty2);
  lo = (int)ceilf(ex - half);
  hi = (int)floorf(ex + half);
  // The estimate is tight unless rounding put an end one off: test both
  // ends and their outer neighbours, and move only if one fails.
  if (!(in_disc(lo, ex, ty2, hs2) & !in_disc(lo - 1, ex, ty2, hs2) &
        in_disc(hi, ex, ty2, hs2) & !in_disc(hi + 1, ex, ty2, hs2))) {
    while (in_disc(lo - 1, ex, ty2, hs2)) --lo;
    while (lo <= hi && !in_disc(lo, ex, ty2, hs2)) ++lo;
    while (in_disc(hi + 1, ex, ty2, hs2)) ++hi;
    while (hi >= lo && !in_disc(hi, ex, ty2, hs2)) --hi;
  }
  lo = max(lo, -E);
  hi = min(hi, E);
}

// A query's state: drift (ex, ey) and colour (c0, c1, c2).
struct Query {
  float ex, ey, c0, c1, c2;
};

// One iteration's mean from the sums (an empty window jumps to global (0,
// 0)) into q; true if it gives q back bit for bit.
__device__ __forceinline__ bool settle(Query& q, float n, float s_dx,
                                       float s_dy, float s0, float s1,
                                       float s2, int x, int y) {
  const float nn = fmaxf(n, 1.f);
  const float nx = n > 0.f ? s_dx / nn : -(float)x;
  const float ny = n > 0.f ? s_dy / nn : -(float)y;
  const float n0 = s0 / nn, n1 = s1 / nn, n2 = s2 / nn;
  const bool fixed = __float_as_int(nx) == __float_as_int(q.ex) &&
                     __float_as_int(ny) == __float_as_int(q.ey) &&
                     __float_as_int(n0) == __float_as_int(q.c0) &&
                     __float_as_int(n1) == __float_as_int(q.c1) &&
                     __float_as_int(n2) == __float_as_int(q.c2);
  q = {nx, ny, n0, n1, n2};
  return fixed;
}

// Where a launch reads and writes (see the header).
struct Geometry {
  int in_h, in_w;  // the input plane
  int h, w;        // the queries (the output)
  int off;         // input pixel of query (0, 0), on both axes
  int row0, col0;  // frame coordinates of query (0, 0)
};

// The optional outputs (null: not asked for).
struct Extra {
  float* drift2;  // (h, w)
  float* traj;    // (iters, h, w, 2)
};

// The query's result; (x, y) the query, (fx, fy) its frame coordinates.
__device__ __forceinline__ void store(const Query& q, float* __restrict__ pos,
                                      float* __restrict__ col, int x, int y,
                                      int w, int fx, int fy) {
  const size_t g = (size_t)y * w + x;
  pos[2 * g] = (float)fx + q.ex;
  pos[2 * g + 1] = (float)fy + q.ey;
  col[3 * g] = q.c0;
  col[3 * g + 1] = q.c1;
  col[3 * g + 2] = q.c2;
}

// Drift after step `it`, and, if the query stopped there, after every
// later step too.
__device__ __forceinline__ void record(const Extra& e, const Query& q,
                                       int it, int iters, bool stopped,
                                       size_t g, size_t plane) {
  if (e.traj == nullptr) return;
  const int last = stopped ? iters : it + 1;
  for (int k = it; k < last; ++k) {
    e.traj[2 * (k * plane + g)] = q.ex;
    e.traj[2 * (k * plane + g) + 1] = q.ey;
  }
}

template <bool EXTRA>
__global__ void __launch_bounds__(TW * MAX_TH, 1)
    ms_filter_kernel(const float* __restrict__ lab,
                     const float* __restrict__ sentinel,
                     float* __restrict__ pos, float* __restrict__ col,
                     Geometry gm, Extra ex_out, int E, int reach, int iters,
                     float hs2, float hr2) {
  const int h = gm.h, w = gm.w;
  extern __shared__ float4 smem[];
  const int th = blockDim.x / TW;
  const int sh = th + 2 * E;
  const int sw = TW + 2 * E;
  const int pitch = sw | 1;
  const Layout tile(smem, sh * pitch);
  const float sent = *sentinel;
  const int lx = threadIdx.x % TW;
  const int ly = threadIdx.x / TW;
  // Input coordinates of the shared tile's (0, 0).
  const int row0 = blockIdx.y * th + gm.off - E;
  const int col0 = blockIdx.x * TW + gm.off - E;

  // Staging: STAGE_BATCH points' loads in flight a thread, then their
  // stores, so a block waits for a few round trips to device memory, not
  // one a point.
  for (int i0 = threadIdx.x; i0 < sh * sw; i0 += STAGE_BATCH * blockDim.x) {
    float v[STAGE_BATCH][3];
    int at[STAGE_BATCH];
#pragma unroll
    for (int b = 0; b < STAGE_BATCH; ++b) {
      const int i = i0 + b * blockDim.x;
      const int r = i / sw;
      const int c = i - r * sw;
      const int y = row0 + r;
      const int x = col0 + c;
      const bool in =
          i < sh * sw && y >= 0 && y < gm.in_h && x >= 0 && x < gm.in_w;
      const float* p =
          lab + 3 * ((size_t)(in ? y : 0) * gm.in_w + (in ? x : 0));
      v[b][0] = in ? p[0] : sent;
      v[b][1] = in ? p[1] : sent;
      v[b][2] = in ? p[2] : sent;
      at[b] = i < sh * sw ? r * pitch + c : -1;
    }
#pragma unroll
    for (int b = 0; b < STAGE_BATCH; ++b)
      if (at[b] >= 0) tile.store(at[b], v[b][0], v[b][1], v[b][2]);
  }
  __syncthreads();

  const int y = blockIdx.y * th + ly;
  const int x = blockIdx.x * TW + lx;
  if (y >= h || x >= w) return;
  const int fy = gm.row0 + y, fx = gm.col0 + x;
  const size_t g = (size_t)y * w + x;
  const int center = (ly + E) * pitch + (lx + E);
  const float4 own = tile.load(center);
  Query qs = {0.f, 0.f, own.x, own.y, own.z};
  float d2 = 0.f;
  const int key = (1 << COUNT_SHIFT) + E;
  for (int it = 0; it < iters; ++it) {
    const float ex = qs.ex, ey = qs.ey;
    if (EXTRA) d2 = fmaxf(d2, ex * ex + ey * ey);
    const float c0 = qs.c0, c1 = qs.c1, c2 = qs.c2;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    int s_n = 0, s_dx = 0, s_dy = 0;
    // A row with |dy - ey| >= reach + 1 > R has ty2 >= (reach + 1)^2 >
    // hs2 after float32 rounding (monotone, and (reach + 1)^2 is exact).
    const int y_lo = max(-E, (int)floorf(ey) - reach);
    const int y_hi = min(E, (int)ceilf(ey) + reach);
    for (int dy = y_lo; dy <= y_hi; ++dy) {
      const float ty = (float)dy - ey;
      const float ty2 = ty * ty;
      // fl(tx^2 + ty2) >= ty2: no offset of this row passes.
      if (!(ty2 <= hs2)) continue;
      int lo, hi;
      row_run(ex, ty2, hs2, E, lo, hi);
      // tag = key + dx runs along the row: the packed sum's term and,
      // less base, the point's tile index.
      const int base = center + dy * pitch - key;
      const int end = key + hi + 1;
      int packed = 0;
#pragma unroll 4
      for (int tag = key + lo; tag < end; ++tag) {
        const float4 q = tile.load(base + tag);
        const float a = q.x - c0;
        const float b = q.y - c1;
        const float c = q.z - c2;
        if (a * a + b * b + c * c <= hr2) {
          s0 = s0 + q.x;
          s1 = s1 + q.y;
          s2 = s2 + q.z;
          packed += tag;
        }
      }
      const int count = packed >> COUNT_SHIFT;
      s_n += count;
      s_dx += (packed & ((1 << COUNT_SHIFT) - 1)) - E * count;
      s_dy += dy * count;
    }
    // The int sums are exact float32 integers (see the header).
    const bool fixed = settle(qs, (float)s_n, (float)s_dx, (float)s_dy, s0,
                              s1, s2, fx, fy);
    if (EXTRA) record(ex_out, qs, it, iters, fixed, g, (size_t)h * w);
    if (fixed) break;
  }
  if (EXTRA && ex_out.drift2 != nullptr) ex_out.drift2[g] = d2;
  store(qs, pos, col, x, y, w, fx, fy);
}

// The wide form: one query a thread, TW columns by blockDim.x / TW rows of
// queries a block, the points read from device memory.
template <bool EXTRA>
__global__ void __launch_bounds__(TW * MAX_TH, 1)
    ms_filter_wide_kernel(const float* __restrict__ lab,
                          const float* __restrict__ sentinel,
                          float* __restrict__ pos, float* __restrict__ col,
                          Geometry gm, Extra ex_out, int E, int reach,
                          int iters, float hs2, float hr2) {
  const int h = gm.h, w = gm.w;
  const int th = blockDim.x / TW;
  const int y = blockIdx.y * th + threadIdx.x / TW;
  const int x = blockIdx.x * TW + threadIdx.x % TW;
  if (y >= h || x >= w) return;
  const int fy = gm.row0 + y, fx = gm.col0 + x;
  const size_t g = (size_t)y * w + x;
  // The query's input pixel.
  const int iy = y + gm.off, ix = x + gm.off;
  const float sent = *sentinel;
  const float* own = lab + 3 * ((size_t)iy * gm.in_w + ix);
  Query qs = {0.f, 0.f, __ldg(own), __ldg(own + 1), __ldg(own + 2)};
  float d2 = 0.f;
  for (int it = 0; it < iters; ++it) {
    const float ex = qs.ex, ey = qs.ey;
    if (EXTRA) d2 = fmaxf(d2, ex * ex + ey * ey);
    const float c0 = qs.c0, c1 = qs.c1, c2 = qs.c2;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    float s_n = 0.f, s_dx = 0.f, s_dy = 0.f;
    const int y_lo = max(-E, (int)floorf(ey) - reach);
    const int y_hi = min(E, (int)ceilf(ey) + reach);
    for (int dy = y_lo; dy <= y_hi; ++dy) {
      const float ty = (float)dy - ey;
      const float ty2 = ty * ty;
      if (!(ty2 <= hs2)) continue;
      int lo, hi;
      row_run(ex, ty2, hs2, E, lo, hi);
      const int py = iy + dy;
      const bool row_in = py >= 0 && py < gm.in_h;
      const float* row = lab + 3 * (size_t)(row_in ? py : 0) * gm.in_w;
      const float fdy = (float)dy;
      for (int dx = lo; dx <= hi; ++dx) {
        const int px = ix + dx;
        const bool in = row_in && px >= 0 && px < gm.in_w;
        const float* p = row + 3 * (in ? px : 0);
        const float q0 = in ? __ldg(p) : sent;
        const float q1 = in ? __ldg(p + 1) : sent;
        const float q2 = in ? __ldg(p + 2) : sent;
        const float a = q0 - c0;
        const float b = q1 - c1;
        const float c = q2 - c2;
        if (a * a + b * b + c * c <= hr2) {
          s_dx = s_dx + (float)dx;
          s_dy = s_dy + fdy;
          s_n = s_n + 1.f;
          s0 = s0 + q0;
          s1 = s1 + q1;
          s2 = s2 + q2;
        }
      }
    }
    const bool fixed = settle(qs, s_n, s_dx, s_dy, s0, s1, s2, fx, fy);
    if (EXTRA) record(ex_out, qs, it, iters, fixed, g, (size_t)h * w);
    if (fixed) break;
  }
  if (EXTRA && ex_out.drift2 != nullptr) ex_out.drift2[g] = d2;
  store(qs, pos, col, x, y, w, fx, fy);
}

size_t smem_bytes(int E, int th) {
  return Layout::BYTES * (size_t)(th + 2 * E) * (size_t)((TW + 2 * E) | 1);
}

template <bool EXTRA>
int launch(const float* lab, const float* sentinel, float* pos, float* col,
           const Geometry& gm, const Extra& ex, int E, int reach, int iters,
           int th, int wide, float hs2, float hr2, cudaStream_t stream) {
  const dim3 grid((gm.w + TW - 1) / TW, (gm.h + th - 1) / th);
  if (wide) {
    ms_filter_wide_kernel<EXTRA><<<grid, TW * th, 0, stream>>>(
        lab, sentinel, pos, col, gm, ex, E, reach, iters, hs2, hr2);
    return (int)cudaGetLastError();
  }
  const size_t smem = smem_bytes(E, th);
  cudaError_t err = cudaFuncSetAttribute(
      ms_filter_kernel<EXTRA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ms_filter_kernel<EXTRA><<<grid, TW * th, smem, stream>>>(
      lab, sentinel, pos, col, gm, ex, E, reach, iters, hs2, hr2);
  return (int)cudaGetLastError();
}

}  // namespace

// wide: the wide form (th query rows a block, nothing staged). The input
// is in_h x in_w, query (y, x) at its pixel (off + y, off + x) and at frame
// coordinates (row0 + y, col0 + x); drift2 and traj may be null (see the
// header).
extern "C" int ms_filter_launch(const void* lab, const void* sentinel,
                                void* pos, void* col, void* drift2,
                                void* traj, int in_h, int in_w, int h, int w,
                                int off, int row0, int col0, int E, int reach,
                                int iters, int th, int wide, float hs2,
                                float hr2, void* stream) {
  if (E < 0 || (E > MAX_E && !wide) || th < MIN_TH || th > MAX_TH ||
      off < 0 || off + h > in_h || off + w > in_w)
    return (int)cudaErrorInvalidValue;
  const Geometry gm = {in_h, in_w, h, w, off, row0, col0};
  const Extra ex = {(float*)drift2, (float*)traj};
  if (drift2 != nullptr || traj != nullptr)
    return launch<true>((const float*)lab, (const float*)sentinel,
                        (float*)pos, (float*)col, gm, ex, E, reach, iters,
                        th, wide, hs2, hr2, (cudaStream_t)stream);
  return launch<false>((const float*)lab, (const float*)sentinel,
                       (float*)pos, (float*)col, gm, ex, E, reach, iters, th,
                       wide, hs2, hr2, (cudaStream_t)stream);
}

// Blocks of the kernel (wide: of the wide form) one SM holds at once for
// window E and th query rows, or -(CUDA error).
extern "C" int ms_filter_blocks_per_sm(int E, int th, int wide) {
  int blocks = 0;
  cudaError_t err;
  if (wide) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, ms_filter_wide_kernel<false>, TW * th, 0);
  } else {
    const size_t smem = smem_bytes(E, th);
    err = cudaFuncSetAttribute(ms_filter_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, ms_filter_kernel<false>, TW * th, smem);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" const char* ms_filter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
