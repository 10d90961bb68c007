// Farneback polynomial expansion and box aggregation + solve for Hopper
// (sm_90a).
//
// fb_poly_expansion replaces tpuflow/kernels/fb_kernels.py::
// fb_poly_expansion_pallas (the TPU kernel _fb_poly_kernel). On a
// CLAMP-padded (hp, wp) image and n = 2k+1 applicability taps g, gx = g*x,
// gxx = g*x^2 it computes three vertical passes (down the columns)
//
//     rg = rows(g), rgx = rows(gx), rgxx = rows(gxx)
//
// feeding six horizontal passes, the moments in basis order [1, x, y,
// x^2, y^2, xy]:
//
//     m00 = cols(rg, g),   m10 = cols(rg, gx),  m01 = cols(rgx, g),
//     m20 = cols(rg, gxx), m02 = cols(rgxx, g), m11 = cols(rgx, gx)
//
// and combines them by five rows of G^-1 (rows 1-4 and 0.5 x row 5) into
// (b1, b2, a11, a22, a12). A coefficient that is exactly zero is
// skipped, and the first kept term starts the sum, as in the TPU kernel.
//
// fb_blur_solve replaces fb_kernels.py::fb_blur_solve_pallas (the TPU
// kernel _fb_kernel). On the edge-padded 5-channel normal-equation field
// M = (m11, m12, m22, h1, h2), shape (5, hp, wp), it takes the VALID
// winsize x winsize box sum of each channel (rows added top to bottom,
// then columns left to right), scales it by 1/winsize^2, and solves the
// 2x2 system per pixel with |det| clamped at 1e-9:
//
//     u = (m22*h1 - m12*h2) / det,   v = (m11*h2 - m12*h1) / det
//
// What bounds them on the H100. Poly expansion: ~3(2n-1) + 6(2n-1) + 55
// float operations per output pixel (364 at n = 17 taps), each its own
// instruction under -fmad=false, against 24 bytes of device memory (4 in,
// 20 out): instruction issue first, then the output bytes. Blur-solve:
// 5 * 2(winsize - 1) adds per output pixel (470 at winsize 48) against 28
// bytes (20 in, 8 out): the adds' issue, and the block's window of five
// channels read through L2. Both take csrc/sepconv.cu's design: streamed
// inputs past register accumulators, in tap order, so each input is
// loaded once per thread instead of once per tap.
// - Poly: a block writes a PH x PW = 16 x 128 output tile with 256 threads.
// - Vertical passes: a thread owns one of the tile's PW + n - 1 columns
//   and PR = 8 consecutive rows. It streams the column's PR + n - 1 inputs
//   from device memory (neighbouring threads take neighbouring columns, so
//   the loads coalesce) past three banks of PR accumulators, one each for
//   g, gx and gxx: at tap d input j + d goes into accumulator j, tap by
//   tap, the plain order. rg, rgx and rgxx go to shared memory, rows of an
//   odd pitch.
// - Horizontal passes: a thread owns one tile row and PR consecutive
//   outputs. It streams rg past three banks (m00, m10, m20), then rgx past
//   two (m01, m11), then rgxx past one (m02), each in tap order, and
//   combines its 6 x PR moments into 5 x PR outputs (combine; the
//   coefficients' zero mask is one launch argument, the same for the
//   whole warp). A warp covers 16 rows and two column groups 16 floats
//   apart, so its shared reads and writes hit 32 banks.
// - Stores: the outputs go through shared tiles of pitch PW + 1 and leave
//   them in coalesced rows: b1, b2, a11 into the space of rg, rgx, rgxx
//   once every thread has read them, a22 and a12 into their own, so a
//   block takes ~44 KB at 17 taps and an SM holds four (64 registers a
//   thread).
// - The tap counts of the main paths (11 and 17: poly_n 5 and 8) are
//   compiled in, so their chunks unroll whole and the taps are constant
//   operands; every other count up to FB_MAX_TAPS takes one instantiation
//   with the count at run time (a loop over chunks of PR taps), and a
//   larger count the instantiation whose taps come from device memory
//   (DEVICE_TAPS; the wrapper copies them there).
// - Blur-solve: a block writes a BH x BW = 16 x 128 output tile with 256
//   threads and runs the vertical passes of all five channels first: a
//   thread owns one of the tile's BW + winsize - 1 columns of one channel
//   and its BV = 16 rows, streams the column's BV + winsize - 1 inputs from
//   device memory past BV accumulators (the box taps are ones: adds
//   only), and stores the row sums in shared memory (five planes of an odd
//   pitch). After one barrier a thread owns BR = 8 consecutive outputs of
//   one row (the poly kernel's lane map: 32 banks), streams each channel's
//   row sums past BR accumulators, keeps the five scaled sums in registers
//   and solves there; u and v go straight to device memory. No result
//   tile, one barrier a block. Winsize 48 and 64 (the FB stream's and the
//   demo's) are compiled in, three blocks an SM; every other winsize takes
//   the run-time instantiation, two.
// - Wide forms. Where a tile's intermediates do not fit one block's shared
//   memory (poly above ~1,000 taps, blur-solve above winsize ~600), two
//   kernels run instead, one thread an output each: the vertical sums into
//   device scratch, then the horizontal sums with the combine or the
//   solve, every sum in the same order.
// Each launch replaces six separable passes (poly) or five box passes plus
// the solve (blur-solve): the intermediates stay on chip. The TPU kernels'
// 8-tap block sums and aligned margins are not carried over.
//
// The build disables FMA contraction and every sum runs in the plain
// versions' order, so the kernels round as PyTorch's eager ops do.

#include <cuda_runtime.h>

#define FB_MAX_TAPS 64

namespace {

// The template argument of the instantiations whose taps come from device
// memory (any count).
constexpr int DEVICE_TAPS = -1;
constexpr int WIDE_THREADS = 256;  // threads of a wide form's block

// -- polynomial expansion ---------------------------------------------------

constexpr int PH = 16;           // output rows of a block
constexpr int PW = 128;          // output columns of a block
constexpr int PR = 8;            // outputs a thread accumulates in a pass
constexpr int P_THREADS = 256;
constexpr int P_GROUPS = PH / PR;  // row groups of the vertical pass
constexpr int LOG_PW = 7;
constexpr int P_OUT_PITCH = PW + 1;
static_assert(1 << LOG_PW == PW, "poly tile width");
static_assert(PH * (PW / PR) == P_THREADS, "one horizontal item a thread");

struct PolyTaps {
  float k[3][FB_MAX_TAPS];  // g, gx, gxx
  float ginv[5][6];
  int nonzero;              // bit 6j + q: ginv[j][q] != 0
};

// Tap sets in device memory: set s's n taps at p + s * n, read through
// the read-only cache (the whole warp reads one tap at a time).
struct DeviceSet {
  const float* p;
  __device__ float operator[](int i) const { return __ldg(p + i); }
};
struct DeviceSets {
  const float* p;
  int n;
  __device__ DeviceSet operator[](int s) const { return {p + s * n}; }
};

// The tap sets an instantiation reads: the parameter bank's, or device
// memory's for DEVICE_TAPS.
template <int N>
__device__ __forceinline__ decltype(auto) poly_bank(const PolyTaps& taps,
                                                    const float* dev, int n) {
  if constexpr (N == DEVICE_TAPS)
    return DeviceSets{dev, n};
  else
    return (taps.k);
}

// The tap sets of one input stream, as indices into the tap sets.
template <int... SEL>
struct Sets {};

// Taps d .. d + PR - 1 (those below n) of one input stream into one bank
// of PR accumulators per tap set: tap d + s of set k[SEL[t]] is added to
// acc[t][j] from input d + s + j, which is cur[s + j] (inputs d .. d + PR -
// 1) or nxt[s + j - PR] (inputs d + PR .. d + 2PR - 1); the indices are
// compile-time. FIRST: the chunk of tap 0, which starts each accumulator.
template <bool FIRST, int... SEL, typename K>
__device__ __forceinline__ void poly_chunk(
    Sets<SEL...>, const K& k, int d, int n, const float (&cur)[PR],
    const float (&nxt)[PR], float (&acc)[sizeof...(SEL)][PR]) {
  constexpr int sel[] = {SEL...};
#pragma unroll
  for (int s = 0; s < PR; ++s) {
    if (d + s < n) {
#pragma unroll
      for (int t = 0; t < (int)sizeof...(SEL); ++t) {
        const float tap = k[sel[t]][d + s];
#pragma unroll
        for (int j = 0; j < PR; ++j) {
          const float p = tap * (s + j < PR ? cur[s + j] : nxt[s + j - PR]);
          acc[t][j] = (FIRST && s == 0) ? p : acc[t][j] + p;
        }
      }
    }
  }
}

// acc[t][j] = sum_{d < n} k[SEL[t]][d] * load(j + d), each sum in tap
// order. Each input load(q), q < PR + n - 1, is read once, a chunk of PR
// taps before it is used. N > 0 compiles the tap count in (n == N): the
// chunks unroll, their bounds checks fold away and the hand-on of the
// inputs becomes a renaming of registers. Otherwise n is taken at run
// time.
template <int N, int... SEL, typename K, typename Load>
__device__ __forceinline__ void poly_stream(
    Sets<SEL...> sets, const K& k, int n_run, const Load& load,
    float (&acc)[sizeof...(SEL)][PR]) {
  const int n = N > 0 ? N : n_run;
  const int inputs = PR + n - 1;
  float cur[PR], nxt[PR];
#pragma unroll
  for (int q = 0; q < PR; ++q) {
    cur[q] = load(q);
    nxt[q] = PR + q < inputs ? load(PR + q) : 0.f;
  }
  auto step = [&](int d) {
    float pre[PR];
#pragma unroll
    for (int q = 0; q < PR; ++q)
      pre[q] = d + 2 * PR + q < inputs ? load(d + 2 * PR + q) : 0.f;
    if (d == 0)
      poly_chunk<true>(sets, k, d, n, cur, nxt, acc);
    else
      poly_chunk<false>(sets, k, d, n, cur, nxt, acc);
#pragma unroll
    for (int q = 0; q < PR; ++q) {
      cur[q] = nxt[q];
      nxt[q] = pre[q];
    }
  };
  if constexpr (N > 0) {
#pragma unroll
    for (int d = 0; d < N; d += PR) step(d);
  } else {
#pragma unroll 1
    for (int d = 0; d < n; d += PR) step(d);
  }
}

// One output row of G^-1 for a thread's RR outputs, into dst[0 .. RR - 1]:
// the sum starts from -0, which adding a term leaves that term, so the
// first kept term starts it; a row with no kept coefficient is 0.
template <int RR>
__device__ __forceinline__ void combine(const PolyTaps& taps, int r,
                                        const float (&m)[6][RR],
                                        float* dst) {
  float out[RR];
#pragma unroll
  for (int j = 0; j < RR; ++j) out[j] = -0.f;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    if (taps.nonzero >> (6 * r + q) & 1) {
      const float coef = taps.ginv[r][q];
#pragma unroll
      for (int j = 0; j < RR; ++j) out[j] = out[j] + coef * m[q][j];
    }
  }
  const bool none = !(taps.nonzero >> (6 * r) & 63);
#pragma unroll
  for (int j = 0; j < RR; ++j) dst[j] = none ? 0.f : out[j];
}

// N > 0: the tap count compiled in (kernel_for's 11 and 17), four blocks
// an SM; 0: taken at run time, two; DEVICE_TAPS: the same, the taps in
// device memory (dev_taps: g, gx, gxx, taps_n each).
template <int N>
__global__ void __launch_bounds__(P_THREADS, N > 0 ? 4 : 2)
    fb_poly_expansion_kernel(
    const float* __restrict__ in, float* __restrict__ b1,
    float* __restrict__ b2, float* __restrict__ a11, float* __restrict__ a22,
    float* __restrict__ a12, int hp, int wp, int ho, int wo, int taps_n,
    const float* __restrict__ dev_taps,
    const __grid_constant__ PolyTaps taps) {
  if (N > 0) taps_n = N;
  const auto& k = poly_bank<N>(taps, dev_taps, taps_n);
  extern __shared__ float smem[];
  const int ncols = PW + taps_n - 1;  // the vertical passes' columns
  const int pitch = ncols | 1;        // odd: lanes on rows hit other banks
  float* s_rg = smem;                 // PH x pitch each
  float* s_rgx = s_rg + PH * pitch;
  float* s_rgxx = s_rgx + PH * pitch;
  // b1, b2, a11 (3 x PH x P_OUT_PITCH) over rg, rgx, rgxx once they are
  // read; a22, a12 (2 x PH x P_OUT_PITCH) after them.
  float* s_out3 = smem;
  float* s_out2 = s_rgxx + PH * pitch;
  constexpr int OUT_TILE = PH * P_OUT_PITCH;
  const int row0 = blockIdx.y * PH;
  const int col0 = blockIdx.x * PW;
  const int tid = threadIdx.x;

  // Vertical passes: item (c, g) is column c, rows g*PR .. g*PR + PR - 1,
  // taken in the order g*ncols + c, tid + k*P_THREADS.
  int c = tid;
  int g = 0;
  while (c >= ncols) {
    c -= ncols;
    ++g;
  }
  while (g < P_GROUPS) {
    const int x = col0 + c;
    const int y = row0 + g * PR;
    const float* col = in + x;
    const bool x_in = x < wp;
    float acc[3][PR];
    // Rows past the padded image feed only outputs past the frame.
    poly_stream<N>(Sets<0, 1, 2>{}, k, taps_n, [&](int q) {
      return x_in && y + q < hp ? __ldg(col + (size_t)(y + q) * wp) : 0.f;
    }, acc);
#pragma unroll
    for (int j = 0; j < PR; ++j) {
      const int o = (g * PR + j) * pitch + c;
      s_rg[o] = acc[0][j];
      s_rgx[o] = acc[1][j];
      s_rgxx[o] = acc[2][j];
    }
    c += P_THREADS;
    while (c >= ncols) {
      c -= ncols;
      ++g;
    }
  }
  __syncthreads();

  // Horizontal passes: lane l of warp w takes row l % 16 and column group
  // (w & 1) + 4 (w >> 1) + 2 (l >= 16), 16 floats from the other half's.
  {
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int row = lane & (PH - 1);
    const int c0 = ((warp & 1) + 4 * (warp >> 1) + 2 * (lane >> 4)) * PR;
    const int o = row * pitch + c0;
    float m[6][PR];
    {
      float acc[3][PR];  // m00, m10, m20
      poly_stream<N>(Sets<0, 1, 2>{}, k, taps_n,
                     [&](int q) { return s_rg[o + q]; }, acc);
#pragma unroll
      for (int j = 0; j < PR; ++j) {
        m[0][j] = acc[0][j];
        m[1][j] = acc[1][j];
        m[3][j] = acc[2][j];
      }
    }
    {
      float acc[2][PR];  // m01, m11
      poly_stream<N>(Sets<0, 1>{}, k, taps_n,
                     [&](int q) { return s_rgx[o + q]; }, acc);
#pragma unroll
      for (int j = 0; j < PR; ++j) {
        m[2][j] = acc[0][j];
        m[5][j] = acc[1][j];
      }
    }
    {
      float acc[1][PR];  // m02
      poly_stream<N>(Sets<0>{}, k, taps_n,
                     [&](int q) { return s_rgxx[o + q]; }, acc);
#pragma unroll
      for (int j = 0; j < PR; ++j) m[4][j] = acc[0][j];
    }
    const int at = row * P_OUT_PITCH + c0;
    combine(taps, 3, m, s_out2 + at);
    combine(taps, 4, m, s_out2 + OUT_TILE + at);
    __syncthreads();  // every thread has read rg, rgx, rgxx
#pragma unroll
    for (int r = 0; r < 3; ++r)
      combine(taps, r, m, s_out3 + r * OUT_TILE + at);
  }
  __syncthreads();

  float* outs[5] = {b1, b2, a11, a22, a12};
  for (int i = tid; i < PH * PW; i += P_THREADS) {
    const int row = i >> LOG_PW;
    const int col = i & (PW - 1);
    const int y = row0 + row;
    const int x = col0 + col;
    if (y < ho && x < wo) {
      const size_t gi = (size_t)y * wo + x;
      const int at = row * P_OUT_PITCH + col;
#pragma unroll
      for (int r = 0; r < 5; ++r)
        outs[r][gi] = r < 3 ? s_out3[r * OUT_TILE + at]
                            : s_out2[(r - 3) * OUT_TILE + at];
    }
  }
}

using PolyFn = decltype(&fb_poly_expansion_kernel<0>);

PolyFn poly_kernel_for(int taps_n) {
  if (taps_n > FB_MAX_TAPS) return fb_poly_expansion_kernel<DEVICE_TAPS>;
  switch (taps_n) {
    case 11: return fb_poly_expansion_kernel<11>;
    case 17: return fb_poly_expansion_kernel<17>;
  }
  return fb_poly_expansion_kernel<0>;
}

// rg, rgx, rgxx (which b1, b2, a11 then take over: pitch >= PW + 1), and
// a22, a12.
size_t poly_smem_bytes(int taps_n) {
  return sizeof(float) *
         (3 * (size_t)PH * (size_t)((PW + taps_n - 1) | 1) +
          2 * (size_t)PH * P_OUT_PITCH);
}

// The wide form's vertical passes: rg, rgx, rgxx at (blockIdx.x, x) of
// (ho, wp) into three planes of `rows`, each sum in tap order.
__global__ void fb_poly_wide_rows_kernel(const float* __restrict__ in,
                                         float* __restrict__ rows, int wp,
                                         int ho, int taps_n,
                                         const float* __restrict__ k) {
  const int y = blockIdx.x;
  const int x = blockIdx.y * blockDim.x + threadIdx.x;
  if (x >= wp) return;
  const float* p = in + (size_t)y * wp + x;
  float acc[3];
  for (int d = 0; d < taps_n; ++d) {
    const float a = __ldg(p + (size_t)d * wp);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const float term = __ldg(k + t * taps_n + d) * a;
      acc[t] = d == 0 ? term : acc[t] + term;
    }
  }
  const size_t plane = (size_t)ho * wp;
#pragma unroll
  for (int t = 0; t < 3; ++t) rows[t * plane + (size_t)y * wp + x] = acc[t];
}

// The wide form's horizontal passes at (blockIdx.x, x) of (ho, wo): the six
// moments, each in tap order, then the five rows of G^-1.
__global__ void fb_poly_wide_cols_kernel(
    const float* __restrict__ rows, float* __restrict__ b1,
    float* __restrict__ b2, float* __restrict__ a11, float* __restrict__ a22,
    float* __restrict__ a12, int wp, int ho, int wo, int taps_n,
    const float* __restrict__ k, const __grid_constant__ PolyTaps taps) {
  const int y = blockIdx.x;
  const int x = blockIdx.y * blockDim.x + threadIdx.x;
  if (x >= wo) return;
  const size_t plane = (size_t)ho * wp;
  const float* rg = rows + (size_t)y * wp + x;
  const float* rgx = rg + plane;
  const float* rgxx = rgx + plane;
  float m[6][1];
  for (int d = 0; d < taps_n; ++d) {
    const float g = __ldg(k + d);
    const float gx = __ldg(k + taps_n + d);
    const float gxx = __ldg(k + 2 * taps_n + d);
    const float a = __ldg(rg + d), b = __ldg(rgx + d), c = __ldg(rgxx + d);
    // [1, x, y, x^2, y^2, xy]: (rg, g), (rg, gx), (rgx, g), (rg, gxx),
    // (rgxx, g), (rgx, gx).
    const float term[6] = {g * a, gx * a, g * b, gxx * a, g * c, gx * b};
#pragma unroll
    for (int q = 0; q < 6; ++q) m[q][0] = d == 0 ? term[q] : m[q][0] + term[q];
  }
  const size_t gi = (size_t)y * wo + x;
  float* outs[5] = {b1, b2, a11, a22, a12};
#pragma unroll
  for (int r = 0; r < 5; ++r) combine(taps, r, m, outs[r] + gi);
}

// -- box aggregation + solve -------------------------------------------------

constexpr int BH = 16;          // output rows of a block
constexpr int BW = 128;         // output columns of a block
constexpr int BV = BH;          // rows a thread sums in a vertical pass
constexpr int BR = 8;           // outputs a thread sums in a horizontal pass
constexpr int B_THREADS = 256;
constexpr int B_GROUP = 5;      // channels whose row sums are staged at once
static_assert(BH * (BW / BR) == B_THREADS, "one horizontal item a thread");
static_assert(5 % B_GROUP == 0, "whole channel groups");

// Terms d .. d + RR - 1 (those below n) of a box sum: term d + s goes into
// accumulator j from input d + s + j, which is cur[s + j] or nxt[s + j -
// RR]. FIRST: the chunk of term 0, which starts each accumulator.
template <bool FIRST, int RR>
__device__ __forceinline__ void box_chunk(int d, int n,
                                          const float (&cur)[RR],
                                          const float (&nxt)[RR],
                                          float (&acc)[RR]) {
#pragma unroll
  for (int s = 0; s < RR; ++s) {
    if (d + s < n) {
#pragma unroll
      for (int j = 0; j < RR; ++j) {
        const float x = s + j < RR ? cur[s + j] : nxt[s + j - RR];
        acc[j] = (FIRST && s == 0) ? x : acc[j] + x;
      }
    }
  }
}

// acc[j] = load(j) + load(j + 1) + ... + load(j + n - 1), from the first
// term on, in order: the plain box sum's order. Each input load(q), q <
// RR + n - 1, is read once, a chunk of RR terms before it is used. N > 0
// compiles n in.
template <int N, int RR, typename Load>
__device__ __forceinline__ void box_stream(int n_run, const Load& load,
                                           float (&acc)[RR]) {
  const int n = N > 0 ? N : n_run;
  const int inputs = RR + n - 1;
  float cur[RR], nxt[RR];
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    cur[q] = load(q);
    nxt[q] = RR + q < inputs ? load(RR + q) : 0.f;
  }
  auto step = [&](int d) {
    float pre[RR];
#pragma unroll
    for (int q = 0; q < RR; ++q)
      pre[q] = d + 2 * RR + q < inputs ? load(d + 2 * RR + q) : 0.f;
    if (d == 0)
      box_chunk<true>(d, n, cur, nxt, acc);
    else
      box_chunk<false>(d, n, cur, nxt, acc);
#pragma unroll
    for (int q = 0; q < RR; ++q) {
      cur[q] = nxt[q];
      nxt[q] = pre[q];
    }
  };
  if constexpr (N > 0) {
#pragma unroll
    for (int d = 0; d < N; d += RR) step(d);
  } else {
#pragma unroll 1
    for (int d = 0; d < n; d += RR) step(d);
  }
}

// solve_2x2 at one pixel, into u[g], v[g].
__device__ __forceinline__ void solve_store(float m11, float m12, float m22,
                                            float h1, float h2,
                                            float* __restrict__ u,
                                            float* __restrict__ v, size_t g) {
  float det = m11 * m22 - m12 * m12;
  if (fabsf(det) < 1e-9f) det = 1e-9f;
  u[g] = (m22 * h1 - m12 * h2) / det;
  v[g] = (m11 * h2 - m12 * h1) / det;
}

// W > 0: the winsize compiled in (blur_kernel_for's 48 and 64), three
// blocks an SM (80 registers); 0: taken at run time, two (three would
// spill).
template <int W>
__global__ void __launch_bounds__(B_THREADS, W > 0 ? 3 : 2)
    fb_blur_solve_kernel(
    const float* __restrict__ m_in, float* __restrict__ u_out,
    float* __restrict__ v_out, int hp, int wp, int ho, int wo, int win,
    float inv_area) {
  if (W > 0) win = W;
  extern __shared__ float smem[];
  const int ncols = BW + win - 1;  // the vertical passes' columns
  const int pitch = ncols | 1;     // odd: lanes on rows hit other banks
  const int plane = BH * pitch;    // one channel's row sums
  const int row0 = blockIdx.y * BH;
  const int col0 = blockIdx.x * BW;
  const int tid = threadIdx.x;
  // Horizontal item: lane l of warp w takes row l % 16 and column group
  // (w & 1) + 4 (w >> 1) + 2 (l >= 16), 16 floats from the other half's.
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = lane & (BH - 1);
  const int c0 = ((warp & 1) + 4 * (warp >> 1) + 2 * (lane >> 4)) * BR;
  float blur[5][BR];

#pragma unroll
  for (int g0 = 0; g0 < 5; g0 += B_GROUP) {
    // Vertical passes: item (ch, c) is column c of channel g0 + ch, all BV
    // rows, taken in the order ch*ncols + c, tid + k*B_THREADS.
    int c = tid;
    int ch = 0;
    while (c >= ncols) {
      c -= ncols;
      ++ch;
    }
    while (ch < B_GROUP) {
      const int x = col0 + c;
      const bool x_in = x < wp;
      const float* col = m_in + (size_t)(g0 + ch) * hp * wp + x;
      float acc[BV];
      // Rows past the padded field feed only outputs past the frame.
      box_stream<W>(win, [&](int q) {
        return x_in && row0 + q < hp ? __ldg(col + (size_t)(row0 + q) * wp)
                                     : 0.f;
      }, acc);
      float* dst = smem + ch * plane + c;
#pragma unroll
      for (int j = 0; j < BV; ++j) dst[j * pitch] = acc[j];
      c += B_THREADS;
      while (c >= ncols) {
        c -= ncols;
        ++ch;
      }
    }
    __syncthreads();

    // Horizontal passes: each channel's BR sums stay in registers.
#pragma unroll
    for (int ch = 0; ch < B_GROUP; ++ch) {
      const float* src = smem + ch * plane + row * pitch + c0;
      float acc[BR];
      box_stream<W>(win, [&](int q) { return src[q]; }, acc);
#pragma unroll
      for (int j = 0; j < BR; ++j) blur[g0 + ch][j] = acc[j] * inv_area;
    }
    if (B_GROUP < 5) __syncthreads();  // the next group takes the space
  }

  const int y = row0 + row;
  if (y >= ho) return;
#pragma unroll
  for (int j = 0; j < BR; ++j) {
    const int x = col0 + c0 + j;
    if (x < wo)
      solve_store(blur[0][j], blur[1][j], blur[2][j], blur[3][j], blur[4][j],
                  u_out, v_out, (size_t)y * wo + x);
  }
}

using BlurFn = decltype(&fb_blur_solve_kernel<0>);

BlurFn blur_kernel_for(int win) {
  switch (win) {
    case 48: return fb_blur_solve_kernel<48>;
    case 64: return fb_blur_solve_kernel<64>;
  }
  return fb_blur_solve_kernel<0>;
}

// B_GROUP planes of row sums.
size_t blur_smem_bytes(int win) {
  return sizeof(float) * B_GROUP * (size_t)BH * (size_t)((BW + win - 1) | 1);
}

// The wide form's vertical sums: rows[ch][y][x] = M[ch][y][x] + ... +
// M[ch][y + win - 1][x] from the first term on; blockIdx.x = ch * ho + y.
__global__ void fb_blur_wide_rows_kernel(const float* __restrict__ m_in,
                                         float* __restrict__ rows, int hp,
                                         int wp, int ho, int win) {
  const int ch = blockIdx.x / ho;
  const int y = blockIdx.x - ch * ho;
  const int x = blockIdx.y * blockDim.x + threadIdx.x;
  if (x >= wp) return;
  const float* p = m_in + ((size_t)ch * hp + y) * wp + x;
  float acc = __ldg(p);
  for (int d = 1; d < win; ++d) acc = acc + __ldg(p + (size_t)d * wp);
  rows[((size_t)ch * ho + y) * wp + x] = acc;
}

// The wide form's horizontal sums of each channel at (blockIdx.x, x),
// times 1/win^2, and the solve.
__global__ void fb_blur_wide_solve_kernel(const float* __restrict__ rows,
                                          float* __restrict__ u_out,
                                          float* __restrict__ v_out, int wp,
                                          int ho, int wo, int win,
                                          float inv_area) {
  const int y = blockIdx.x;
  const int x = blockIdx.y * blockDim.x + threadIdx.x;
  if (x >= wo) return;
  float b[5];
#pragma unroll
  for (int ch = 0; ch < 5; ++ch) {
    const float* p = rows + ((size_t)ch * ho + y) * wp + x;
    float acc = __ldg(p);
    for (int d = 1; d < win; ++d) acc = acc + __ldg(p + d);
    b[ch] = acc * inv_area;
  }
  solve_store(b[0], b[1], b[2], b[3], b[4], u_out, v_out,
              (size_t)y * wo + x);
}

template <typename Fn>
int blocks_per_sm(Fn kernel, int threads, size_t smem) {
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// G^-1's rows and zero mask, and the taps where the bank holds them.
PolyTaps poly_params(const float* g, const float* gx, const float* gxx,
                     int taps_n, const float* ginv) {
  PolyTaps k;
  for (int d = 0; d < FB_MAX_TAPS; ++d) {
    const bool in = g && d < taps_n && taps_n <= FB_MAX_TAPS;
    k.k[0][d] = in ? g[d] : 0.f;
    k.k[1][d] = in ? gx[d] : 0.f;
    k.k[2][d] = in ? gxx[d] : 0.f;
  }
  k.nonzero = 0;
  for (int r = 0; r < 5; ++r)
    for (int q = 0; q < 6; ++q) {
      k.ginv[r][q] = ginv[r * 6 + q];
      if (ginv[r * 6 + q] != 0.f) k.nonzero |= 1 << (6 * r + q);
    }
  return k;
}

}  // namespace

// dev_taps: g, gx, gxx (taps_n each) on the card, needed above FB_MAX_TAPS.
extern "C" int fb_poly_expansion_launch(
    const void* in, void* b1, void* b2, void* a11, void* a22, void* a12,
    int hp, int wp, const float* g, const float* gx, const float* gxx,
    int taps_n, const float* ginv, const void* dev_taps, int tile_h,
    int tile_w, int threads, void* stream) {
  if (taps_n < 1 || hp < taps_n || wp < taps_n ||
      (taps_n > FB_MAX_TAPS && !dev_taps) || tile_h != PH || tile_w != PW ||
      threads != P_THREADS)
    return (int)cudaErrorInvalidValue;
  const PolyTaps k = poly_params(g, gx, gxx, taps_n, ginv);
  const int ho = hp - taps_n + 1;
  const int wo = wp - taps_n + 1;
  const size_t smem = poly_smem_bytes(taps_n);
  const PolyFn kernel = poly_kernel_for(taps_n);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((wo + PW - 1) / PW, (ho + PH - 1) / PH);
  kernel<<<grid, P_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)in, (float*)b1, (float*)b2, (float*)a11, (float*)a22,
      (float*)a12, hp, wp, ho, wo, taps_n, (const float*)dev_taps, k);
  return (int)cudaGetLastError();
}

// The wide form: two launches, rows (3 x (hp - taps_n + 1) x wp floats of
// scratch) between them.
extern "C" int fb_poly_expansion_wide_launch(
    const void* in, void* rows, void* b1, void* b2, void* a11, void* a22,
    void* a12, int hp, int wp, const void* dev_taps, int taps_n,
    const float* ginv, void* stream) {
  if (taps_n < 1 || hp < taps_n || wp < taps_n || !dev_taps)
    return (int)cudaErrorInvalidValue;
  const PolyTaps k = poly_params(nullptr, nullptr, nullptr, taps_n, ginv);
  const int ho = hp - taps_n + 1;
  const int wo = wp - taps_n + 1;
  const cudaStream_t s = (cudaStream_t)stream;
  fb_poly_wide_rows_kernel<<<dim3(ho, (wp + WIDE_THREADS - 1) / WIDE_THREADS),
                             WIDE_THREADS, 0, s>>>(
      (const float*)in, (float*)rows, wp, ho, taps_n,
      (const float*)dev_taps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fb_poly_wide_cols_kernel<<<dim3(ho, (wo + WIDE_THREADS - 1) / WIDE_THREADS),
                             WIDE_THREADS, 0, s>>>(
      (const float*)rows, (float*)b1, (float*)b2, (float*)a11, (float*)a22,
      (float*)a12, wp, ho, wo, taps_n, (const float*)dev_taps, k);
  return (int)cudaGetLastError();
}

// Blocks of the poly kernel one SM holds at once for taps_n taps, or
// -(CUDA error).
extern "C" int fb_poly_expansion_blocks_per_sm(int taps_n) {
  return blocks_per_sm(poly_kernel_for(taps_n), P_THREADS,
                       poly_smem_bytes(taps_n));
}

extern "C" int fb_blur_solve_launch(const void* m_in, void* u_out,
                                    void* v_out, int hp, int wp, int win,
                                    float inv_area, int tile_h, int tile_w,
                                    int threads, void* stream) {
  if (win < 1 || hp < win || wp < win || tile_h != BH || tile_w != BW ||
      threads != B_THREADS)
    return (int)cudaErrorInvalidValue;
  const int ho = hp - win + 1;
  const int wo = wp - win + 1;
  const size_t smem = blur_smem_bytes(win);
  const BlurFn kernel = blur_kernel_for(win);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((wo + BW - 1) / BW, (ho + BH - 1) / BH);
  kernel<<<grid, B_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)m_in, (float*)u_out, (float*)v_out, hp, wp, ho, wo, win,
      inv_area);
  return (int)cudaGetLastError();
}

// The wide form: two launches, rows (5 x (hp - win + 1) x wp floats of
// scratch) between them.
extern "C" int fb_blur_solve_wide_launch(const void* m_in, void* rows,
                                         void* u_out, void* v_out, int hp,
                                         int wp, int win, float inv_area,
                                         void* stream) {
  if (win < 1 || hp < win || wp < win) return (int)cudaErrorInvalidValue;
  const int ho = hp - win + 1;
  const int wo = wp - win + 1;
  const cudaStream_t s = (cudaStream_t)stream;
  fb_blur_wide_rows_kernel<<<dim3(5 * ho,
                                  (wp + WIDE_THREADS - 1) / WIDE_THREADS),
                             WIDE_THREADS, 0, s>>>(
      (const float*)m_in, (float*)rows, hp, wp, ho, win);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fb_blur_wide_solve_kernel<<<dim3(ho, (wo + WIDE_THREADS - 1) /
                                            WIDE_THREADS),
                              WIDE_THREADS, 0, s>>>(
      (const float*)rows, (float*)u_out, (float*)v_out, wp, ho, wo, win,
      inv_area);
  return (int)cudaGetLastError();
}

// Blocks of the blur-solve kernel one SM holds at once for winsize win, or
// -(CUDA error).
extern "C" int fb_blur_solve_blocks_per_sm(int win) {
  return blocks_per_sm(blur_kernel_for(win), B_THREADS, blur_smem_bytes(win));
}

extern "C" const char* fb_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
