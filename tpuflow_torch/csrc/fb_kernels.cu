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
// winsize x winsize box sum of each channel, scales it by 1/winsize^2,
// and solves the 2x2 system per pixel with |det| clamped at 1e-9:
//
//     u = (m22*h1 - m12*h2) / det,   v = (m11*h2 - m12*h1) / det
//
// What bounds them on the H100. Poly expansion: ~3(2n-1) + 6(2n-1) + 55
// float operations per output pixel (364 at n = 17 taps), each its own
// instruction under -fmad=false, against 24 bytes of device memory (4 in,
// 20 out): instruction issue first, then the output bytes. Its design is
// csrc/sepconv.cu's: streamed inputs past register accumulators, in tap
// order, so each input is loaded once per thread instead of once per tap.
// - A block writes a PH x PW = 16 x 128 output tile with 256 threads.
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
//   with the count at run time (a loop over chunks of PR taps).
// Blur-solve holds one channel's window at a time in shared memory and
// sums it by direct tap loops (2*winsize adds per pixel and channel for 20
// bytes in and 8 out), so a 64-wide window fits a block (about 105 KB).
// Each launch replaces six separable passes (poly) or five box passes plus
// the solve (blur-solve): the intermediates stay on chip. The TPU kernels'
// 8-tap block sums and aligned margins are not carried over.
//
// The build disables FMA contraction and every sum runs in the plain
// versions' order, so the kernels round as PyTorch's eager ops do.

#include <cuda_runtime.h>

#define FB_MAX_TAPS 64

namespace {

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

// The tap sets of one input stream, as indices into PolyTaps::k.
template <int... SEL>
struct Sets {};

// Taps d .. d + PR - 1 (those below n) of one input stream into one bank
// of PR accumulators per tap set: tap d + s of set k[SEL[t]] is added to
// acc[t][j] from input d + s + j, which is cur[s + j] (inputs d .. d + PR -
// 1) or nxt[s + j - PR] (inputs d + PR .. d + 2PR - 1); the indices are
// compile-time. FIRST: the chunk of tap 0, which starts each accumulator.
template <bool FIRST, int... SEL>
__device__ __forceinline__ void poly_chunk(
    Sets<SEL...>, const PolyTaps& taps, int d, int n, const float (&cur)[PR],
    const float (&nxt)[PR], float (&acc)[sizeof...(SEL)][PR]) {
  constexpr int sel[] = {SEL...};
#pragma unroll
  for (int s = 0; s < PR; ++s) {
    if (d + s < n) {
#pragma unroll
      for (int t = 0; t < (int)sizeof...(SEL); ++t) {
        const float tap = taps.k[sel[t]][d + s];
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
// inputs becomes a renaming of registers. N == 0 takes n at run time.
template <int N, int... SEL, typename Load>
__device__ __forceinline__ void poly_stream(
    Sets<SEL...> sets, const PolyTaps& taps, int n_run, const Load& load,
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
      poly_chunk<true>(sets, taps, d, n, cur, nxt, acc);
    else
      poly_chunk<false>(sets, taps, d, n, cur, nxt, acc);
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

// One output row of G^-1 for the thread's PR outputs, into dst[0 ..
// PR - 1]: the sum starts from -0, which adding a term leaves that term,
// so the first kept term starts it; a row with no kept coefficient is 0.
__device__ __forceinline__ void combine(const PolyTaps& taps, int r,
                                        const float (&m)[6][PR],
                                        float* dst) {
  float out[PR];
#pragma unroll
  for (int j = 0; j < PR; ++j) out[j] = -0.f;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    if (taps.nonzero >> (6 * r + q) & 1) {
      const float coef = taps.ginv[r][q];
#pragma unroll
      for (int j = 0; j < PR; ++j) out[j] = out[j] + coef * m[q][j];
    }
  }
  const bool none = !(taps.nonzero >> (6 * r) & 63);
#pragma unroll
  for (int j = 0; j < PR; ++j) dst[j] = none ? 0.f : out[j];
}

// N > 0: the tap count compiled in (kernel_for's 11 and 17), four blocks
// an SM; 0: taken at run time, two.
template <int N>
__global__ void __launch_bounds__(P_THREADS, N > 0 ? 4 : 2)
    fb_poly_expansion_kernel(
    const float* __restrict__ in, float* __restrict__ b1,
    float* __restrict__ b2, float* __restrict__ a11, float* __restrict__ a22,
    float* __restrict__ a12, int hp, int wp, int ho, int wo, int taps_n,
    const __grid_constant__ PolyTaps taps) {
  if (N > 0) taps_n = N;
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
    poly_stream<N>(Sets<0, 1, 2>{}, taps, taps_n, [&](int q) {
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
      poly_stream<N>(Sets<0, 1, 2>{}, taps, taps_n,
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
      poly_stream<N>(Sets<0, 1>{}, taps, taps_n,
                     [&](int q) { return s_rgx[o + q]; }, acc);
#pragma unroll
      for (int j = 0; j < PR; ++j) {
        m[2][j] = acc[0][j];
        m[5][j] = acc[1][j];
      }
    }
    {
      float acc[1][PR];  // m02
      poly_stream<N>(Sets<0>{}, taps, taps_n,
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

// -- box aggregation + solve -------------------------------------------------

__global__ void fb_blur_solve_kernel(const float* __restrict__ m_in,
                                     float* __restrict__ u_out,
                                     float* __restrict__ v_out, int hp,
                                     int wp, int ho, int wo, int win,
                                     float inv_area, int tile_h,
                                     int tile_w) {
  extern __shared__ float smem[];
  const int sh = tile_h + win - 1;
  const int sw = tile_w + win - 1;
  float* s_in = smem;                    // sh x sw window of one channel
  float* s_rows = s_in + sh * sw;        // tile_h x sw row sums
  float* s_blur = s_rows + tile_h * sw;  // 5 x tile_h x tile_w
  const int row0 = blockIdx.y * tile_h;
  const int col0 = blockIdx.x * tile_w;
  const int n_core = tile_h * tile_w;

  for (int ch = 0; ch < 5; ++ch) {
    const float* src = m_in + (size_t)ch * hp * wp;
    for (int i = threadIdx.x; i < sh * sw; i += blockDim.x) {
      const int y = row0 + i / sw;
      const int x = col0 + i % sw;
      s_in[i] = (y < hp && x < wp) ? src[(size_t)y * wp + x] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tile_h * sw; i += blockDim.x) {
      const float* p = s_in + (i / sw) * sw + i % sw;
      float acc = p[0];
      for (int d = 1; d < win; ++d) acc = acc + p[d * sw];
      s_rows[i] = acc;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n_core; i += blockDim.x) {
      const float* p = s_rows + (i / tile_w) * sw + i % tile_w;
      float acc = p[0];
      for (int d = 1; d < win; ++d) acc = acc + p[d];
      s_blur[ch * n_core + i] = acc * inv_area;
    }
    // The next channel overwrites s_in and s_rows.
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n_core; i += blockDim.x) {
    const int y = row0 + i / tile_w;
    const int x = col0 + i % tile_w;
    if (y >= ho || x >= wo) continue;
    const float m11 = s_blur[i];
    const float m12 = s_blur[n_core + i];
    const float m22 = s_blur[2 * n_core + i];
    const float h1 = s_blur[3 * n_core + i];
    const float h2 = s_blur[4 * n_core + i];
    float det = m11 * m22 - m12 * m12;
    if (fabsf(det) < 1e-9f) det = 1e-9f;
    const size_t g = (size_t)y * wo + x;
    u_out[g] = (m22 * h1 - m12 * h2) / det;
    v_out[g] = (m11 * h2 - m12 * h1) / det;
  }
}

}  // namespace

extern "C" int fb_poly_expansion_launch(
    const void* in, void* b1, void* b2, void* a11, void* a22, void* a12,
    int hp, int wp, const float* g, const float* gx, const float* gxx,
    int taps_n, const float* ginv, int tile_h, int tile_w, int threads,
    void* stream) {
  if (taps_n < 1 || taps_n > FB_MAX_TAPS || hp < taps_n || wp < taps_n ||
      tile_h != PH || tile_w != PW || threads != P_THREADS)
    return (int)cudaErrorInvalidValue;
  PolyTaps k;
  for (int d = 0; d < FB_MAX_TAPS; ++d) {
    k.k[0][d] = d < taps_n ? g[d] : 0.f;
    k.k[1][d] = d < taps_n ? gx[d] : 0.f;
    k.k[2][d] = d < taps_n ? gxx[d] : 0.f;
  }
  k.nonzero = 0;
  for (int r = 0; r < 5; ++r)
    for (int q = 0; q < 6; ++q) {
      k.ginv[r][q] = ginv[r * 6 + q];
      if (ginv[r * 6 + q] != 0.f) k.nonzero |= 1 << (6 * r + q);
    }
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
      (float*)a12, hp, wp, ho, wo, taps_n, k);
  return (int)cudaGetLastError();
}

// Blocks of the poly kernel one SM holds at once for taps_n taps, or
// -(CUDA error).
extern "C" int fb_poly_expansion_blocks_per_sm(int taps_n) {
  const size_t smem = poly_smem_bytes(taps_n);
  const PolyFn kernel = poly_kernel_for(taps_n);
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        P_THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" int fb_blur_solve_launch(const void* m_in, void* u_out,
                                    void* v_out, int hp, int wp, int win,
                                    float inv_area, int tile_h, int tile_w,
                                    int threads, void* stream) {
  if (win < 1 || hp < win || wp < win) return (int)cudaErrorInvalidValue;
  const int ho = hp - win + 1;
  const int wo = wp - win + 1;
  const size_t smem =
      sizeof(float) * (((size_t)(tile_h + win - 1) + (size_t)tile_h) *
                           (size_t)(tile_w + win - 1) +
                       5 * (size_t)tile_h * (size_t)tile_w);
  cudaError_t err = cudaFuncSetAttribute(
      fb_blur_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((wo + tile_w - 1) / tile_w, (ho + tile_h - 1) / tile_h);
  fb_blur_solve_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)m_in, (float*)u_out, (float*)v_out, hp, wp, ho, wo, win,
      inv_area, tile_h, tile_w);
  return (int)cudaGetLastError();
}

extern "C" const char* fb_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
