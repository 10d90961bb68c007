// VALID separable correlation for Hopper (sm_90a).
//
// Replaces tpuflow/kernels/sepconv.py::sep_conv2d_valid_pallas (the TPU
// kernel _sep_kernel). On a pre-padded (hp, wp) image it computes
//
//     rows[y][x] = sum_{d < nky} ky[d] * in[y + d][x]
//     out[y][x]  = sum_{d < nkx} kx[d] * rows[y][x + d]
//
// for the (hp - nky + 1, wp - nkx + 1) VALID output. The caller pads for
// the border policy, exactly as the plain version's caller does.
//
// What bounds it on the H100: 2 * (nky + nkx) - 2 float operations per
// output pixel against 8 bytes of device memory (one read, one write), so
// at Farneback's taps (15-64) it is bound by the arithmetic, and a direct
// tap loop, which reads one operand per multiply and add, is bound by
// its loads before that: at 48 taps one shared-memory load per tap and
// cell, ~131 per output, with an integer / and % per cell.
//
// The design streams the taps past register accumulators, so each input
// is loaded once per thread instead of once per tap. A block writes a
// TH x TW = 64 x 128 output tile with 256 threads.
// - The first pass (ky, down the columns): a thread owns one column of the
//   tile's TW + nkx - 1 and R = 16 consecutive rows. It reads the column's
//   R + nky - 1 inputs straight from device memory (neighbouring threads
//   take neighbouring columns, so the loads coalesce), R at a time into
//   registers a chunk of R taps before they are used, and at tap d adds
//   ky[d] * in[y + j + d] to accumulator j. Each accumulator receives its
//   terms in tap order, d = 0, 1, ..., as the plain version adds them. The
//   rows go to shared memory, whose odd pitch keeps the second pass free
//   of bank conflicts.
// - The second pass (kx, along the rows): the same stream along a row of
//   the shared rows, R = 16 outputs a thread, the 32 lanes of a warp on 32
//   rows; the results go to a shared tile that the block writes out with
//   coalesced stores.
// - A tap is the same for the whole warp at each step: the taps come from
//   the kernel's parameter bank (__grid_constant__), already rounded to
//   float32 on the host, up to SEPCONV_MAX_TAPS a axis; the main paths' box
//   counts (15, 48, 64 on both axes) have it compiled in, so their chunks
//   unroll whole. Every other count, the pyramid blur's 3 and 9 among
//   them, takes one instantiation with the count at run time, and a larger
//   count the instantiation whose taps come from device memory
//   (DEVICE_TAPS; the wrapper copies them there).
// - The 128-wide tile costs the first pass (128 + nkx - 1) / 128 of the
//   output's columns: 1.37x at 48 taps, against 1.73x with 64-wide tiles.
//   At 1080x1920 the grid is 15 x 17 = 255 blocks, one wave at two blocks
//   per SM (at most 96 KB of shared memory each).
// - Threads map to cells by shifts, masks and a subtraction carried from
//   one item to the next: no integer division per cell.
// - The wide form. Where the first pass's rows do not fit one block's
//   shared memory (nkx above ~650), each pass is its own launch of
//   sep_wide_pass_kernel, one thread an output, the rows in device
//   scratch between them, the terms in the same order.
// The build disables FMA contraction and the terms are summed in the plain
// version's order (tap 0 first), so the kernel rounds as PyTorch's eager
// ops do and matches sep_conv2d_valid_plain.

#include <cuda_runtime.h>

#define SEPCONV_MAX_TAPS 128

namespace {

constexpr int TH = 64;          // output rows of a block
constexpr int TW = 128;         // output columns of a block
constexpr int R = 16;           // outputs a thread accumulates in a pass
constexpr int THREADS = 256;
constexpr int GROUPS = TH / R;  // row groups of the first pass
constexpr int LOG_TH = 6;
constexpr int LOG_TW = 7;
constexpr int OUT_PITCH = TW + 1;
static_assert(1 << LOG_TH == TH && 1 << LOG_TW == TW, "tile sizes");

struct Taps {
  float ky[SEPCONV_MAX_TAPS];
  float kx[SEPCONV_MAX_TAPS];
};

// The template argument of the instantiation whose taps come from device
// memory (any count).
constexpr int DEVICE_TAPS = -1;
constexpr int WIDE_THREADS = 256;  // threads of a wide pass's block

// One axis's taps in device memory, read through the read-only cache (the
// whole warp reads one tap at a time).
struct DeviceTaps {
  const float* p;
  __device__ float operator[](int i) const { return __ldg(p + i); }
};

// The taps of one axis an instantiation reads: the parameter bank's, or
// device memory's (from dev + at) for DEVICE_TAPS.
template <int N>
__device__ __forceinline__ decltype(auto) axis_taps(
    const float (&bank)[SEPCONV_MAX_TAPS], const float* dev, int at) {
  if constexpr (N == DEVICE_TAPS)
    return DeviceTaps{dev + at};
  else
    return (bank);
}

// Taps d .. d + R - 1 (those below n) of the stream: tap d + s is added
// to accumulator j from input d + s + j, which is cur[s + j] (inputs d ..
// d + R - 1) or nxt[s + j - R] (inputs d + R .. d + 2R - 1); both indices
// are compile-time. FIRST: the chunk of tap 0, which starts each
// accumulator.
template <bool FIRST, typename K>
__device__ __forceinline__ void tap_chunk(const K& k, int d, int n,
                                          const float (&cur)[R],
                                          const float (&nxt)[R],
                                          float (&acc)[R]) {
#pragma unroll
  for (int s = 0; s < R; ++s) {
    if (d + s < n) {
      const float t = k[d + s];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = t * (s + j < R ? cur[s + j] : nxt[s + j - R]);
        acc[j] = (FIRST && s == 0) ? p : acc[j] + p;
      }
    }
  }
}

// The chunk of taps d .. d + R - 1: the loads of the chunk after next
// issued first, then the taps, then the inputs handed on.
template <typename K, typename Load>
__device__ __forceinline__ void chunk_step(
    const K& k, int d, int n, const Load& load,
    float (&cur)[R], float (&nxt)[R], float (&acc)[R]) {
  const int inputs = R + n - 1;
  float pre[R];
#pragma unroll
  for (int q = 0; q < R; ++q)
    pre[q] = d + 2 * R + q < inputs ? load(d + 2 * R + q) : 0.f;
  if (d == 0)
    tap_chunk<true>(k, d, n, cur, nxt, acc);
  else
    tap_chunk<false>(k, d, n, cur, nxt, acc);
#pragma unroll
  for (int q = 0; q < R; ++q) {
    cur[q] = nxt[q];
    nxt[q] = pre[q];
  }
}

// acc[j] = sum_{d < n} k[d] * load(j + d), each sum in tap order. Each
// input load(q), q < R + n - 1, is read once, a chunk of R taps before it
// is used, so the loads of a chunk are in flight while the last one
// computes. N > 0 compiles the tap count in (n == N): the chunks unroll,
// their bounds checks fold away and the hand-on of the inputs becomes a
// renaming of registers. Otherwise n is taken at run time.
template <int N, typename K, typename Load>
__device__ __forceinline__ void sliding_taps(
    const K& k, int n_run, const Load& load, float (&acc)[R]) {
  const int n = N > 0 ? N : n_run;
  float cur[R], nxt[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    cur[q] = load(q);
    nxt[q] = R + q < R + n - 1 ? load(R + q) : 0.f;
  }
  if constexpr (N > 0) {
#pragma unroll
    for (int d = 0; d < N; d += R) chunk_step(k, d, N, load, cur, nxt, acc);
  } else {
#pragma unroll 1
    for (int d = 0; d < n; d += R) chunk_step(k, d, n, load, cur, nxt, acc);
  }
}

// NY, NX > 0: the tap counts compiled in (kernel_for's 15, 48 and 64, the
// same on both axes); 0: taken at run time; DEVICE_TAPS: the same, the
// taps in device memory (dev_taps: ky, then kx).
template <int NY, int NX>
__global__ void __launch_bounds__(THREADS, 2) sep_conv2d_valid_kernel(
    const float* __restrict__ in, float* __restrict__ out, int hp, int wp,
    int ho, int wo, int nky, int nkx, const float* __restrict__ dev_taps,
    const __grid_constant__ Taps taps) {
  if (NY > 0) nky = NY;
  if (NX > 0) nkx = NX;
  const auto& ky = axis_taps<NY>(taps.ky, dev_taps, 0);
  const auto& kx = axis_taps<NX>(taps.kx, dev_taps, nky);
  extern __shared__ float smem[];
  const int ncols = TW + nkx - 1;  // the first pass's columns
  const int pitch = ncols | 1;     // odd: lanes on rows hit distinct banks
  float* s_rows = smem;                // TH x pitch
  float* s_out = smem + TH * pitch;    // TH x OUT_PITCH
  const int row0 = blockIdx.y * TH;
  const int col0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  float acc[R];

  // First pass: item (c, g) is column c, rows g*R .. g*R + R - 1, taken in
  // the order g*ncols + c, tid + k*THREADS.
  int c = tid;
  int g = 0;
  while (c >= ncols) {
    c -= ncols;
    ++g;
  }
  while (g < GROUPS) {
    const int x = col0 + c;
    const int y = row0 + g * R;
    const float* col = in + x;
    const bool x_in = x < wp;
    // Rows past the padded image feed only outputs past the frame.
    sliding_taps<NY>(ky, nky, [&](int q) {
      return x_in && y + q < hp ? __ldg(col + (size_t)(y + q) * wp) : 0.f;
    }, acc);
#pragma unroll
    for (int j = 0; j < R; ++j) s_rows[(g * R + j) * pitch + c] = acc[j];
    c += THREADS;
    while (c >= ncols) {
      c -= ncols;
      ++g;
    }
  }
  __syncthreads();

  // Second pass: item i is row i % TH, columns (i / TH) * R .. + R - 1.
  for (int i = tid; i < TH * (TW / R); i += THREADS) {
    const int row = i & (TH - 1);
    const int c0 = (i >> LOG_TH) * R;
    const float* src = s_rows + row * pitch + c0;
    sliding_taps<NX>(kx, nkx, [&](int q) { return src[q]; }, acc);
#pragma unroll
    for (int j = 0; j < R; ++j) s_out[row * OUT_PITCH + c0 + j] = acc[j];
  }
  __syncthreads();

  for (int i = tid; i < TH * TW; i += THREADS) {
    const int row = i >> LOG_TW;
    const int col = i & (TW - 1);
    const int y = row0 + row;
    const int x = col0 + col;
    if (y < ho && x < wo)
      out[(size_t)y * wo + x] = s_out[row * OUT_PITCH + col];
  }
}

using SepFn = decltype(&sep_conv2d_valid_kernel<0, 0>);

SepFn kernel_for(int nky, int nkx) {
  if (nky > SEPCONV_MAX_TAPS || nkx > SEPCONV_MAX_TAPS)
    return sep_conv2d_valid_kernel<DEVICE_TAPS, DEVICE_TAPS>;
  if (nky == nkx) {
    switch (nky) {
      case 15: return sep_conv2d_valid_kernel<15, 15>;
      case 48: return sep_conv2d_valid_kernel<48, 48>;
      case 64: return sep_conv2d_valid_kernel<64, 64>;
    }
  }
  return sep_conv2d_valid_kernel<0, 0>;
}

size_t smem_bytes(int nkx) {
  return sizeof(float) * (size_t)TH *
         (size_t)(((TW + nkx - 1) | 1) + OUT_PITCH);
}

// One pass of the wide form: out[y][x] = sum_{d < n} k[d] * in[y * pitch +
// x + d * step], terms in tap order, at (blockIdx.x, x) of (ho, wo): down
// the columns with step = pitch, along the rows with step = 1.
__global__ void sep_wide_pass_kernel(const float* __restrict__ in,
                                     float* __restrict__ out, int pitch,
                                     int step, int wo,
                                     const float* __restrict__ k, int n) {
  const int y = blockIdx.x;
  const int x = blockIdx.y * blockDim.x + threadIdx.x;
  if (x >= wo) return;
  const float* p = in + (size_t)y * pitch + x;
  float acc = __ldg(k) * __ldg(p);
  for (int d = 1; d < n; ++d)
    acc = acc + __ldg(k + d) * __ldg(p + (size_t)d * step);
  out[(size_t)y * wo + x] = acc;
}

}  // namespace

// dev_taps: ky then kx on the card, needed above SEPCONV_MAX_TAPS.
extern "C" int sep_conv2d_valid_launch(const void* in, void* out, int hp,
                                       int wp, const float* ky, int nky,
                                       const float* kx, int nkx,
                                       const void* dev_taps, int tile_h,
                                       int tile_w, int threads,
                                       void* stream) {
  const bool bank = nky <= SEPCONV_MAX_TAPS && nkx <= SEPCONV_MAX_TAPS;
  if (nky < 1 || nkx < 1 || hp < nky || wp < nkx || (!bank && !dev_taps) ||
      tile_h != TH || tile_w != TW || threads != THREADS)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int d = 0; d < SEPCONV_MAX_TAPS; ++d) {
    taps.ky[d] = bank && d < nky ? ky[d] : 0.f;
    taps.kx[d] = bank && d < nkx ? kx[d] : 0.f;
  }
  const int ho = hp - nky + 1;
  const int wo = wp - nkx + 1;
  const size_t smem = smem_bytes(nkx);
  const SepFn kernel = kernel_for(nky, nkx);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((wo + TW - 1) / TW, (ho + TH - 1) / TH);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, hp, wp, ho, wo, nky, nkx,
      (const float*)dev_taps, taps);
  return (int)cudaGetLastError();
}

// The wide form: two launches, rows ((hp - nky + 1) x wp floats of
// scratch) between them; dev_taps: ky then kx on the card.
extern "C" int sep_conv2d_valid_wide_launch(const void* in, void* rows,
                                            void* out, int hp, int wp,
                                            const void* dev_taps, int nky,
                                            int nkx, void* stream) {
  if (nky < 1 || nkx < 1 || hp < nky || wp < nkx || !dev_taps)
    return (int)cudaErrorInvalidValue;
  const int ho = hp - nky + 1;
  const int wo = wp - nkx + 1;
  const float* k = (const float*)dev_taps;
  const cudaStream_t s = (cudaStream_t)stream;
  sep_wide_pass_kernel<<<dim3(ho, (wp + WIDE_THREADS - 1) / WIDE_THREADS),
                         WIDE_THREADS, 0, s>>>(
      (const float*)in, (float*)rows, wp, wp, wp, k, nky);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sep_wide_pass_kernel<<<dim3(ho, (wo + WIDE_THREADS - 1) / WIDE_THREADS),
                         WIDE_THREADS, 0, s>>>(
      (const float*)rows, (float*)out, wp, 1, wo, k + nky, nkx);
  return (int)cudaGetLastError();
}

// Blocks of the kernel one SM holds at once for nky, nkx taps, or
// -(CUDA error).
extern "C" int sep_conv2d_valid_blocks_per_sm(int nky, int nkx) {
  const size_t smem = smem_bytes(nkx);
  const SepFn kernel = kernel_for(nky, nkx);
  int blocks = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        THREADS, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" const char* sep_conv2d_valid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
