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
// What bounds it on the H100: 2 * (nky + nkx) flops per output pixel
// against 8 bytes of device memory (one read, one write), so at the
// Farneback box (48 taps) the direct tap loop is bound by shared-memory
// reads, not by device memory. One block stages its output tile plus the
// (taps - 1) halo in shared memory once, runs the row pass into a shared
// intermediate (the halo columns included) and the column pass out of
// it: both passes in one launch, and the row-pass intermediate never
// touches device memory. The TPU kernel's (8, 128)-aligned margins and its
// log2-doubling window sum for uniform taps are not carried over.
//
// Taps arrive by value in a parameter struct (already rounded to float32
// on the host). The build disables FMA contraction and the terms are
// summed in the plain version's order (tap 0 first), so the kernel
// rounds as PyTorch's eager ops do and matches sep_conv2d_valid_plain.

#include <cuda_runtime.h>

#define SEPCONV_MAX_TAPS 128

namespace {

struct Taps {
  float ky[SEPCONV_MAX_TAPS];
  float kx[SEPCONV_MAX_TAPS];
};

__global__ void sep_conv2d_valid_kernel(const float* __restrict__ in,
                                        float* __restrict__ out, int hp,
                                        int wp, int ho, int wo, int nky,
                                        int nkx, int tile_h, int tile_w,
                                        const Taps taps) {
  extern __shared__ float smem[];
  const int sh = tile_h + nky - 1;
  const int sw = tile_w + nkx - 1;
  float* s_in = smem;             // sh x sw input window
  float* s_rows = smem + sh * sw; // tile_h x sw row-pass intermediate
  const int row0 = blockIdx.y * tile_h;
  const int col0 = blockIdx.x * tile_w;

  for (int i = threadIdx.x; i < sh * sw; i += blockDim.x) {
    const int y = row0 + i / sw;
    const int x = col0 + i % sw;
    // Cells past the padded image feed only outputs past the frame.
    s_in[i] = (y < hp && x < wp) ? in[(size_t)y * wp + x] : 0.f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < tile_h * sw; i += blockDim.x) {
    const int r = i / sw;
    const int c = i % sw;
    const float* p = s_in + r * sw + c;
    float acc = taps.ky[0] * p[0];
    for (int d = 1; d < nky; ++d) acc = acc + taps.ky[d] * p[d * sw];
    s_rows[i] = acc;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < tile_h * tile_w; i += blockDim.x) {
    const int r = i / tile_w;
    const int c = i % tile_w;
    const int y = row0 + r;
    const int x = col0 + c;
    if (y >= ho || x >= wo) continue;
    const float* p = s_rows + r * sw + c;
    float acc = taps.kx[0] * p[0];
    for (int d = 1; d < nkx; ++d) acc = acc + taps.kx[d] * p[d];
    out[(size_t)y * wo + x] = acc;
  }
}

}  // namespace

extern "C" int sep_conv2d_valid_launch(const void* in, void* out, int hp,
                                       int wp, const float* ky, int nky,
                                       const float* kx, int nkx, int tile_h,
                                       int tile_w, int threads,
                                       void* stream) {
  if (nky < 1 || nkx < 1 || nky > SEPCONV_MAX_TAPS ||
      nkx > SEPCONV_MAX_TAPS || hp < nky || wp < nkx)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int d = 0; d < SEPCONV_MAX_TAPS; ++d) {
    taps.ky[d] = d < nky ? ky[d] : 0.f;
    taps.kx[d] = d < nkx ? kx[d] : 0.f;
  }
  const int ho = hp - nky + 1;
  const int wo = wp - nkx + 1;
  const size_t smem = sizeof(float) *
                      ((size_t)(tile_h + nky - 1) + (size_t)tile_h) *
                      (size_t)(tile_w + nkx - 1);
  cudaError_t err = cudaFuncSetAttribute(
      sep_conv2d_valid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((wo + tile_w - 1) / tile_w, (ho + tile_h - 1) / tile_h);
  sep_conv2d_valid_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, hp, wp, ho, wo, nky, nkx, tile_h,
      tile_w, taps);
  return (int)cudaGetLastError();
}

extern "C" const char* sep_conv2d_valid_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
