// Farneback polynomial expansion and box aggregation + solve for Hopper
// (sm_90a).
//
// fb_poly_expansion replaces tpuflow/kernels/fb_kernels.py::
// fb_poly_expansion_pallas (the TPU kernel _fb_poly_kernel). On a
// CLAMP-padded (hp, wp) image and 2n+1 applicability taps g, gx = g*x,
// gxx = g*x^2 it computes three row passes
//
//     rg = rows(g), rgx = rows(gx), rgxx = rows(gxx)
//
// feeding six column passes, the moments in basis order [1, x, y, x^2,
// y^2, xy]:
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
// What bounds them on the H100: both are direct tap loops over a shared
// tile, bound by shared-memory reads (poly: 3*(2n+1) row and 6*(2n+1)
// column multiply-adds per pixel for 4 bytes in and 20 out; blur-solve:
// 2*winsize adds per pixel and channel for 20 bytes in and 8 out). One
// launch replaces six separable passes (poly) or five box passes plus the
// solve (blur-solve): the row-pass intermediates and the blurred channels
// stay in shared memory and never touch device memory. Blur-solve holds
// one channel's window at a time, so a 64-wide window fits a block
// (about 105 KB). The TPU kernels' 8-tap block sums and aligned margins
// are not carried over.
//
// The build disables FMA contraction and every sum runs in the plain
// versions' order, so the kernels round as PyTorch's eager ops do.

#include <cuda_runtime.h>

#define FB_MAX_TAPS 64

namespace {

struct PolyTaps {
  float g[FB_MAX_TAPS];
  float gx[FB_MAX_TAPS];
  float gxx[FB_MAX_TAPS];
  float ginv[5][6];
};

__global__ void fb_poly_expansion_kernel(
    const float* __restrict__ in, float* __restrict__ b1,
    float* __restrict__ b2, float* __restrict__ a11, float* __restrict__ a22,
    float* __restrict__ a12, int hp, int wp, int ho, int wo, int taps_n,
    int tile_h, int tile_w, const PolyTaps k) {
  extern __shared__ float smem[];
  const int sh = tile_h + taps_n - 1;
  const int sw = tile_w + taps_n - 1;
  float* s_in = smem;                   // sh x sw input window
  float* s_rg = s_in + sh * sw;         // tile_h x sw row passes
  float* s_rgx = s_rg + tile_h * sw;
  float* s_rgxx = s_rgx + tile_h * sw;
  const int row0 = blockIdx.y * tile_h;
  const int col0 = blockIdx.x * tile_w;

  for (int i = threadIdx.x; i < sh * sw; i += blockDim.x) {
    const int y = row0 + i / sw;
    const int x = col0 + i % sw;
    s_in[i] = (y < hp && x < wp) ? in[(size_t)y * wp + x] : 0.f;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < tile_h * sw; i += blockDim.x) {
    const int r = i / sw;
    const int c = i % sw;
    const float* p = s_in + r * sw + c;
    float rg = k.g[0] * p[0];
    float rgx = k.gx[0] * p[0];
    float rgxx = k.gxx[0] * p[0];
    for (int d = 1; d < taps_n; ++d) {
      const float a = p[d * sw];
      rg = rg + k.g[d] * a;
      rgx = rgx + k.gx[d] * a;
      rgxx = rgxx + k.gxx[d] * a;
    }
    s_rg[i] = rg;
    s_rgx[i] = rgx;
    s_rgxx[i] = rgxx;
  }
  __syncthreads();

  float* outs[5] = {b1, b2, a11, a22, a12};
  for (int i = threadIdx.x; i < tile_h * tile_w; i += blockDim.x) {
    const int r = i / tile_w;
    const int c = i % tile_w;
    const int y = row0 + r;
    const int x = col0 + c;
    if (y >= ho || x >= wo) continue;
    const int o = r * sw + c;
    float m[6];
    m[0] = k.g[0] * s_rg[o];     // m00
    m[1] = k.gx[0] * s_rg[o];    // m10
    m[2] = k.g[0] * s_rgx[o];    // m01
    m[3] = k.gxx[0] * s_rg[o];   // m20
    m[4] = k.g[0] * s_rgxx[o];   // m02
    m[5] = k.gx[0] * s_rgx[o];   // m11
    for (int d = 1; d < taps_n; ++d) {
      const float rg = s_rg[o + d];
      const float rgx = s_rgx[o + d];
      const float rgxx = s_rgxx[o + d];
      m[0] = m[0] + k.g[d] * rg;
      m[1] = m[1] + k.gx[d] * rg;
      m[2] = m[2] + k.g[d] * rgx;
      m[3] = m[3] + k.gxx[d] * rg;
      m[4] = m[4] + k.g[d] * rgxx;
      m[5] = m[5] + k.gx[d] * rgx;
    }
    const size_t g = (size_t)y * wo + x;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      float acc = 0.f;
      bool first = true;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const float coef = k.ginv[j][q];
        if (coef == 0.f) continue;
        const float t = coef * m[q];
        acc = first ? t : acc + t;
        first = false;
      }
      outs[j][g] = acc;
    }
  }
}

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
  if (taps_n < 1 || taps_n > FB_MAX_TAPS || hp < taps_n || wp < taps_n)
    return (int)cudaErrorInvalidValue;
  PolyTaps k;
  for (int d = 0; d < FB_MAX_TAPS; ++d) {
    k.g[d] = d < taps_n ? g[d] : 0.f;
    k.gx[d] = d < taps_n ? gx[d] : 0.f;
    k.gxx[d] = d < taps_n ? gxx[d] : 0.f;
  }
  for (int j = 0; j < 5; ++j)
    for (int q = 0; q < 6; ++q) k.ginv[j][q] = ginv[j * 6 + q];
  const int ho = hp - taps_n + 1;
  const int wo = wp - taps_n + 1;
  const size_t smem = sizeof(float) *
                      ((size_t)(tile_h + taps_n - 1) + 3 * (size_t)tile_h) *
                      (size_t)(tile_w + taps_n - 1);
  cudaError_t err = cudaFuncSetAttribute(
      fb_poly_expansion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((wo + tile_w - 1) / tile_w, (ho + tile_h - 1) / tile_h);
  fb_poly_expansion_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)in, (float*)b1, (float*)b2, (float*)a11, (float*)a22,
      (float*)a12, hp, wp, ho, wo, taps_n, tile_h, tile_w, k);
  return (int)cudaGetLastError();
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
