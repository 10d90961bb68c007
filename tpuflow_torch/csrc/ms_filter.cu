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
// What bounds it on the H100: the work, not the bytes. Only the offsets
// within R of the query's drift can pass the spatial test, about pi R^2 of
// them (1,257 lattice points at R = 20), each ~13 flops and three loads:
// at KITTI size ~4.7e9 tests over 8 iterations, while the frame is read
// once and the outputs written once (~9 MB). Each thread therefore sweeps
// only the (2 reach + 1)^2 box around its drift (reach = ceil(R)), clipped
// to the square: an offset outside it is more than R from the drift and
// fails the spatial test in float32 too, so skipping it is bitwise the
// same. Queries never read each other's state, only the original frame,
// so the whole iteration loop runs in one launch: a block stages its
// 32x32 query tile plus an E-pixel halo of the three Lab planes in shared
// memory once (3 x 112^2 x 4 B = 147 KB at E = 40), one thread per query
// keeps its drift, colour and six sums in registers, and neighbouring
// threads read neighbouring shared words. The build disables FMA
// contraction and the sums follow the plain version's order, so the
// result is bitwise its plain version.

#include <cuda_runtime.h>

namespace {

__global__ void ms_filter_kernel(const float* __restrict__ lab,
                                 const float* __restrict__ sentinel,
                                 float* __restrict__ pos,
                                 float* __restrict__ col, int h, int w,
                                 int E, int reach, int iters, int tile,
                                 float hs2, float hr2) {
  extern __shared__ float smem[];
  const int sw = tile + 2 * E;
  const int n = sw * sw;
  float* p0 = smem;
  float* p1 = p0 + n;
  float* p2 = p1 + n;
  const float sent = *sentinel;
  // Frame coordinates of the shared tile's (0, 0).
  const int row0 = blockIdx.y * tile - E;
  const int col0 = blockIdx.x * tile - E;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = row0 + i / sw;
    const int x = col0 + i % sw;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const size_t g = 3 * ((size_t)y * w + x);
      p0[i] = lab[g];
      p1[i] = lab[g + 1];
      p2[i] = lab[g + 2];
    } else {
      p0[i] = sent;
      p1[i] = sent;
      p2[i] = sent;
    }
  }
  __syncthreads();

  const int ly = threadIdx.x / tile;
  const int lx = threadIdx.x % tile;
  const int y = blockIdx.y * tile + ly;
  const int x = blockIdx.x * tile + lx;
  if (y >= h || x >= w) return;
  const int center = (ly + E) * sw + (lx + E);
  float c0 = p0[center];
  float c1 = p1[center];
  float c2 = p2[center];
  float ex = 0.f;
  float ey = 0.f;
  for (int it = 0; it < iters; ++it) {
    float s_dx = 0.f, s_dy = 0.f, s_n = 0.f;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    // An offset with |dx - ex| >= reach + 1 > R has d_sp >= (reach + 1)^2
    // after float32 rounding (monotone, and (reach + 1)^2 is exact), which
    // exceeds hs2: the plain version adds +-0 there.
    const int x_lo = max(-E, (int)floorf(ex) - reach);
    const int x_hi = min(E, (int)ceilf(ex) + reach);
    const int y_lo = max(-E, (int)floorf(ey) - reach);
    const int y_hi = min(E, (int)ceilf(ey) + reach);
    for (int dy = y_lo; dy <= y_hi; ++dy) {
      const float fdy = (float)dy;
      const float ty = fdy - ey;
      const float ty2 = ty * ty;
      const int row = center + dy * sw;
      for (int dx = x_lo; dx <= x_hi; ++dx) {
        const float fdx = (float)dx;
        const float tx = fdx - ex;
        const float d_sp = tx * tx + ty2;
        const float q0 = p0[row + dx];
        const float q1 = p1[row + dx];
        const float q2 = p2[row + dx];
        const float a = q0 - c0;
        const float b = q1 - c1;
        const float c = q2 - c2;
        const float d_cl = a * a + b * b + c * c;
        // A failed test adds +-0 in the plain version, which leaves every
        // sum unchanged: skipping it is bitwise the same.
        if (d_sp <= hs2 && d_cl <= hr2) {
          s_dx = s_dx + fdx;
          s_dy = s_dy + fdy;
          s_n = s_n + 1.f;
          s0 = s0 + q0;
          s1 = s1 + q1;
          s2 = s2 + q2;
        }
      }
    }
    const float nn = fmaxf(s_n, 1.f);
    if (s_n > 0.f) {
      ex = s_dx / nn;
      ey = s_dy / nn;
    } else {
      ex = -(float)x;
      ey = -(float)y;
    }
    c0 = s0 / nn;
    c1 = s1 / nn;
    c2 = s2 / nn;
  }
  const size_t g = (size_t)y * w + x;
  pos[2 * g] = (float)x + ex;
  pos[2 * g + 1] = (float)y + ey;
  col[3 * g] = c0;
  col[3 * g + 1] = c1;
  col[3 * g + 2] = c2;
}

}  // namespace

extern "C" int ms_filter_launch(const void* lab, const void* sentinel,
                                void* pos, void* col, int h, int w, int E,
                                int reach, int iters, int tile, float hs2,
                                float hr2, void* stream) {
  const size_t smem =
      3 * sizeof(float) * (size_t)(tile + 2 * E) * (size_t)(tile + 2 * E);
  cudaError_t err = cudaFuncSetAttribute(
      ms_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + tile - 1) / tile, (h + tile - 1) / tile);
  ms_filter_kernel<<<grid, tile * tile, smem, (cudaStream_t)stream>>>(
      (const float*)lab, (const float*)sentinel, (float*)pos, (float*)col, h,
      w, E, reach, iters, tile, hs2, hr2);
  return (int)cudaGetLastError();
}

extern "C" const char* ms_filter_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
