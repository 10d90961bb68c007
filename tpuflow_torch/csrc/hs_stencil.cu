// Fused Horn-Schunck Jacobi sweeps for Hopper (sm_90a).
//
// hs_sweeps_kernel replaces tpuflow/kernels/hs_stencil.py::
// horn_schunck_pallas (the TPU kernel _hs_kernel with its sweep body
// _hs_sweeps). Each sweep computes
//
//     ub  = box_W(u) / W^2,  vb = box_W(v) / W^2   (zeros beyond the frame)
//     upd = (gx*ub + gy*vb + gt) * inv_denom
//     u   = ub - gx*upd,     v = vb - gy*upd
//
// hs_tile_kernel replaces tpuflow/kernels/hs_stencil.py::hs_tile_sweeps,
// the tile body of the sharded solver (tpuflow/dist/solvers.py): the same
// sweeps on one already halo'd tile of its own pitch, whose (0, 0) sits at
// frame coordinates (row0, col0) of an (img_h, img_w) frame; it writes only
// the core. Cells past the tile's end read as zero; after `fuse` sweeps
// their influence reaches need = fuse*r cells inward, which is the halo
// the core does not include. Both kernels run the one block body below,
// so they keep one arithmetic.
//
// What bounds it on the H100: one sweep per launch would move 32 bytes per
// pixel for ~60 flops, so the sweeps are fused: a block stages an SH x SW
// tile (its core plus a fuse*r halo) once, runs `fuse` sweeps on it with a
// valid region that shrinks by r per sweep, and writes back only its core.
// What is left is on-chip: the box sums' shared-memory reads, the
// arithmetic, the barriers, and the halo's redundant work.
//
// The design answers each. The box sum is separable and taken in the
// plain version's order: per sweep, one pass writes each cell's W-high
// column sum (top to bottom) to shared memory, and the update pass adds W
// adjacent column sums left to right, starting from 0. That is exactly
// the order of summing each output's columns in place, so it is bitwise
// the same, and it takes ~2W shared reads per cell and field instead of
// W^2. Thread (tx, ty) of a (32, SH/CY) block owns the cells of rows
// ty*CY .. ty*CY+CY-1 at columns tx + 32*i, i < CX, for the whole launch:
// gx, gy, gt and inv_denom sit in its registers, and shared memory holds
// only u, v and their column sums, 4 words per cell. u and v update in
// place, since the update pass reads only the column sums. A 64x64 tile
// keeps two blocks on each SM, so one block's barriers overlap the
// other's work. Cells outside the frame are held at 0 after every sweep,
// which is the BORDER_CONSTANT box of the reference. The build disables
// FMA contraction, so the kernel rounds as the plain PyTorch version does.

#include <cuda_runtime.h>

namespace {

// The staged tile: SH rows of SW = 32*CX columns, CY rows per thread;
// two blocks per SM (64 KB of shared memory and 64 registers a thread).
constexpr int SH = 64;
constexpr int CX = 2;
constexpr int CY = 4;
constexpr int SW = 32 * CX;
constexpr int THREADS = 32 * (SH / CY);
constexpr int BLOCKS_PER_SM = 2;
constexpr size_t SMEM = 4 * sizeof(float) * SH * SW;

// `fuse` sweeps of one staged tile, then its core written back. Staged
// cell (y, x) is input cell (iy0 + y, ix0 + x) of an (in_h, in_w) array
// (zero beyond it), frame cell (fy0 + y, fx0 + x), and output cell
// (oy0 + y, ox0 + x) of an (out_h, out_w) array. KR is the box radius, or
// 0 to take it from `window`.
template <int KR>
__device__ __forceinline__ void hs_block(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ gt, const float* __restrict__ inv,
    float* __restrict__ u_out, float* __restrict__ v_out, int in_h,
    int in_w, int iy0, int ix0, int fy0, int fx0, int img_h, int img_w,
    int out_h, int out_w, int oy0, int ox0, int window, int fuse,
    float inv_area) {
  extern __shared__ float smem[];
  constexpr int N = SH * SW;
  float* s_u = smem;
  float* s_v = s_u + N;
  float* s_cu = s_v + N;  // column sums of u and v
  float* s_cv = s_cu + N;
  const int r = KR > 0 ? KR : window / 2;
  const int win = 2 * r + 1;
  const int tx = threadIdx.x;
  const int y0 = threadIdx.y * CY;

  float f_gx[CY][CX], f_gy[CY][CX], f_gt[CY][CX], f_inv[CY][CX];
  unsigned inside = 0;  // bit j*CX + i: the cell is in the frame
#pragma unroll
  for (int j = 0; j < CY; ++j) {
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int y = y0 + j;
      const int x = tx + 32 * i;
      const int iy = iy0 + y;
      const int ix = ix0 + x;
      const bool in_frame = fy0 + y >= 0 && fy0 + y < img_h &&
                            fx0 + x >= 0 && fx0 + x < img_w;
      float u = 0.f, v = 0.f, a = 0.f, b = 0.f, c = 0.f, d = 0.f;
      if (iy >= 0 && iy < in_h && ix >= 0 && ix < in_w) {
        const size_t g = (size_t)iy * in_w + ix;
        if (in_frame) {
          u = u_in[g];
          v = v_in[g];
        }
        a = gx[g];
        b = gy[g];
        c = gt[g];
        d = inv[g];
      }
      if (in_frame) inside |= 1u << (j * CX + i);
      s_u[y * SW + x] = u;
      s_v[y * SW + x] = v;
      f_gx[j][i] = a;
      f_gy[j][i] = b;
      f_gt[j][i] = c;
      f_inv[j][i] = d;
    }
  }
  __syncthreads();

  for (int t = 1; t <= fuse; ++t) {
    // Sweep t is valid on [t*r, size - t*r): it reads the r-ring that
    // sweep t-1 left valid. Column sums first, on the columns the update
    // reads.
    const int lo = t * r;
#pragma unroll
    for (int j = 0; j < CY; ++j) {
      const int y = y0 + j;
      if (y < lo || y >= SH - lo) continue;
#pragma unroll
      for (int i = 0; i < CX; ++i) {
        const int x = tx + 32 * i;
        if (x < lo - r || x >= SW - lo + r) continue;
        const float* pu = s_u + (y - r) * SW + x;
        const float* pv = s_v + (y - r) * SW + x;
        float cu = pu[0];
        float cv = pv[0];
#pragma unroll
        for (int dy = 1; dy < win; ++dy) {
          cu += pu[dy * SW];
          cv += pv[dy * SW];
        }
        s_cu[y * SW + x] = cu;
        s_cv[y * SW + x] = cv;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < CY; ++j) {
      const int y = y0 + j;
      if (y < lo || y >= SH - lo) continue;
#pragma unroll
      for (int i = 0; i < CX; ++i) {
        const int x = tx + 32 * i;
        if (x < lo || x >= SW - lo) continue;
        const float* pu = s_cu + y * SW + x - r;
        const float* pv = s_cv + y * SW + x - r;
        float su = 0.f;
        float sv = 0.f;
#pragma unroll
        for (int dx = 0; dx < win; ++dx) {
          su += pu[dx];
          sv += pv[dx];
        }
        float u_new = 0.f;
        float v_new = 0.f;
        if (inside & (1u << (j * CX + i))) {
          const float ub = su * inv_area;
          const float vb = sv * inv_area;
          const float upd =
              (f_gx[j][i] * ub + f_gy[j][i] * vb + f_gt[j][i]) * f_inv[j][i];
          u_new = ub - f_gx[j][i] * upd;
          v_new = vb - f_gy[j][i] * upd;
        }
        s_u[y * SW + x] = u_new;
        s_v[y * SW + x] = v_new;
      }
    }
    if (t < fuse) __syncthreads();
  }

  // Each thread writes back the core cells it owns (it wrote them last).
  const int need = fuse * r;
#pragma unroll
  for (int j = 0; j < CY; ++j) {
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int y = y0 + j;
      const int x = tx + 32 * i;
      const int oy = oy0 + y;
      const int ox = ox0 + x;
      if (y < need || y >= SH - need || x < need || x >= SW - need ||
          oy >= out_h || ox >= out_w)
        continue;
      u_out[(size_t)oy * out_w + ox] = s_u[y * SW + x];
      v_out[(size_t)oy * out_w + ox] = s_v[y * SW + x];
    }
  }
}

template <int KR>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) hs_sweeps_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ gt, const float* __restrict__ inv,
    float* __restrict__ u_out, float* __restrict__ v_out, int h, int w,
    int window, int fuse, float inv_area) {
  const int need = fuse * (KR > 0 ? KR : window / 2);
  const int y0 = blockIdx.y * (SH - 2 * need) - need;
  const int x0 = blockIdx.x * (SW - 2 * need) - need;
  hs_block<KR>(u_in, v_in, gx, gy, gt, inv, u_out, v_out, h, w, y0, x0, y0,
               x0, h, w, h, w, y0, x0, window, fuse, inv_area);
}

// One halo'd (hh x hw) tile in, its (hh - 2*need) x (hw - 2*need) core
// out; the tile's (0, 0) sits at frame coordinates (row0, col0).
template <int KR>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) hs_tile_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ gt, const float* __restrict__ inv,
    float* __restrict__ u_out, float* __restrict__ v_out, int hh, int hw,
    int row0, int col0, int img_h, int img_w, int window, int fuse,
    float inv_area) {
  const int need = fuse * (KR > 0 ? KR : window / 2);
  const int ay0 = blockIdx.y * (SH - 2 * need);
  const int ax0 = blockIdx.x * (SW - 2 * need);
  hs_block<KR>(u_in, v_in, gx, gy, gt, inv, u_out, v_out, hh, hw, ay0, ax0,
               row0 + ay0, col0 + ax0, img_h, img_w, hh - 2 * need,
               hw - 2 * need, ay0 - need, ax0 - need, window, fuse,
               inv_area);
}

// The kernel for a window: the main paths' 5x5 box with its radius
// compiled in, any other odd window with it taken at run time.
using SweepsFn = decltype(&hs_sweeps_kernel<0>);
using TileFn = decltype(&hs_tile_kernel<0>);

SweepsFn sweeps_for(int window) {
  return window == 5 ? hs_sweeps_kernel<2> : hs_sweeps_kernel<0>;
}

TileFn tile_for(int window) {
  return window == 5 ? hs_tile_kernel<2> : hs_tile_kernel<0>;
}

template <typename F>
cudaError_t allow_smem(F kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
}

dim3 grid_for(int out_h, int out_w, int need) {
  return dim3((out_w + SW - 2 * need - 1) / (SW - 2 * need),
              (out_h + SH - 2 * need - 1) / (SH - 2 * need));
}

}  // namespace

extern "C" int hs_sweeps_launch(
    const void* u, const void* v, const void* gx, const void* gy,
    const void* gt, const void* inv, void* u_out, void* v_out, int h, int w,
    int window, int fuse, float inv_area, void* stream) {
  const SweepsFn kernel = sweeps_for(window);
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_for(h, w, fuse * (window / 2)), dim3(32, SH / CY), SMEM,
           (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)gx, (const float*)gy,
      (const float*)gt, (const float*)inv, (float*)u_out, (float*)v_out, h,
      w, window, fuse, inv_area);
  return (int)cudaGetLastError();
}

extern "C" int hs_tile_launch(
    const void* u, const void* v, const void* gx, const void* gy,
    const void* gt, const void* inv, void* u_out, void* v_out, int hh,
    int hw, int row0, int col0, int img_h, int img_w, int window, int fuse,
    float inv_area, void* stream) {
  const TileFn kernel = tile_for(window);
  cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return (int)err;
  const int need = fuse * (window / 2);
  kernel<<<grid_for(hh - 2 * need, hw - 2 * need, need), dim3(32, SH / CY),
           SMEM, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)gx, (const float*)gy,
      (const float*)gt, (const float*)inv, (float*)u_out, (float*)v_out, hh,
      hw, row0, col0, img_h, img_w, window, fuse, inv_area);
  return (int)cudaGetLastError();
}

template <typename F>
int blocks_per_sm(F kernel) {
  int blocks = 0;
  cudaError_t err = allow_smem(kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        THREADS, SMEM);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Blocks one SM holds at once of the sweeps (tile = 0) or the tile kernel
// (tile = 1) for a window, or -(CUDA error).
extern "C" int hs_blocks_per_sm(int tile, int window) {
  return tile ? blocks_per_sm(tile_for(window))
              : blocks_per_sm(sweeps_for(window));
}

extern "C" const char* hs_sweeps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
