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
// the core does not include. Both kernels run the one block body of
// csrc/hs_block.cuh (hs_block), so they keep one arithmetic.
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
//
// A window of 65 or more (r >= 32) leaves no core in the 64x64 staged tile
// even for one sweep. Such a window takes the wide form, one sweep per
// hs_wide_launch, of both the whole-frame and the tile sweeps:
// hs_colsum_kernel writes every cell's column sums of u and v to device
// memory (zero beyond the frame, and beyond the tile), and
// hs_update_kernel adds W of them along the row from 0 and applies the
// update. It is the same order, so the same bits, at any window; it moves
// 16 bytes per cell and sweep more than the staged form and reads W
// column sums per cell from L1/L2, which is the price of a window no
// staged tile holds. Windows below 65 never take it.

#include <cuda_runtime.h>

#include "hs_block.cuh"

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
  hs_block<SH, CX, CY, KR, false>(u_in, v_in, gx, gy, gt, inv, u_out, v_out,
                                  h, w, y0, x0, y0, x0, h, w, h, w, y0, x0,
                                  window, fuse, inv_area, 0.f);
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
  hs_block<SH, CX, CY, KR, false>(
      u_in, v_in, gx, gy, gt, inv, u_out, v_out, hh, hw, ay0, ax0,
      row0 + ay0, col0 + ax0, img_h, img_w, hh - 2 * need, hw - 2 * need,
      ay0 - need, ax0 - need, window, fuse, inv_area, 0.f);
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

// The wide form (see the header note): a 2-D grid of 32x8 blocks over the
// column sums, then over the output.
constexpr int WIDE_BX = 32;
constexpr int WIDE_BY = 8;

__global__ void __launch_bounds__(WIDE_BX * WIDE_BY) hs_colsum_kernel(
    const HsWide p, const float* __restrict__ u, const float* __restrict__ v,
    float* __restrict__ cs_u, float* __restrict__ cs_v) {
  const int x = blockIdx.x * WIDE_BX + threadIdx.x;
  const int y = blockIdx.y * WIDE_BY + threadIdx.y;
  if (x < p.in_w && y < p.in_h - 2 * p.off)
    hs_colsum_cell(p, u, v, cs_u, cs_v, y, x);
}

__global__ void __launch_bounds__(WIDE_BX * WIDE_BY) hs_update_kernel(
    const HsWide p, const float* __restrict__ cs_u,
    const float* __restrict__ cs_v, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ gt,
    const float* __restrict__ inv, float* __restrict__ u_out,
    float* __restrict__ v_out, float inv_area) {
  const int x = blockIdx.x * WIDE_BX + threadIdx.x;
  const int y = blockIdx.y * WIDE_BY + threadIdx.y;
  if (x < p.in_w - 2 * p.off && y < p.in_h - 2 * p.off)
    hs_update_cell<false>(p, cs_u, cs_v, gx, gy, gt, inv, u_out, v_out, y, x,
                          inv_area, 0.f);
}

dim3 wide_grid(int h, int w) {
  return dim3((w + WIDE_BX - 1) / WIDE_BX, (h + WIDE_BY - 1) / WIDE_BY);
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

// One sweep of the wide form: the two kernels above, on an (in_h, in_w)
// input whose (0, 0) is frame cell (fy0, fx0), into an (in_h - 2*off,
// in_w - 2*off) output; cs_u and cs_v are (in_h - 2*off, in_w) scratch.
// The fixed fields are read at (g0 + y, g0 + x) of pitch g_w.
extern "C" int hs_wide_launch(
    const void* u, const void* v, const void* gx, const void* gy,
    const void* gt, const void* inv, void* u_out, void* v_out, void* cs_u,
    void* cs_v, int in_h, int in_w, int off, int g_w, int g0, int fy0,
    int fx0, int img_h, int img_w, int window, float inv_area,
    void* stream) {
  const HsWide p{in_h, in_w, off, g_w, g0, fy0, fx0, img_h, img_w,
                 window / 2};
  const int out_h = in_h - 2 * off;
  const int out_w = in_w - 2 * off;
  if (out_h < 1 || out_w < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(WIDE_BX, WIDE_BY);
  hs_colsum_kernel<<<wide_grid(out_h, in_w), block, 0,
                     (cudaStream_t)stream>>>(
      p, (const float*)u, (const float*)v, (float*)cs_u, (float*)cs_v);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hs_update_kernel<<<wide_grid(out_h, out_w), block, 0,
                     (cudaStream_t)stream>>>(
      p, (const float*)cs_u, (const float*)cs_v, (const float*)gx,
      (const float*)gy, (const float*)gt, (const float*)inv, (float*)u_out,
      (float*)v_out, inv_area);
  return (int)cudaGetLastError();
}

extern "C" const char* hs_sweeps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
