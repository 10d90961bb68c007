// The whole Horn-Schunck solve in one launch, for Hopper (sm_90a).
//
// Replaces tpuflow/kernels/hs_stencil.py::horn_schunck_pallas_resident
// (_hs_resident_kernel) and horn_schunck_pallas_resident2
// (_hs_resident2_kernel). Given the gradients gx, gy, gt of an (h, w)
// frame, it zeroes u and v and runs `iterations` Jacobi sweeps
//
//     ub  = box_W(u) / W^2,  vb = box_W(v) / W^2   (zeros beyond the frame)
//     upd = (gx*ub + gy*vb + gt) / (alpha^2 + gx^2 + gy^2)     [resident]
//     upd = (gx*ub + gy*vb + gt) * inv,                         [resident2]
//           inv = 1 / (alpha^2 + gx^2 + gy^2) computed once into scratch
//     u   = ub - gx*upd,     v = vb - gy*upd
//
// On the TPU "resident" meant every field held in VMEM for the whole run.
// The H100 has no such room: a 1080p field is 8.3 MB, the 7-8 fields of
// the solve 58-66 MB, more than the 50 MB L2 and far more than one
// block's 227 KB of shared memory. Here it means one persistent
// cooperative launch (cudaLaunchCooperativeKernel) with no host round trip
// between sweeps: the grid is no larger than the blocks the occupancy API
// says can be co-resident on the card, u and v are double-buffered in
// device memory, and cooperative_groups' grid sync separates the groups of
// sweeps.
//
// What bounds it: a sweep that went through device memory would move
// 28-32 bytes per pixel for ~30 float operations, and a grid sync per
// sweep costs about what a launch does. So the sweeps are fused between
// grid syncs, as hs_sweeps fuses them between launches: every block walks
// its share of the frame's tiles, stages each with a fuse*r halo, runs
// `fuse` sweeps on it and writes back its core, and the grid syncs once
// per `fuse` sweeps (fuse is chosen at launch; the last group runs the
// remainder). The sweeps are csrc/hs_block.cuh's hs_block, the body of
// csrc/hs_stencil.cu: each box sum as column sums, then W of them along
// the row (~2W shared reads per cell and field, not W^2), the fixed fields
// in registers, u and v updated in place, no integer division per cell,
// 64x64 staged tiles of 512 threads, two blocks per SM. The resident form
// divides by the denominator, which it forms once per staged cell in
// registers; resident2 multiplies by the reciprocal from scratch. A tile
// is reloaded once per group: 777 tiles at 1080x1920 against 264 blocks
// leave no room to keep a block's tiles' fixed fields in registers.
//
// A window of 65 or more leaves no core in the staged tile (fuse 0). Its
// one launch runs the wide form of csrc/hs_block.cuh (an instantiation of
// its own), one sweep per two grid syncs: every block writes the column
// sums of its rows of the frame to scratch, the grid syncs, every block
// applies the update to its rows, the grid syncs. There is no window
// ceiling.
//
// The box sum is taken in the plain version's order and the build disables
// FMA contraction, so the kernel rounds as the plain PyTorch version does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hs_block.cuh"

namespace cg = cooperative_groups;

namespace {

// The staged tile of csrc/hs_stencil.cu: SH rows of SW = 32*CX columns,
// CY rows per thread, two blocks per SM.
constexpr int SH = 64;
constexpr int CX = 2;
constexpr int CY = 4;
constexpr int SW = 32 * CX;
constexpr int THREADS = 32 * (SH / CY);
constexpr int BLOCKS_PER_SM = 2;
constexpr size_t SMEM = 4 * sizeof(float) * SH * SW;

// WIDE: the wide form (fuse 0), compiled apart so that the staged form's
// registers hold only what its sweeps need.
template <int KR, bool DIVIDE, bool WIDE>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) hs_resident_kernel(
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ gt, float* __restrict__ inv, float* u0,
    float* v0, float* u1, float* v1, float* cs_u, float* cs_v, int h, int w,
    int window, int iterations, int fuse, float alpha2, float inv_area) {
  cg::grid_group grid = cg::this_grid();
  const int r = KR > 0 ? KR : window / 2;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;

  // u0 = v0 = 0 and (resident2) the reciprocal, each block on its rows.
  for (int y = blockIdx.x; y < h; y += gridDim.x) {
    for (int x = tid; x < w; x += THREADS) {
      const size_t i = (size_t)y * w + x;
      u0[i] = 0.f;
      v0[i] = 0.f;
      if (!DIVIDE) {
        const float a = gx[i];
        const float b = gy[i];
        inv[i] = 1.0f / (alpha2 + a * a + b * b);
      }
    }
  }
  grid.sync();

  if (WIDE) {
    // Group g reads buffer g % 2 and writes the other.
    const HsWide p{h, w, 0, w, 0, 0, 0, h, w, r};
    for (int g = 0; g < iterations; ++g) {
      const bool odd = g & 1;
      for (int y = blockIdx.x; y < h; y += gridDim.x)
        for (int x = tid; x < w; x += THREADS)
          hs_colsum_cell(p, odd ? u1 : u0, odd ? v1 : v0, cs_u, cs_v, y, x);
      grid.sync();
      for (int y = blockIdx.x; y < h; y += gridDim.x)
        for (int x = tid; x < w; x += THREADS)
          hs_update_cell<DIVIDE>(p, cs_u, cs_v, gx, gy, gt, inv,
                                 odd ? u0 : u1, odd ? v0 : v1, y, x,
                                 inv_area, alpha2);
      grid.sync();
    }
    return;
  }

  // Group g runs k sweeps on every tile of buffer g % 2 into the other;
  // only g, done and the tile index live across the sweeps.
  int done = 0;
  for (int g = 0; done < iterations; ++g) {
    const int k = min(fuse, iterations - done);
    const int need = k * r;
    const int core_h = SH - 2 * need;
    const int core_w = SW - 2 * need;
    const int tiles_x = (w + core_w - 1) / core_w;
    const int tiles = tiles_x * ((h + core_h - 1) / core_h);
    const bool odd = g & 1;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int ty = t / tiles_x;  // once per tile, not per cell
      const int y0 = ty * core_h - need;
      const int x0 = (t - ty * tiles_x) * core_w - need;
      __syncthreads();  // the last tile's shared reads are done
      hs_block<SH, CX, CY, KR, DIVIDE>(
          odd ? u1 : u0, odd ? v1 : v0, gx, gy, gt, inv, odd ? u0 : u1,
          odd ? v0 : v1, h, w, y0, x0, y0, x0, h, w, h, w, y0, x0, window, k,
          inv_area, alpha2);
    }
    grid.sync();
    done += k;
  }
}

using ResidentFn = decltype(&hs_resident_kernel<0, false, false>);

// The kernel for a window, form and plan: the main paths' 5x5 box with its
// radius compiled in, any other odd window with it taken at run time, the
// wide form where the plan fuses no sweep.
ResidentFn resident_for(int window, int recip, int fuse) {
  if (fuse == 0)
    return recip ? hs_resident_kernel<0, false, true>
                 : hs_resident_kernel<0, true, true>;
  if (window == 5)
    return recip ? hs_resident_kernel<2, false, false>
                 : hs_resident_kernel<2, true, false>;
  return recip ? hs_resident_kernel<0, false, false>
               : hs_resident_kernel<0, true, false>;
}

// Blocks of the kernel one SM holds at once, and the card's SM count.
cudaError_t occupancy(ResidentFn kernel, int* per_sm, int* sms) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       THREADS, SMEM);
}

}  // namespace

// Launches the solve, `fuse` sweeps per grid sync (0: the wide form, one
// sweep per two syncs; cs_u and cs_v are then (h, w) scratch);
// *grid_out receives the grid size. The result is in (u0, v0) after an
// even number of groups (ceil(iterations / fuse), or iterations for the
// wide form), else in (u1, v1).
extern "C" int hs_resident_launch(
    const void* gx_p, const void* gy_p, const void* gt_p, void* inv_p,
    void* u0_p, void* v0_p, void* u1_p, void* v1_p, void* cs_u_p,
    void* cs_v_p, int h, int w, int window, int iterations, int fuse,
    float alpha2, float inv_area, int recip, void* stream, int* grid_out) {
  const int r = window / 2;
  if (fuse < 0 || (fuse > 0 && SH - 2 * fuse * r < 1) ||
      (fuse == 0 && (cs_u_p == nullptr || cs_v_p == nullptr)) ||
      (recip && inv_p == nullptr))
    return (int)cudaErrorInvalidValue;
  const ResidentFn kernel = resident_for(window, recip, fuse);
  int per_sm = 0;
  int sms = 0;
  cudaError_t err = occupancy(kernel, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int blocks = per_sm * sms;
  *grid_out = blocks;

  const float* gx = (const float*)gx_p;
  const float* gy = (const float*)gy_p;
  const float* gt = (const float*)gt_p;
  float* inv = (float*)inv_p;
  float* u0 = (float*)u0_p;
  float* v0 = (float*)v0_p;
  float* u1 = (float*)u1_p;
  float* v1 = (float*)v1_p;
  float* cs_u = (float*)cs_u_p;
  float* cs_v = (float*)cs_v_p;
  void* args[] = {&gx, &gy, &gt, &inv, &u0, &v0, &u1, &v1, &cs_u, &cs_v,
                  &h, &w, &window, &iterations, &fuse, &alpha2, &inv_area};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                    dim3(32, SH / CY), args, SMEM,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of the resident kernel one SM holds at once for a window, form
// and plan (fuse 0: the wide form), or -(CUDA error).
extern "C" int hs_resident_blocks_per_sm(int window, int recip, int fuse) {
  int per_sm = 0;
  int sms = 0;
  const cudaError_t err = occupancy(resident_for(window, recip, fuse),
                                    &per_sm, &sms);
  return err == cudaSuccess ? per_sm : -(int)err;
}

extern "C" const char* hs_resident_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
