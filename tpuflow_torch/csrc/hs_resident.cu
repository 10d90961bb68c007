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
// says can be co-resident on the card, every block walks its share of the
// frame's tiles in each sweep, u and v are double-buffered in device
// memory, and cooperative_groups' grid sync separates the sweeps.
//
// What bounds it: each sweep reads u, v, gx, gy, gt (and inv) and writes
// u, v, 28-32 bytes per pixel, and does ~30 float operations, so it is
// bound by device memory (or the L2, for the part of the fields that stay
// there), like a one-sweep-per-launch loop without the launches. A block
// stages its tile of u and v with an r-wide halo in shared memory, so the
// box sums read shared memory; the sweep is not fused in time (hs_sweeps
// does that), since a grid sync already costs about what a launch does.
//
// The box sum is taken in the plain version's order and the build disables
// FMA contraction, so the kernel rounds as the plain PyTorch version does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__global__ void hs_resident_kernel(
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ gt, float* __restrict__ inv, float* u0,
    float* v0, float* u1, float* v1, int h, int w, int tile_h, int tile_w,
    int window, int iterations, float alpha2, float inv_area, int recip) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int r = window / 2;
  const int sh = tile_h + 2 * r;
  const int sw = tile_w + 2 * r;
  float* s_u = smem;
  float* s_v = s_u + sh * sw;

  const size_t npx = (size_t)h * w;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < npx;
       i += stride) {
    u0[i] = 0.f;
    v0[i] = 0.f;
    if (recip) {
      const float a = gx[i];
      const float b = gy[i];
      inv[i] = 1.0f / (alpha2 + a * a + b * b);
    }
  }
  grid.sync();

  const int tiles_x = (w + tile_w - 1) / tile_w;
  const int tiles = tiles_x * ((h + tile_h - 1) / tile_h);
  float* u_a = u0;
  float* v_a = v0;
  float* u_b = u1;
  float* v_b = v1;
  for (int it = 0; it < iterations; ++it) {
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      // Frame coordinates of the shared tile's (0, 0).
      const int row0 = (t / tiles_x) * tile_h - r;
      const int col0 = (t % tiles_x) * tile_w - r;
      __syncthreads();  // the previous tile's reads of s_u, s_v are done
      for (int i = threadIdx.x; i < sh * sw; i += blockDim.x) {
        const int y = row0 + i / sw;
        const int x = col0 + i % sw;
        const bool in = y >= 0 && y < h && x >= 0 && x < w;
        const size_t g = (size_t)y * w + x;
        s_u[i] = in ? u_a[g] : 0.f;
        s_v[i] = in ? v_a[g] : 0.f;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < tile_h * tile_w; i += blockDim.x) {
        const int ly = r + i / tile_w;
        const int lx = r + i % tile_w;
        const int y = row0 + ly;
        const int x = col0 + lx;
        if (y >= h || x >= w) continue;
        const float* pu = s_u + (ly - r) * sw + (lx - r);
        const float* pv = s_v + (ly - r) * sw + (lx - r);
        float su = 0.f;
        float sv = 0.f;
        for (int dx = 0; dx < window; ++dx) {
          float cu = pu[dx];
          float cv = pv[dx];
          for (int dy = 1; dy < window; ++dy) {
            cu += pu[dy * sw + dx];
            cv += pv[dy * sw + dx];
          }
          su += cu;
          sv += cv;
        }
        const float ub = su * inv_area;
        const float vb = sv * inv_area;
        const size_t g = (size_t)y * w + x;
        const float a = gx[g];
        const float b = gy[g];
        const float num = a * ub + b * vb + gt[g];
        const float upd =
            recip ? num * inv[g] : num / (alpha2 + a * a + b * b);
        u_b[g] = ub - a * upd;
        v_b[g] = vb - b * upd;
      }
    }
    grid.sync();
    float* swap = u_a;
    u_a = u_b;
    u_b = swap;
    swap = v_a;
    v_a = v_b;
    v_b = swap;
  }
}

}  // namespace

// Launches the solve; *grid_out receives the grid size. The result is in
// (u0, v0) after an even number of iterations, else in (u1, v1).
extern "C" int hs_resident_launch(
    const void* gx_p, const void* gy_p, const void* gt_p, void* inv_p,
    void* u0_p, void* v0_p, void* u1_p, void* v1_p, int h, int w,
    int tile_h, int tile_w, int window, int iterations, float alpha2,
    float inv_area, int recip, int threads, void* stream, int* grid_out) {
  const int r = window / 2;
  const size_t smem =
      2 * sizeof(float) * (size_t)(tile_h + 2 * r) * (size_t)(tile_w + 2 * r);
  cudaError_t err = cudaFuncSetAttribute(
      hs_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, hs_resident_kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int tiles =
      ((w + tile_w - 1) / tile_w) * ((h + tile_h - 1) / tile_h);
  const int blocks = per_sm * sms < tiles ? per_sm * sms : tiles;
  *grid_out = blocks;

  const float* gx = (const float*)gx_p;
  const float* gy = (const float*)gy_p;
  const float* gt = (const float*)gt_p;
  float* inv = (float*)inv_p;
  float* u0 = (float*)u0_p;
  float* v0 = (float*)v0_p;
  float* u1 = (float*)u1_p;
  float* v1 = (float*)v1_p;
  void* args[] = {&gx, &gy, &gt, &inv, &u0, &v0, &u1, &v1,
                  &h, &w, &tile_h, &tile_w, &window, &iterations,
                  &alpha2, &inv_area, &recip};
  err = cudaLaunchCooperativeKernel((const void*)hs_resident_kernel,
                                    dim3(blocks), dim3(threads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* hs_resident_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
