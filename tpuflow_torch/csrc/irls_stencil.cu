// Fused Black-Anandan IRLS Jacobi sweeps for Hopper (sm_90a).
//
// Replaces tpuflow/kernels/irls_stencil.py::irls_sweep_pallas (the TPU
// kernel _irls_kernel with its sweep body _irls_sweeps). Each sweep
// updates every pixel with
//
//     dEx = lambda_d*gx*psi(gx*u + gy*v + it, sigma_d)
//         + lambda_s*sum_{4 nbrs in frame} psi(u - u_nbr, sigma_s)
//     u  -= dEx / sup_x         (and likewise v with gy, sup_y)
//
// where psi(x, s) = 2xs / (s + x^2)^2 is the reference's Geman-McClure
// influence (its sigma convention, not sigma^2). A neighbour outside the
// frame contributes nothing, so cells outside the frame are never read
// and never computed; the ragged last tile is masked here.
//
// What bounds it on the H100: one sweep per launch would read u, v, gx,
// gy, it and write u, v -- 28 bytes per pixel for ~50 flops and four
// divisions -- so a one-sweep-per-launch loop is memory- and
// launch-latency-bound. As on the TPU, one block loads its tile plus a
// fuse-pixel halo of the five fields into shared memory once, runs `fuse`
// sweeps there with double-buffered u/v and a valid region that shrinks
// by one pixel per sweep, and writes back only its core: device-memory
// traffic drops by ~fuse, paid for with redundant halo work.
//
// sup_x/sup_y are read from device memory, so launching needs no host
// sync. The build disables FMA contraction and the terms are summed in
// the plain version's order, so the kernel rounds as PyTorch's eager ops do.

// irls_tile_kernel replaces tpuflow/kernels/irls_stencil.py::
// irls_tile_sweeps, the tile body of the sharded IRLS level
// (tpuflow/dist/solvers.py): the same sweeps on one already halo'd tile of
// its own pitch whose (0, 0) sits at frame coordinates (row0, col0) of an
// (img_h, img_w) frame, neighbour terms masked by frame coordinates as
// tpuflow's _nb_masks builds them; it writes only the core. As in
// irls_sweeps_kernel, a cell outside the frame is neither computed nor
// read (its neighbour terms are masked), so the core, which lies in the
// frame, is what tpuflow's tile body computes. Both kernels run the one
// sweep body below.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float psi_gm(float x, float sigma) {
  const float d = sigma + x * x;
  return 2.0f * x * sigma / (d * d);
}

// `fuse` sweeps of the shared tile (sh x sw cells, frame coordinates of
// its (0, 0) at (row0, col0)); on return u_a/v_a hold the last sweep.
__device__ __forceinline__ void irls_sweeps_shared(
    float*& u_a, float*& v_a, float*& u_b, float*& v_b, const float* s_gx,
    const float* s_gy, const float* s_it, float sx, float sy, int sh, int sw,
    int row0, int col0, int h, int w, int fuse, float lambda_d,
    float lambda_s, float sigma_d, float sigma_s) {
  for (int t = 1; t <= fuse; ++t) {
    // Sweep t is valid on [t, size - t): it reads the ring that sweep t-1
    // left valid.
    const int nh = sh - 2 * t;
    const int nw = sw - 2 * t;
    for (int i = threadIdx.x; i < nh * nw; i += blockDim.x) {
      const int ly = t + i / nw;
      const int lx = t + i % nw;
      const int y = row0 + ly;
      const int x = col0 + lx;
      if (y < 0 || y >= h || x < 0 || x >= w) continue;
      const int c = ly * sw + lx;
      const float uc = u_a[c];
      const float vc = v_a[c];
      const float psi_d = psi_gm(s_gx[c] * uc + s_gy[c] * vc + s_it[c],
                                 sigma_d);
      // Neighbours in the order (-1, 0), (1, 0), (0, -1), (0, 1).
      float nx = 0.f;
      float ny = 0.f;
      if (x > 0) {
        nx = nx + psi_gm(uc - u_a[c - 1], sigma_s);
        ny = ny + psi_gm(vc - v_a[c - 1], sigma_s);
      }
      if (x < w - 1) {
        nx = nx + psi_gm(uc - u_a[c + 1], sigma_s);
        ny = ny + psi_gm(vc - v_a[c + 1], sigma_s);
      }
      if (y > 0) {
        nx = nx + psi_gm(uc - u_a[c - sw], sigma_s);
        ny = ny + psi_gm(vc - v_a[c - sw], sigma_s);
      }
      if (y < h - 1) {
        nx = nx + psi_gm(uc - u_a[c + sw], sigma_s);
        ny = ny + psi_gm(vc - v_a[c + sw], sigma_s);
      }
      u_b[c] = uc - (lambda_d * s_gx[c] * psi_d + lambda_s * nx) / sx;
      v_b[c] = vc - (lambda_d * s_gy[c] * psi_d + lambda_s * ny) / sy;
    }
    __syncthreads();
    float* swap = u_a;
    u_a = u_b;
    u_b = swap;
    swap = v_a;
    v_a = v_b;
    v_b = swap;
  }
}

__global__ void irls_sweeps_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ it, const float* __restrict__ sup_x,
    const float* __restrict__ sup_y, float* __restrict__ u_out,
    float* __restrict__ v_out, int h, int w, int tile_h, int tile_w,
    int fuse, float lambda_d, float lambda_s, float sigma_d, float sigma_s) {
  extern __shared__ float smem[];
  const int sh = tile_h + 2 * fuse;
  const int sw = tile_w + 2 * fuse;
  const int n = sh * sw;
  float* u_a = smem;
  float* v_a = u_a + n;
  float* u_b = v_a + n;
  float* v_b = u_b + n;
  float* s_gx = v_b + n;
  float* s_gy = s_gx + n;
  float* s_it = s_gy + n;
  const float sx = *sup_x;
  const float sy = *sup_y;
  // Frame coordinates of the shared tile's (0, 0).
  const int row0 = blockIdx.y * tile_h - fuse;
  const int col0 = blockIdx.x * tile_w - fuse;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = row0 + i / sw;
    const int x = col0 + i % sw;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const size_t g = (size_t)y * w + x;
      u_a[i] = u_in[g];
      v_a[i] = v_in[g];
      s_gx[i] = gx[g];
      s_gy[i] = gy[g];
      s_it[i] = it[g];
    }
  }
  __syncthreads();

  irls_sweeps_shared(u_a, v_a, u_b, v_b, s_gx, s_gy, s_it, sx, sy, sh, sw,
                     row0, col0, h, w, fuse, lambda_d, lambda_s, sigma_d,
                     sigma_s);

  for (int i = threadIdx.x; i < tile_h * tile_w; i += blockDim.x) {
    const int ly = fuse + i / tile_w;
    const int lx = fuse + i % tile_w;
    const int y = row0 + ly;
    const int x = col0 + lx;
    if (y < h && x < w) {
      const size_t g = (size_t)y * w + x;
      u_out[g] = u_a[ly * sw + lx];
      v_out[g] = v_a[ly * sw + lx];
    }
  }
}

// One halo'd (hh x hw) tile in, its (hh - 2*fuse) x (hw - 2*fuse) core
// out; the tile's (0, 0) sits at frame coordinates (row0, col0).
__global__ void irls_tile_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ it, const float* __restrict__ sup_x,
    const float* __restrict__ sup_y, float* __restrict__ u_out,
    float* __restrict__ v_out, int hh, int hw, int row0, int col0,
    int img_h, int img_w, int tile_h, int tile_w, int fuse, float lambda_d,
    float lambda_s, float sigma_d, float sigma_s) {
  extern __shared__ float smem[];
  const int sh = tile_h + 2 * fuse;
  const int sw = tile_w + 2 * fuse;
  const int n = sh * sw;
  float* u_a = smem;
  float* v_a = u_a + n;
  float* u_b = v_a + n;
  float* v_b = u_b + n;
  float* s_gx = v_b + n;
  float* s_gy = s_gx + n;
  float* s_it = s_gy + n;
  const float sx = *sup_x;
  const float sy = *sup_y;
  // Tile coordinates of the shared tile's (0, 0).
  const int ay0 = blockIdx.y * tile_h;
  const int ax0 = blockIdx.x * tile_w;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ay = ay0 + i / sw;
    const int ax = ax0 + i % sw;
    float u = 0.f, v = 0.f, a = 0.f, b = 0.f, c = 0.f;
    if (ay < hh && ax < hw) {
      const size_t g = (size_t)ay * hw + ax;
      u = u_in[g];
      v = v_in[g];
      a = gx[g];
      b = gy[g];
      c = it[g];
    }
    u_a[i] = u;
    v_a[i] = v;
    s_gx[i] = a;
    s_gy[i] = b;
    s_it[i] = c;
  }
  __syncthreads();

  irls_sweeps_shared(u_a, v_a, u_b, v_b, s_gx, s_gy, s_it, sx, sy, sh, sw,
                     row0 + ay0, col0 + ax0, img_h, img_w, fuse, lambda_d,
                     lambda_s, sigma_d, sigma_s);

  const int th = hh - 2 * fuse;
  const int tw = hw - 2 * fuse;
  for (int i = threadIdx.x; i < tile_h * tile_w; i += blockDim.x) {
    const int cy = ay0 + i / tile_w;
    const int cx = ax0 + i % tile_w;
    if (cy < th && cx < tw) {
      const int l = (fuse + i / tile_w) * sw + fuse + i % tile_w;
      u_out[(size_t)cy * tw + cx] = u_a[l];
      v_out[(size_t)cy * tw + cx] = v_a[l];
    }
  }
}

}  // namespace

extern "C" int irls_sweeps_launch(
    const void* u, const void* v, const void* gx, const void* gy,
    const void* it, const void* sup_x, const void* sup_y, void* u_out,
    void* v_out, int h, int w, int tile_h, int tile_w, int fuse,
    float lambda_d, float lambda_s, float sigma_d, float sigma_s,
    int threads, void* stream) {
  const size_t smem = 7 * sizeof(float) * (size_t)(tile_h + 2 * fuse) *
                      (size_t)(tile_w + 2 * fuse);
  cudaError_t err = cudaFuncSetAttribute(
      irls_sweeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h);
  irls_sweeps_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)gx, (const float*)gy,
      (const float*)it, (const float*)sup_x, (const float*)sup_y,
      (float*)u_out, (float*)v_out, h, w, tile_h, tile_w, fuse, lambda_d,
      lambda_s, sigma_d, sigma_s);
  return (int)cudaGetLastError();
}

extern "C" int irls_tile_launch(
    const void* u, const void* v, const void* gx, const void* gy,
    const void* it, const void* sup_x, const void* sup_y, void* u_out,
    void* v_out, int hh, int hw, int row0, int col0, int img_h, int img_w,
    int tile_h, int tile_w, int fuse, float lambda_d, float lambda_s,
    float sigma_d, float sigma_s, int threads, void* stream) {
  const size_t smem = 7 * sizeof(float) * (size_t)(tile_h + 2 * fuse) *
                      (size_t)(tile_w + 2 * fuse);
  cudaError_t err = cudaFuncSetAttribute(
      irls_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int th = hh - 2 * fuse;
  const int tw = hw - 2 * fuse;
  const dim3 grid((tw + tile_w - 1) / tile_w, (th + tile_h - 1) / tile_h);
  irls_tile_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)gx, (const float*)gy,
      (const float*)it, (const float*)sup_x, (const float*)sup_y,
      (float*)u_out, (float*)v_out, hh, hw, row0, col0, img_h, img_w, tile_h,
      tile_w, fuse, lambda_d, lambda_s, sigma_d, sigma_s);
  return (int)cudaGetLastError();
}

extern "C" const char* irls_sweeps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
