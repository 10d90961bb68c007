// Fused Horn-Schunck Jacobi sweeps for Hopper (sm_90a).
//
// Replaces tpuflow/kernels/hs_stencil.py::horn_schunck_pallas (the TPU
// kernel _hs_kernel with its sweep body _hs_sweeps). Each sweep computes
//
//     ub  = box_W(u) / W^2,  vb = box_W(v) / W^2   (zeros beyond the frame)
//     upd = (gx*ub + gy*vb + gt) * inv_denom
//     u   = ub - gx*upd,     v = vb - gy*upd
//
// What bounds it on the H100: one sweep per launch would read u, v, gx,
// gy, gt, inv_denom and write u, v -- 32 bytes per pixel, 66 MB at 1080p --
// for about 60 flops per pixel, so a one-sweep-per-launch loop is
// memory- and launch-latency-bound. The design keeps the TPU kernel's
// idea: one block loads its tile plus a fuse*r halo of all six fields into
// shared memory once, runs `fuse` sweeps there with double-buffered u/v
// and a valid region that shrinks by r per sweep, and writes back only
// its core. Device-memory traffic drops by ~fuse; what is paid instead is
// the redundant halo work and the shared-memory reads of the box sums.
//
// Cells outside the frame are held at 0 after every sweep, which is the
// BORDER_CONSTANT box of the reference; the ragged last tile of a frame
// whose size is no multiple of the tile is masked here too. The box sum
// is taken in the TPU kernel's order (vertical sums per column, then the
// columns left to right) and the build disables FMA contraction, so the
// kernel rounds as the plain PyTorch version does.

// hs_tile_kernel replaces tpuflow/kernels/hs_stencil.py::hs_tile_sweeps,
// the tile body of the sharded solver (tpuflow/dist/solvers.py): the same
// sweeps on one already halo'd tile of its own pitch, whose (0, 0) sits at
// frame coordinates (row0, col0) of an (img_h, img_w) frame; it writes only
// the core. Its blocks tile that core as hs_sweeps_kernel's tile the frame,
// each loading its part of the halo'd tile (out-of-frame cells zeroed, as
// the TPU kernel multiplies by its inside mask); both kernels run the one
// sweep body below, so they keep one arithmetic. Cells past the tile's end
// read as zero; after `fuse` sweeps their influence reaches need = fuse*r
// cells inward, which is the halo the core does not include.

#include <cuda_runtime.h>

namespace {

// `fuse` sweeps of the shared tile (sh x sw cells, frame coordinates of
// its (0, 0) at (row0, col0)); on return u_a/v_a hold the last sweep.
__device__ __forceinline__ void hs_sweeps_shared(
    float*& u_a, float*& v_a, float*& u_b, float*& v_b,
    const float* s_gx, const float* s_gy, const float* s_gt,
    const float* s_inv, int sh, int sw, int row0, int col0, int h, int w,
    int window, int fuse, float inv_area) {
  const int r = window / 2;
  for (int t = 1; t <= fuse; ++t) {
    // Sweep t is valid on [t*r, size - t*r): it reads the r-ring that
    // sweep t-1 left valid.
    const int lo = t * r;
    const int nh = sh - 2 * lo;
    const int nw = sw - 2 * lo;
    for (int i = threadIdx.x; i < nh * nw; i += blockDim.x) {
      const int ly = lo + i / nw;
      const int lx = lo + i % nw;
      const int y = row0 + ly;
      const int x = col0 + lx;
      const int c = ly * sw + lx;
      float u_new = 0.f;
      float v_new = 0.f;
      if (y >= 0 && y < h && x >= 0 && x < w) {
        const float* pu = u_a + (ly - r) * sw + (lx - r);
        const float* pv = v_a + (ly - r) * sw + (lx - r);
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
        const float upd = (s_gx[c] * ub + s_gy[c] * vb + s_gt[c]) * s_inv[c];
        u_new = ub - s_gx[c] * upd;
        v_new = vb - s_gy[c] * upd;
      }
      u_b[c] = u_new;
      v_b[c] = v_new;
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

__global__ void hs_sweeps_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ gt, const float* __restrict__ inv,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int h, int w, int tile_h, int tile_w, int window, int fuse,
    float inv_area) {
  extern __shared__ float smem[];
  const int r = window / 2;
  const int halo = fuse * r;
  const int sh = tile_h + 2 * halo;
  const int sw = tile_w + 2 * halo;
  const int n = sh * sw;
  float* u_a = smem;
  float* v_a = u_a + n;
  float* u_b = v_a + n;
  float* v_b = u_b + n;
  float* s_gx = v_b + n;
  float* s_gy = s_gx + n;
  float* s_gt = s_gy + n;
  float* s_inv = s_gt + n;
  // Frame coordinates of the shared tile's (0, 0).
  const int row0 = blockIdx.y * tile_h - halo;
  const int col0 = blockIdx.x * tile_w - halo;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = row0 + i / sw;
    const int x = col0 + i % sw;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const size_t g = (size_t)y * w + x;
      u_a[i] = u_in[g];
      v_a[i] = v_in[g];
      s_gx[i] = gx[g];
      s_gy[i] = gy[g];
      s_gt[i] = gt[g];
      s_inv[i] = inv[g];
    } else {
      u_a[i] = 0.f;
      v_a[i] = 0.f;
    }
  }
  __syncthreads();

  hs_sweeps_shared(u_a, v_a, u_b, v_b, s_gx, s_gy, s_gt, s_inv, sh, sw, row0,
                   col0, h, w, window, fuse, inv_area);

  for (int i = threadIdx.x; i < tile_h * tile_w; i += blockDim.x) {
    const int ly = halo + i / tile_w;
    const int lx = halo + i % tile_w;
    const int y = row0 + ly;
    const int x = col0 + lx;
    if (y < h && x < w) {
      const size_t g = (size_t)y * w + x;
      u_out[g] = u_a[ly * sw + lx];
      v_out[g] = v_a[ly * sw + lx];
    }
  }
}

// One halo'd (hh x hw) tile in, its (hh - 2*need) x (hw - 2*need) core
// out; the tile's (0, 0) sits at frame coordinates (row0, col0).
__global__ void hs_tile_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ gt, const float* __restrict__ inv,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int hh, int hw, int row0, int col0, int img_h, int img_w,
    int tile_h, int tile_w, int window, int fuse, float inv_area) {
  extern __shared__ float smem[];
  const int need = fuse * (window / 2);
  const int sh = tile_h + 2 * need;
  const int sw = tile_w + 2 * need;
  const int n = sh * sw;
  float* u_a = smem;
  float* v_a = u_a + n;
  float* u_b = v_a + n;
  float* v_b = u_b + n;
  float* s_gx = v_b + n;
  float* s_gy = s_gx + n;
  float* s_gt = s_gy + n;
  float* s_inv = s_gt + n;
  // Tile coordinates, then frame coordinates, of the shared tile's (0, 0).
  const int ay0 = blockIdx.y * tile_h;
  const int ax0 = blockIdx.x * tile_w;
  const int fy0 = row0 + ay0;
  const int fx0 = col0 + ax0;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int ay = ay0 + i / sw;
    const int ax = ax0 + i % sw;
    float u = 0.f, v = 0.f, a = 0.f, b = 0.f, c = 0.f, d = 0.f;
    if (ay < hh && ax < hw) {
      const size_t g = (size_t)ay * hw + ax;
      const int y = row0 + ay;
      const int x = col0 + ax;
      if (y >= 0 && y < img_h && x >= 0 && x < img_w) {
        u = u_in[g];
        v = v_in[g];
      }
      a = gx[g];
      b = gy[g];
      c = gt[g];
      d = inv[g];
    }
    u_a[i] = u;
    v_a[i] = v;
    s_gx[i] = a;
    s_gy[i] = b;
    s_gt[i] = c;
    s_inv[i] = d;
  }
  __syncthreads();

  hs_sweeps_shared(u_a, v_a, u_b, v_b, s_gx, s_gy, s_gt, s_inv, sh, sw, fy0,
                   fx0, img_h, img_w, window, fuse, inv_area);

  const int th = hh - 2 * need;
  const int tw = hw - 2 * need;
  for (int i = threadIdx.x; i < tile_h * tile_w; i += blockDim.x) {
    const int cy = ay0 + i / tile_w;
    const int cx = ax0 + i % tile_w;
    if (cy < th && cx < tw) {
      const int l = (need + i / tile_w) * sw + need + i % tile_w;
      u_out[(size_t)cy * tw + cx] = u_a[l];
      v_out[(size_t)cy * tw + cx] = v_a[l];
    }
  }
}

}  // namespace

extern "C" int hs_sweeps_launch(
    const void* u, const void* v, const void* gx, const void* gy,
    const void* gt, const void* inv, void* u_out, void* v_out,
    int h, int w, int tile_h, int tile_w, int window, int fuse,
    float inv_area, int threads, void* stream) {
  const int halo = fuse * (window / 2);
  const size_t smem = 8 * sizeof(float) * (size_t)(tile_h + 2 * halo) *
                      (size_t)(tile_w + 2 * halo);
  cudaError_t err = cudaFuncSetAttribute(
      hs_sweeps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h);
  hs_sweeps_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)gx, (const float*)gy,
      (const float*)gt, (const float*)inv, (float*)u_out, (float*)v_out,
      h, w, tile_h, tile_w, window, fuse, inv_area);
  return (int)cudaGetLastError();
}

extern "C" int hs_tile_launch(
    const void* u, const void* v, const void* gx, const void* gy,
    const void* gt, const void* inv, void* u_out, void* v_out,
    int hh, int hw, int row0, int col0, int img_h, int img_w, int tile_h,
    int tile_w, int window, int fuse, float inv_area, int threads,
    void* stream) {
  const int need = fuse * (window / 2);
  const size_t smem = 8 * sizeof(float) * (size_t)(tile_h + 2 * need) *
                      (size_t)(tile_w + 2 * need);
  cudaError_t err = cudaFuncSetAttribute(
      hs_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int th = hh - 2 * need;
  const int tw = hw - 2 * need;
  const dim3 grid((tw + tile_w - 1) / tile_w, (th + tile_h - 1) / tile_h);
  hs_tile_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)gx, (const float*)gy,
      (const float*)gt, (const float*)inv, (float*)u_out, (float*)v_out, hh,
      hw, row0, col0, img_h, img_w, tile_h, tile_w, window, fuse, inv_area);
  return (int)cudaGetLastError();
}

extern "C" const char* hs_sweeps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
