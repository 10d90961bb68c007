// Fused region-gated IRLS Jacobi sweeps for Hopper (sm_90a).
//
// Replaces tpuflow/kernels/irls_stencil.py::irls_gated_sweep_pallas (the
// TPU kernel _irls_gated_kernel with its sweep body _irls_sweeps_gated):
// the flagship's gradient refinement (OpticalFlow_BlockMatching.cpp:
// 412-514). Each sweep updates every pixel with
//
//     psi_d = psi(gx*u + gy*v + it, sigma_d)
//     nx    = sum over the 4 neighbours n in the frame AND in the same
//             region of  0.5*(1 + cos(u, u_n)) * psi(u - u_n, sigma_s)
//     u    -= (lambda_d*gx*psi_d + lambda_s*nx) / sup_x   (likewise v)
//
// where cos = (u.u_n)/max(|u||u_n|, 1e-30), or 1 where |u||u_n| is 0, and
// psi(x, s) = 2xs / (s + x^2)^2 (the reference's Geman-McClure).
//
// What bounds it on the H100: the arithmetic. Per pixel and sweep it is
// ~120 flops, five square roots and ten divisions, against 28 bytes of
// device traffic that a one-sweep kernel would move; fused, the traffic
// drops by `fuse` and the sqrt/division throughput sets the time. As in
// the TPU kernel, a block stages its 32x32 tile plus a fuse-pixel halo of
// u, v, gx, gy, it and the labels in shared memory once (8 fields of
// 64^2 words at fuse 16: 128 KB), runs `fuse` sweeps there with
// double-buffered u/v and a valid region that shrinks by one pixel per
// sweep, and writes back only its core. Out-of-frame halo cells carry
// label -1, which matches no region, so the gate needs no bounds test.
// blockIdx.z walks the B reference directions: gx, gy and the labels are
// shared, it, u and v are per direction, so the bidirectional refine is
// one launch per block of sweeps.
//
// sup_x/sup_y are read from device memory (no host sync to launch). The
// build disables FMA contraction and the terms are summed in the plain
// version's order. A gated-off neighbour adds +-0 in the plain version,
// which leaves the sums unchanged, so skipping it here is bitwise the same.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float psi_gm(float x, float sigma) {
  const float d = sigma + x * x;
  return 2.0f * x * sigma / (d * d);
}

__global__ void irls_gated_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ it, const int* __restrict__ labels,
    const float* __restrict__ sup_x, const float* __restrict__ sup_y,
    float* __restrict__ u_out, float* __restrict__ v_out, int h, int w,
    int tile_h, int tile_w, int fuse, float lambda_d, float lambda_s,
    float sigma_d, float sigma_s) {
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
  int* s_lab = reinterpret_cast<int*>(s_it + n);
  const float sx = *sup_x;
  const float sy = *sup_y;
  const size_t plane = (size_t)h * w;
  const size_t batch = blockIdx.z * plane;
  // Frame coordinates of the shared tile's (0, 0).
  const int row0 = blockIdx.y * tile_h - fuse;
  const int col0 = blockIdx.x * tile_w - fuse;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = row0 + i / sw;
    const int x = col0 + i % sw;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const size_t g = (size_t)y * w + x;
      u_a[i] = u_in[batch + g];
      v_a[i] = v_in[batch + g];
      s_gx[i] = gx[g];
      s_gy[i] = gy[g];
      s_it[i] = it[batch + g];
      s_lab[i] = labels[g];
    } else {
      u_a[i] = 0.f;
      v_a[i] = 0.f;
      s_lab[i] = -1;
    }
  }
  __syncthreads();

  const int nbr[4] = {-1, 1, -sw, sw};  // (-1, 0), (1, 0), (0, -1), (0, 1)
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
      const float norm_c = sqrtf(uc * uc + vc * vc);
      const int lc = s_lab[c];
      float nx = 0.f;
      float ny = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = c + nbr[k];
        if (s_lab[q] != lc) continue;
        const float un = u_a[q];
        const float vn = v_a[q];
        const float prod = norm_c * sqrtf(un * un + vn * vn);
        const float cosang =
            prod > 0.f ? (uc * un + vc * vn) / fmaxf(prod, 1e-30f) : 1.0f;
        const float m = 0.5f * (1.0f + cosang);
        nx = nx + m * psi_gm(uc - un, sigma_s);
        ny = ny + m * psi_gm(vc - vn, sigma_s);
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

  for (int i = threadIdx.x; i < tile_h * tile_w; i += blockDim.x) {
    const int ly = fuse + i / tile_w;
    const int lx = fuse + i % tile_w;
    const int y = row0 + ly;
    const int x = col0 + lx;
    if (y < h && x < w) {
      const size_t g = (size_t)y * w + x;
      u_out[batch + g] = u_a[ly * sw + lx];
      v_out[batch + g] = v_a[ly * sw + lx];
    }
  }
}

}  // namespace

extern "C" int irls_gated_launch(
    const void* u, const void* v, const void* gx, const void* gy,
    const void* it, const void* labels, const void* sup_x,
    const void* sup_y, void* u_out, void* v_out, int h, int w, int batch,
    int tile_h, int tile_w, int fuse, float lambda_d, float lambda_s,
    float sigma_d, float sigma_s, int threads, void* stream) {
  const size_t smem = 8 * sizeof(float) * (size_t)(tile_h + 2 * fuse) *
                      (size_t)(tile_w + 2 * fuse);
  cudaError_t err = cudaFuncSetAttribute(
      irls_gated_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h,
                  batch);
  irls_gated_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)gx, (const float*)gy,
      (const float*)it, (const int*)labels, (const float*)sup_x,
      (const float*)sup_y, (float*)u_out, (float*)v_out, h, w, tile_h,
      tile_w, fuse, lambda_d, lambda_s, sigma_d, sigma_s);
  return (int)cudaGetLastError();
}

extern "C" const char* irls_gated_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
