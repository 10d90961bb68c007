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
// What bounds it on the H100: the arithmetic, and in it the IEEE square
// roots and divisions (the build keeps them exact and contracts no FMA),
// each a multi-instruction sequence with a branch to its slow path, so
// the dependent chains of one cell leave the SM waiting unless other warps
// fill in. Device traffic is 28 bytes per pixel and launch, `fuse` sweeps
// apart.
//
// The design computes each edge once. The neighbour term of an edge is
// antisymmetric to the last bit: from either end the product of the norms
// and the dot product are the same products summed in the same order, the
// difference is negated exactly, psi(-x) = -psi(x) exactly (every step
// rounds symmetrically), and so is the weight times it. So per sweep
//
//   1. an edge pass: each cell's right and down edge, where both ends are
//      in the frame and in one region, as (weight * psi(du), weight *
//      psi(dv)) -- one cosine and two psi divisions per edge, the norms of
//      the cell and its two neighbours taken where they are used;
//   2. an update pass: each cell adds -(left cell's right edge), its right
//      edge, -(upper cell's down edge), its down edge -- the plain
//      version's neighbour order (-1,0), (1,0), (0,-1), (0,1) -- then
//      applies the two divisions by sup.
//
// Per pixel and sweep that is 3 square roots and 9 divisions, against the
// direct form's 5 and 15. A gated-off neighbour adds +-0 in the plain
// version, which leaves the sums unchanged (a sum that starts at +0 is
// never -0), so skipping it is bitwise the same; for the same reason the
// sign of a zero edge term never shows.
//
// A block stages an SH x SW tile (its core plus a fuse-pixel halo) and
// runs `fuse` sweeps on it, the valid region shrinking by one pixel per
// sweep; it writes back only the core. Thread (tx, ty) of a (32, SH/CY)
// block owns the cells of rows ty*CY .. ty*CY+CY-1 at columns tx + 32*i,
// i < CX, for the whole launch, and keeps their gate bits (the region
// test done once, at staging) in a register. Shared memory holds u, v and
// the four edge terms, 6 words per cell; u and v update in place, since
// the update pass reads only its own cell of them. gx, gy and it are read
// in the update pass through the read-only cache: held in registers they
// spilled. The 72x128 tile is the tallest whose 6 fields fit one block:
// at fuse 16 its 40x96 core covers a 376x1240 frame in 130 blocks, one
// wave of the 132 SMs per reference direction (a norm field would cost a
// 64-row tile and three waves for two directions). blockIdx.z walks the B
// reference directions: gx, gy and the labels are shared, it, u and v are
// per direction.
//
// sup_x/sup_y are read from device memory (no host sync to launch).
//
// The tile form (irls_gated_tile_launch, TILE = true) runs the same body on
// one mesh tile halo'd by `fuse` (tpuflow's _irls_sweeps_gated on the
// tiles of tpuflow/dist/bm_refine.py): the fields are in_h x in_w arrays
// whose (0, 0) sits at frame coordinates (row0, col0) of an img_h x img_w
// frame, the labels in the halo are the neighbouring tiles' real ones, a
// cell outside the frame is not updated and no neighbour outside the frame
// is gated in (the frame-edge masks of neighbor_masks), and the launch
// writes the (in_h - 2 fuse) x (in_w - 2 fuse) core. The whole-frame form
// is the tile form of a frame with no halo at (0, 0), compiled apart so
// its code keeps its shape.

#include <cuda_runtime.h>

namespace {

// The staged tile: SH rows of SW = 32*CX columns, CY rows per thread; one
// block per SM.
constexpr int SH = 72;
constexpr int CX = 4;
constexpr int CY = 3;
constexpr int SW = 32 * CX;
constexpr int THREADS = 32 * (SH / CY);
constexpr size_t SMEM = 6 * sizeof(float) * SH * SW;

// Gate bits of a cell: right, down, left and up neighbour in the frame and
// in the cell's region; the cell itself in the frame.
constexpr unsigned RIGHT = 1, DOWN = 2, LEFT = 4, UP = 8, INSIDE = 16;
constexpr int GATE_BITS = 5;

__device__ __forceinline__ float psi_gm(float x, float sigma) {
  const float d = sigma + x * x;
  return 2.0f * x * sigma / (d * d);
}

// The edge term from cell c to neighbour q, for u and v.
__device__ __forceinline__ void edge_term(float uc, float vc, float nc,
                                          float uq, float vq, float nq,
                                          float sigma_s, float* eu,
                                          float* ev) {
  const float prod = nc * nq;
  const float cosang =
      prod > 0.f ? (uc * uq + vc * vq) / fmaxf(prod, 1e-30f) : 1.0f;
  const float m = 0.5f * (1.0f + cosang);
  *eu = m * psi_gm(uc - uq, sigma_s);
  *ev = m * psi_gm(vc - vq, sigma_s);
}

// Where a launch reads and writes: the input arrays (in_h x in_w, the
// output's cells `off` in from each side), the frame coordinates of their
// (0, 0) and the frame. The whole-frame form: off 0, at (0, 0), in = img.
struct Geometry {
  int in_h, in_w, off, row0, col0, img_h, img_w;
};

template <bool TILE>
__global__ void __launch_bounds__(THREADS, 1) irls_gated_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ it, const int* __restrict__ labels,
    const float* __restrict__ sup_x, const float* __restrict__ sup_y,
    float* __restrict__ u_out, float* __restrict__ v_out, Geometry gm,
    int fuse, float lambda_d, float lambda_s, float sigma_d, float sigma_s) {
  // Input arrays h x w; the frame's offset of their (0, 0).
  const int h = gm.in_h, w = gm.in_w;
  const int off = TILE ? gm.off : 0;
  const int frow = TILE ? gm.row0 : 0, fcol = TILE ? gm.col0 : 0;
  const int out_h = h - 2 * off, out_w = w - 2 * off;
  extern __shared__ float smem[];
  constexpr int N = SH * SW;
  float* s_u = smem;
  float* s_v = s_u + N;
  float* s_ru = s_v + N;  // right edge, u and v
  float* s_rv = s_ru + N;
  float* s_du = s_rv + N;  // down edge, u and v
  float* s_dv = s_du + N;
  const int tx = threadIdx.x;
  const int y0 = threadIdx.y * CY;
  const float sx = *sup_x;
  const float sy = *sup_y;
  const size_t batch = blockIdx.z * (size_t)h * w;
  const size_t batch_out = blockIdx.z * (size_t)out_h * out_w;
  // Input coordinates of the staged tile's (0, 0).
  const int row0 = blockIdx.y * (SH - 2 * fuse) - fuse + off;
  const int col0 = blockIdx.x * (SW - 2 * fuse) - fuse + off;

  unsigned gate[CY];
#pragma unroll
  for (int j = 0; j < CY; ++j) {
    gate[j] = 0;
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int c = (y0 + j) * SW + tx + 32 * i;
      const int y = row0 + y0 + j;
      const int x = col0 + tx + 32 * i;
      float u = 0.f, v = 0.f;
      unsigned bits = 0;
      // Frame coordinates of the cell (the input's, whole-frame).
      const int fy = frow + y, fx = fcol + x;
      const bool in_frame =
          !TILE || (fy >= 0 && fy < gm.img_h && fx >= 0 && fx < gm.img_w);
      if (y >= 0 && y < h && x >= 0 && x < w && in_frame) {
        const size_t g = (size_t)y * w + x;
        u = u_in[batch + g];
        v = v_in[batch + g];
        const int lc = labels[g];
        bits = INSIDE;
        // A neighbour counts where it is in the input and in the frame.
        if (x + 1 < w && (!TILE || fx + 1 < gm.img_w) && labels[g + 1] == lc)
          bits |= RIGHT;
        if (y + 1 < h && (!TILE || fy + 1 < gm.img_h) && labels[g + w] == lc)
          bits |= DOWN;
        if (x > 0 && (!TILE || fx > 0) && labels[g - 1] == lc) bits |= LEFT;
        if (y > 0 && (!TILE || fy > 0) && labels[g - w] == lc) bits |= UP;
      }
      s_u[c] = u;
      s_v[c] = v;
      gate[j] |= bits << (GATE_BITS * i);
    }
  }
  __syncthreads();

  for (int t = 1; t <= fuse; ++t) {
    // Sweep t is valid on [t, size - t): it reads the ring that sweep t-1
    // left valid. The edge pass covers the edges those cells touch.
#pragma unroll
    for (int j = 0; j < CY; ++j) {
      const int y = y0 + j;
      if (y < t - 1 || y >= SH - t) continue;
#pragma unroll
      for (int i = 0; i < CX; ++i) {
        const int x = tx + 32 * i;
        const unsigned bits = gate[j] >> (GATE_BITS * i);
        const bool right = (bits & RIGHT) && y >= t && x >= t - 1 &&
                           x < SW - t;
        const bool down = (bits & DOWN) && x >= t && x < SW - t;
        if (!right && !down) continue;
        const int c = y * SW + x;
        const float uc = s_u[c];
        const float vc = s_v[c];
        const float nc = sqrtf(uc * uc + vc * vc);
        if (right) {
          const float uq = s_u[c + 1], vq = s_v[c + 1];
          edge_term(uc, vc, nc, uq, vq, sqrtf(uq * uq + vq * vq), sigma_s,
                    &s_ru[c], &s_rv[c]);
        }
        if (down) {
          const float uq = s_u[c + SW], vq = s_v[c + SW];
          edge_term(uc, vc, nc, uq, vq, sqrtf(uq * uq + vq * vq), sigma_s,
                    &s_du[c], &s_dv[c]);
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < CY; ++j) {
      const int y = y0 + j;
      if (y < t || y >= SH - t) continue;
#pragma unroll
      for (int i = 0; i < CX; ++i) {
        const int x = tx + 32 * i;
        const unsigned bits = gate[j] >> (GATE_BITS * i);
        if (!(bits & INSIDE) || x < t || x >= SW - t) continue;
        const int c = y * SW + x;
        const size_t g = (size_t)(row0 + y) * w + col0 + x;
        const float cgx = __ldg(gx + g);
        const float cgy = __ldg(gy + g);
        const float uc = s_u[c];
        const float vc = s_v[c];
        const float psi_d =
            psi_gm(cgx * uc + cgy * vc + __ldg(it + batch + g), sigma_d);
        float nx = 0.f;
        float ny = 0.f;
        if (bits & LEFT) {
          nx = nx + -s_ru[c - 1];
          ny = ny + -s_rv[c - 1];
        }
        if (bits & RIGHT) {
          nx = nx + s_ru[c];
          ny = ny + s_rv[c];
        }
        if (bits & UP) {
          nx = nx + -s_du[c - SW];
          ny = ny + -s_dv[c - SW];
        }
        if (bits & DOWN) {
          nx = nx + s_du[c];
          ny = ny + s_dv[c];
        }
        const float un =
            uc - (lambda_d * cgx * psi_d + lambda_s * nx) / sx;
        const float vn =
            vc - (lambda_d * cgy * psi_d + lambda_s * ny) / sy;
        s_u[c] = un;
        s_v[c] = vn;
      }
    }
    __syncthreads();
  }

  // Each thread writes back the core cells it owns.
#pragma unroll
  for (int j = 0; j < CY; ++j) {
    const int y = y0 + j;
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int x = tx + 32 * i;
      const int oy = row0 + y - off, ox = col0 + x - off;
      if (y < fuse || y >= SH - fuse || x < fuse || x >= SW - fuse ||
          oy >= out_h || ox >= out_w)
        continue;
      const size_t g = batch_out + (size_t)oy * out_w + ox;
      u_out[g] = s_u[y * SW + x];
      v_out[g] = s_v[y * SW + x];
    }
  }
}

template <bool TILE>
int launch(const void* u, const void* v, const void* gx, const void* gy,
           const void* it, const void* labels, const void* sup_x,
           const void* sup_y, void* u_out, void* v_out, const Geometry& gm,
           int batch, int fuse, float lambda_d, float lambda_s,
           float sigma_d, float sigma_s, cudaStream_t stream) {
  if (fuse < 1 || SH - 2 * fuse < 1 || SW - 2 * fuse < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      irls_gated_kernel<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const int out_h = gm.in_h - 2 * gm.off, out_w = gm.in_w - 2 * gm.off;
  const dim3 grid((out_w + SW - 2 * fuse - 1) / (SW - 2 * fuse),
                  (out_h + SH - 2 * fuse - 1) / (SH - 2 * fuse), batch);
  irls_gated_kernel<TILE><<<grid, dim3(32, SH / CY), SMEM, stream>>>(
      (const float*)u, (const float*)v, (const float*)gx, (const float*)gy,
      (const float*)it, (const int*)labels, (const float*)sup_x,
      (const float*)sup_y, (float*)u_out, (float*)v_out, gm, fuse, lambda_d,
      lambda_s, sigma_d, sigma_s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int irls_gated_launch(
    const void* u, const void* v, const void* gx, const void* gy,
    const void* it, const void* labels, const void* sup_x,
    const void* sup_y, void* u_out, void* v_out, int h, int w, int batch,
    int fuse, float lambda_d, float lambda_s, float sigma_d, float sigma_s,
    void* stream) {
  const Geometry gm = {h, w, 0, 0, 0, h, w};
  return launch<false>(u, v, gx, gy, it, labels, sup_x, sup_y, u_out, v_out,
                       gm, batch, fuse, lambda_d, lambda_s, sigma_d, sigma_s,
                       (cudaStream_t)stream);
}

// The tile form: fields (batch, hh, hw) for u, v, it and (hh, hw) for gx,
// gy, labels, their (0, 0) at frame coordinates (row0, col0) of an img_h x
// img_w frame; writes the (batch, hh - 2 fuse, hw - 2 fuse) core.
extern "C" int irls_gated_tile_launch(
    const void* u, const void* v, const void* gx, const void* gy,
    const void* it, const void* labels, const void* sup_x,
    const void* sup_y, void* u_out, void* v_out, int hh, int hw, int row0,
    int col0, int img_h, int img_w, int batch, int fuse, float lambda_d,
    float lambda_s, float sigma_d, float sigma_s, void* stream) {
  if (hh - 2 * fuse < 1 || hw - 2 * fuse < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry gm = {hh, hw, fuse, row0, col0, img_h, img_w};
  return launch<true>(u, v, gx, gy, it, labels, sup_x, sup_y, u_out, v_out,
                      gm, batch, fuse, lambda_d, lambda_s, sigma_d, sigma_s,
                      (cudaStream_t)stream);
}

// Blocks of irls_gated_kernel one SM holds at once, or -(CUDA error).
extern "C" int irls_gated_blocks_per_sm() {
  cudaError_t err = cudaFuncSetAttribute(
      irls_gated_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, irls_gated_kernel<false>, THREADS, SMEM);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" const char* irls_gated_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
