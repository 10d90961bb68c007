// Fused Black-Anandan IRLS Jacobi sweeps for Hopper (sm_90a).
//
// irls_sweeps_kernel replaces tpuflow/kernels/irls_stencil.py::
// irls_sweep_pallas (the TPU kernel _irls_kernel with its sweep body
// _irls_sweeps). Each sweep updates every pixel with
//
//     dEx = lambda_d*gx*psi(gx*u + gy*v + it, sigma_d)
//         + lambda_s*sum_{4 nbrs in frame} psi(u - u_nbr, sigma_s)
//     u  -= dEx / sup_x         (and likewise v with gy, sup_y)
//
// where psi(x, s) = 2xs / (s + x^2)^2 is the reference's Geman-McClure
// influence (its sigma convention, not sigma^2). A neighbour outside the
// frame contributes nothing.
//
// irls_tile_kernel replaces tpuflow/kernels/irls_stencil.py::
// irls_tile_sweeps, the tile body of the sharded IRLS level
// (tpuflow/dist/solvers.py): the same sweeps on one already halo'd tile of
// its own pitch whose (0, 0) sits at frame coordinates (row0, col0) of an
// (img_h, img_w) frame, neighbour terms masked by frame coordinates as
// tpuflow's _nb_masks builds them; it writes only the core. Both kernels
// run the one block body below, so they keep one arithmetic.
//
// What bounds it on the H100: one sweep per launch would read u, v, gx,
// gy, it and write u, v -- 28 bytes per pixel -- so the sweeps are fused:
// a block stages an SH x SW tile (its core plus a fuse-pixel halo) once,
// runs `fuse` sweeps on it with a valid region that shrinks by one pixel
// per sweep, and writes back only its core. What is left is on-chip: the
// IEEE divisions (the build keeps them exact and contracts no FMA), each a
// multi-instruction sequence with a branch to its slow path, the barriers,
// and the halo's redundant work.
//
// The design answers each, as csrc/irls_gated.cu does for the gated sweep.
// psi(u - u_n) is antisymmetric to the last bit: a - b = -(b - a) exactly
// and every step of psi rounds symmetrically. So per sweep
//
//   1. an edge pass: each cell's right and down edge, where both ends are
//      in the frame, as (psi(du), psi(dv));
//   2. an update pass: each cell adds -(left cell's right edge), its right
//      edge, -(upper cell's down edge), its down edge -- the plain
//      version's neighbour order (-1,0), (1,0), (0,-1), (0,1) -- then
//      applies the two divisions by sup.
//
// Per pixel and sweep that is 7 divisions, against the direct form's 11.
// A neighbour outside the frame adds +0 in the plain version, which leaves
// the sum unchanged (a sum that starts at +0 is never -0), so skipping it
// is bitwise the same. Thread (tx, ty) of a (32, SH/CY) block owns the
// cells of rows ty*CY .. ty*CY+CY-1 at columns tx + 32*i, i < CX, for the
// whole launch, and keeps their frame bits (computed once, at staging) in
// a register: no integer division is left in the sweeps. Shared memory
// holds u, v and the four edge terms, 6 words per cell; u and v update in
// place, since the update pass reads only its own cell of them. gx, gy and
// it are read in the update pass through the read-only cache (held in
// registers they spill at 768 threads).
//
// Two staged tiles, one body. WIDE, 72x128, is the tallest whose 6 fields
// fit one block: at fuse 16 its 40x96 core covers a 376x1240 frame in 130
// blocks, one wave of the 132 SMs, and does 1.61x the core's cell-sweeps.
// A block's time grows with its threads' cells (12 here), so a frame that
// gives WIDE a fraction of a wave -- the coarser levels of a pyramid --
// runs faster on NARROW, 64x64 with 4 cells a thread: the launcher takes
// the stage whose waves times cells per thread is smaller.
//
// sup_x/sup_y are read from device memory, so launching needs no host
// sync. The terms are summed in the plain version's order, so the kernel
// rounds as PyTorch's eager ops do.

#include <cuda_runtime.h>

namespace {

// A staged tile: SH rows of SW = 32*CX columns, CY rows per thread,
// BLOCKS blocks per SM.
template <int SH_, int CX_, int CY_, int BLOCKS_>
struct Stage {
  static constexpr int SH = SH_, CX = CX_, CY = CY_, BLOCKS = BLOCKS_;
  static constexpr int SW = 32 * CX;
  static constexpr int THREADS = 32 * (SH / CY);
  static constexpr size_t SMEM = 6 * sizeof(float) * SH * SW;
};
// The two stages; use_narrow picks one per launch.
using WIDE = Stage<72, 4, 3, 1>;
using NARROW = Stage<64, 2, 2, 1>;

// Frame bits of a cell: right, down, left and up neighbour in the frame;
// the cell itself in the frame (and in the input).
constexpr unsigned RIGHT = 1, DOWN = 2, LEFT = 4, UP = 8, INSIDE = 16;
constexpr int FRAME_BITS = 5;

__device__ __forceinline__ float psi_gm(float x, float sigma) {
  const float d = sigma + x * x;
  return 2.0f * x * sigma / (d * d);
}

// `fuse` sweeps of one staged tile, then its core written back. Staged
// cell (y, x) is input cell (iy0 + y, ix0 + x) of an (in_h, in_w) array
// (zero beyond it) and frame cell (fy0 + y, fx0 + x) of an (img_h, img_w)
// frame; a core cell goes to output cell (oy0 + y, ox0 + x) of an
// (out_h, out_w) array. A cell is swept where it lies in the input and in
// the frame; one in the input but outside the frame passes through.
template <class S>
__device__ __forceinline__ void irls_block(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ it, float sx, float sy,
    float* __restrict__ u_out, float* __restrict__ v_out, int in_h,
    int in_w, int iy0, int ix0, int fy0, int fx0, int img_h, int img_w,
    int out_h, int out_w, int oy0, int ox0, int fuse, float lambda_d,
    float lambda_s, float sigma_d, float sigma_s) {
  constexpr int SH = S::SH, SW = S::SW, CX = S::CX, CY = S::CY;
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

  auto in_input = [&](int y, int x) {
    return iy0 + y >= 0 && iy0 + y < in_h && ix0 + x >= 0 && ix0 + x < in_w;
  };
  auto live = [&](int y, int x) {
    return in_input(y, x) && fy0 + y >= 0 && fy0 + y < img_h &&
           fx0 + x >= 0 && fx0 + x < img_w;
  };

  unsigned bits_of[CY];
#pragma unroll
  for (int j = 0; j < CY; ++j) {
    bits_of[j] = 0;
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int y = y0 + j;
      const int x = tx + 32 * i;
      float u = 0.f, v = 0.f;
      unsigned bits = 0;
      if (in_input(y, x)) {
        const size_t g = (size_t)(iy0 + y) * in_w + ix0 + x;
        u = u_in[g];
        v = v_in[g];
        if (live(y, x)) {
          bits = INSIDE;
          if (live(y, x + 1)) bits |= RIGHT;
          if (live(y + 1, x)) bits |= DOWN;
          if (live(y, x - 1)) bits |= LEFT;
          if (live(y - 1, x)) bits |= UP;
        }
      }
      s_u[y * SW + x] = u;
      s_v[y * SW + x] = v;
      bits_of[j] |= bits << (FRAME_BITS * i);
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
        const unsigned bits = bits_of[j] >> (FRAME_BITS * i);
        const bool right = (bits & RIGHT) && y >= t && x >= t - 1 &&
                           x < SW - t;
        const bool down = (bits & DOWN) && x >= t && x < SW - t;
        if (!right && !down) continue;
        const int c = y * SW + x;
        const float uc = s_u[c];
        const float vc = s_v[c];
        if (right) {
          s_ru[c] = psi_gm(uc - s_u[c + 1], sigma_s);
          s_rv[c] = psi_gm(vc - s_v[c + 1], sigma_s);
        }
        if (down) {
          s_du[c] = psi_gm(uc - s_u[c + SW], sigma_s);
          s_dv[c] = psi_gm(vc - s_v[c + SW], sigma_s);
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
        const unsigned bits = bits_of[j] >> (FRAME_BITS * i);
        if (!(bits & INSIDE) || x < t || x >= SW - t) continue;
        const int c = y * SW + x;
        const size_t g = (size_t)(iy0 + y) * in_w + ix0 + x;
        const float cgx = __ldg(gx + g);
        const float cgy = __ldg(gy + g);
        const float uc = s_u[c];
        const float vc = s_v[c];
        const float psi_d =
            psi_gm(cgx * uc + cgy * vc + __ldg(it + g), sigma_d);
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
        s_u[c] = uc - (lambda_d * cgx * psi_d + lambda_s * nx) / sx;
        s_v[c] = vc - (lambda_d * cgy * psi_d + lambda_s * ny) / sy;
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
      if (y < fuse || y >= SH - fuse || x < fuse || x >= SW - fuse ||
          oy0 + y >= out_h || ox0 + x >= out_w)
        continue;
      const size_t g = (size_t)(oy0 + y) * out_w + ox0 + x;
      u_out[g] = s_u[y * SW + x];
      v_out[g] = s_v[y * SW + x];
    }
  }
}

template <class S>
__global__ void __launch_bounds__(S::THREADS, S::BLOCKS) irls_sweeps_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ it, const float* __restrict__ sup_x,
    const float* __restrict__ sup_y, float* __restrict__ u_out,
    float* __restrict__ v_out, int h, int w, int fuse, float lambda_d,
    float lambda_s, float sigma_d, float sigma_s) {
  // Frame coordinates of the staged tile's (0, 0).
  const int y0 = blockIdx.y * (S::SH - 2 * fuse) - fuse;
  const int x0 = blockIdx.x * (S::SW - 2 * fuse) - fuse;
  irls_block<S>(u_in, v_in, gx, gy, it, *sup_x, *sup_y, u_out, v_out, h, w,
                y0, x0, y0, x0, h, w, h, w, y0, x0, fuse, lambda_d, lambda_s,
                sigma_d, sigma_s);
}

// One halo'd (hh x hw) tile in, its (hh - 2*fuse) x (hw - 2*fuse) core
// out; the tile's (0, 0) sits at frame coordinates (row0, col0).
template <class S>
__global__ void __launch_bounds__(S::THREADS, S::BLOCKS) irls_tile_kernel(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ it, const float* __restrict__ sup_x,
    const float* __restrict__ sup_y, float* __restrict__ u_out,
    float* __restrict__ v_out, int hh, int hw, int row0, int col0,
    int img_h, int img_w, int fuse, float lambda_d, float lambda_s,
    float sigma_d, float sigma_s) {
  // Tile coordinates of the staged tile's (0, 0).
  const int ay0 = blockIdx.y * (S::SH - 2 * fuse);
  const int ax0 = blockIdx.x * (S::SW - 2 * fuse);
  irls_block<S>(u_in, v_in, gx, gy, it, *sup_x, *sup_y, u_out, v_out, hh,
                hw, ay0, ax0, row0 + ay0, col0 + ax0, img_h, img_w,
                hh - 2 * fuse, hw - 2 * fuse, ay0 - fuse, ax0 - fuse, fuse,
                lambda_d, lambda_s, sigma_d, sigma_s);
}

template <class S>
dim3 grid_for(int out_h, int out_w, int fuse) {
  return dim3((out_w + S::SW - 2 * fuse - 1) / (S::SW - 2 * fuse),
              (out_h + S::SH - 2 * fuse - 1) / (S::SH - 2 * fuse));
}

// A launch's time in units of one block's sweeps: the waves of blocks the
// card runs it in, times each thread's cells.
template <class S>
int cost(int out_h, int out_w, int fuse, int sms) {
  const dim3 g = grid_for<S>(out_h, out_w, fuse);
  const int slots = sms * S::BLOCKS;
  const int waves = (int)((g.x * g.y + slots - 1) / slots);
  return waves * (S::SH * S::SW / S::THREADS);
}

// Whether NARROW serves an (out_h, out_w) output at `fuse` better than
// WIDE: it must leave a core, and take fewer waves of its cheaper blocks.
bool use_narrow(int out_h, int out_w, int fuse) {
  if (2 * fuse >= NARROW::SH) return false;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return false;
  return cost<NARROW>(out_h, out_w, fuse, sms) <
         cost<WIDE>(out_h, out_w, fuse, sms);
}

template <class S, typename F>
cudaError_t allow_smem(F kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
}

template <class S>
int sweeps_launch(const float* u, const float* v, const float* gx,
                  const float* gy, const float* it, const float* sup_x,
                  const float* sup_y, float* u_out, float* v_out, int h,
                  int w, int fuse, float lambda_d, float lambda_s,
                  float sigma_d, float sigma_s, cudaStream_t stream) {
  cudaError_t err = allow_smem<S>(irls_sweeps_kernel<S>);
  if (err != cudaSuccess) return (int)err;
  irls_sweeps_kernel<S><<<grid_for<S>(h, w, fuse), dim3(32, S::SH / S::CY),
                          S::SMEM, stream>>>(
      u, v, gx, gy, it, sup_x, sup_y, u_out, v_out, h, w, fuse, lambda_d,
      lambda_s, sigma_d, sigma_s);
  return (int)cudaGetLastError();
}

template <class S>
int tile_launch(const float* u, const float* v, const float* gx,
                const float* gy, const float* it, const float* sup_x,
                const float* sup_y, float* u_out, float* v_out, int hh,
                int hw, int row0, int col0, int img_h, int img_w, int fuse,
                float lambda_d, float lambda_s, float sigma_d, float sigma_s,
                cudaStream_t stream) {
  cudaError_t err = allow_smem<S>(irls_tile_kernel<S>);
  if (err != cudaSuccess) return (int)err;
  irls_tile_kernel<S><<<grid_for<S>(hh - 2 * fuse, hw - 2 * fuse, fuse),
                        dim3(32, S::SH / S::CY), S::SMEM, stream>>>(
      u, v, gx, gy, it, sup_x, sup_y, u_out, v_out, hh, hw, row0, col0,
      img_h, img_w, fuse, lambda_d, lambda_s, sigma_d, sigma_s);
  return (int)cudaGetLastError();
}

template <class S, typename F>
int blocks_per_sm(F kernel) {
  int blocks = 0;
  cudaError_t err = allow_smem<S>(kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        S::THREADS, S::SMEM);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

extern "C" int irls_sweeps_launch(
    const void* u, const void* v, const void* gx, const void* gy,
    const void* it, const void* sup_x, const void* sup_y, void* u_out,
    void* v_out, int h, int w, int fuse, float lambda_d, float lambda_s,
    float sigma_d, float sigma_s, void* stream) {
  auto launch = use_narrow(h, w, fuse) ? sweeps_launch<NARROW>
                                       : sweeps_launch<WIDE>;
  return launch((const float*)u, (const float*)v, (const float*)gx,
                (const float*)gy, (const float*)it, (const float*)sup_x,
                (const float*)sup_y, (float*)u_out, (float*)v_out, h, w,
                fuse, lambda_d, lambda_s, sigma_d, sigma_s,
                (cudaStream_t)stream);
}

extern "C" int irls_tile_launch(
    const void* u, const void* v, const void* gx, const void* gy,
    const void* it, const void* sup_x, const void* sup_y, void* u_out,
    void* v_out, int hh, int hw, int row0, int col0, int img_h, int img_w,
    int fuse, float lambda_d, float lambda_s, float sigma_d, float sigma_s,
    void* stream) {
  auto launch = use_narrow(hh - 2 * fuse, hw - 2 * fuse, fuse)
                    ? tile_launch<NARROW>
                    : tile_launch<WIDE>;
  return launch((const float*)u, (const float*)v, (const float*)gx,
                (const float*)gy, (const float*)it, (const float*)sup_x,
                (const float*)sup_y, (float*)u_out, (float*)v_out, hh, hw,
                row0, col0, img_h, img_w, fuse, lambda_d, lambda_s, sigma_d,
                sigma_s, (cudaStream_t)stream);
}

// Blocks one SM holds at once of the sweeps (tile = 0) or the tile kernel
// (tile = 1) on the WIDE (narrow = 0) or the NARROW stage, or -(CUDA
// error).
extern "C" int irls_blocks_per_sm(int tile, int narrow) {
  if (narrow)
    return tile ? blocks_per_sm<NARROW>(irls_tile_kernel<NARROW>)
                : blocks_per_sm<NARROW>(irls_sweeps_kernel<NARROW>);
  return tile ? blocks_per_sm<WIDE>(irls_tile_kernel<WIDE>)
              : blocks_per_sm<WIDE>(irls_sweeps_kernel<WIDE>);
}

extern "C" const char* irls_sweeps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
