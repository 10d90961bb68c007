// The region matcher's per-region moment sums for Hopper (sm_90a).
//
// Replaces no TPU kernel. tpuflow leaves this product to XLA
// (tpuflow/blockmatching/matcher.py::_matmul_costs: per 32-row strip, a
// one-hot L^T @ F in float32 on the MXU), and the port first ran it as
// eager PyTorch (blockmatching/matcher.py::_matmul_sums): per strip and
// per chunk of 64 candidates two gathers, a stack, a cast to float64, a
// float64 GEMM and an indexed add, 708 chunks a bidirectional frame, which
// the host launches more slowly than the card runs them. This kernel takes
// the whole candidate list in one launch and reduces straight into the
// per-region float64 sums.
//
// What it computes, for every region r, candidate (dy, dx) and reference
// frame k, over the pixels p = (y, x) of r, with cur = (L, a*, b*) of the
// current frame at p and ref = reference k at (y + dy, x + dx), zeros
// outside the frame (the reference's get_zeropad):
//
//     out[r][4k + 0][c] = sum (|L - L'| + |a - a'| + |b - b'|) * lab_scale
//     out[r][4k + 1][c] = sum L'
//     out[r][4k + 2][c] = sum L' * L'
//     out[r][4k + 3][c] = sum L * L'
//
// and fix[r] = (sum 1, sum L, sum L * L), with every field computed in
// float32 in the plain version's operations and order, rounded to
// bfloat16 (round to nearest even) where the method asks, then converted
// to float64 and summed in float64 (matcher.ACC). Only the order of the
// float64 adds differs from the plain version.
//
// What bounds it on the H100: the conversions. Every evaluation (pixel,
// candidate, reference) converts four float32 fields to float64, and
// Hopper converts float32 to float64 at 16 a clock per SM, against 64
// float64 adds and 128 float32 operations a clock: at the flagship's
// 465,750 pixels x 3,721 candidates x 2 references the 1.4e10 conversions
// take ~3.4 ms at 1.98 GHz on 132 SMs, the adds ~0.8 ms, the float32
// field arithmetic (~11 operations an evaluation) ~0.6 ms. The reference
// reads stay in L1 and L2: each pixel's warp reads consecutive addresses.
//
// The design: a block takes one segment of at most `seg` pixels of one
// region, in the label-sorted order (a stable sort of the labels: raster
// order within a region), and a tile of THREADS candidates; each thread
// owns one candidate and keeps its 4 * NREF float64 sums in registers, so
// a sum is taken pixel by pixel in raster order and the only conversions
// and adds are the ones the fields need. A round stages STAGE pixels'
// positions and colours in shared memory, read back as broadcasts; a
// warp's lanes hold consecutive candidates, which share dy and take
// consecutive dx (two runs where the warp crosses a row of the search), so
// their reference reads are consecutive addresses of the planar frames.
// A region's first segment writes its sums to `out`; a larger region's
// later segments write theirs to `scratch`, and a second launch
// (bm_cost_combine_kernel) adds them to the first in segment order. No
// atomics: each (region, candidate) sum is taken in one order, set by the
// labels and the frame alone, whatever candidates the launch holds, and
// whether it matches one reference or two, so a mesh rank's slice of the
// candidates and each direction of a bidirectional search are bitwise
// the whole list's columns and the single-direction search.
//
// The wrapper (kernels/bm_cost.py) sorts the labels on the card, finds
// each region's bounds and the running count of segments (seg_end:
// max(1, ceil(count / seg)) a region, so an empty region's one segment
// writes its zeros), and launches one block row per segment slot: the
// upper bound n_regions + n_pixels / seg, the slots past the last
// segment returning at once. Segment j >= 1 of region r, at slot s, keeps
// its sums in scratch row s - r - 1; there are at most n_pixels / seg.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Candidates a block (one a thread), and pixels staged a round.
constexpr int THREADS = 128;
constexpr int STAGE = 256;
constexpr int COMBINE_THREADS = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int NREF, bool BF16>
__global__ void __launch_bounds__(THREADS)
bm_cost_kernel(const float* __restrict__ cur, const float* __restrict__ refs,
               const int64_t* __restrict__ perm,
               const int64_t* __restrict__ bounds,
               const int64_t* __restrict__ seg_end,
               const int64_t* __restrict__ cand, double* __restrict__ out,
               double* __restrict__ fix, double* __restrict__ scratch,
               double* __restrict__ fix_scratch, int n_regions, int h, int w,
               int n_cand, int seg, float lab_scale) {
  constexpr int F = 4 * NREF;
  const int slot = blockIdx.y;
  // The slot's region: the first r whose running segment count passes it.
  int lo = 0, hi = n_regions;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg_end[mid] > slot) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  if (lo == n_regions) return;  // past the last segment (block-uniform)
  const int r = lo;
  const int part = slot - (r ? (int)seg_end[r - 1] : 0);
  const int64_t start = bounds[r] + (int64_t)part * seg;
  const int64_t stop = bounds[r + 1];
  const int64_t end = start + seg < stop ? start + seg : stop;

  const int c = blockIdx.x * THREADS + threadIdx.x;
  const bool live = c < n_cand;
  const int dy = live ? (int)cand[2 * c] : 0;
  const int dx = live ? (int)cand[2 * c + 1] : 0;
  const int64_t hw = (int64_t)h * w;
  const int64_t shift = (int64_t)dy * w + dx;
  // One thread of the first candidate tile also sums the current frame's
  // candidate-invariant moments.
  const bool fix_thread = blockIdx.x == 0 && threadIdx.x == 0;

  double s[F];
#pragma unroll
  for (int f = 0; f < F; ++f) s[f] = 0.0;
  double fn = 0.0, fa = 0.0, faa = 0.0;

  __shared__ int4 s_pos[STAGE];    // y, x, y * w + x
  __shared__ float4 s_col[STAGE];  // L, a*, b* of the current frame

  for (int64_t p0 = start; p0 < end; p0 += STAGE) {
    const int n = end - p0 < STAGE ? (int)(end - p0) : STAGE;
    __syncthreads();  // the last round's reads are done
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int64_t q = perm[p0 + i];
      const int y = (int)(q / w);
      const int x = (int)(q - (int64_t)y * w);
      s_pos[i] = make_int4(y, x, (int)q, 0);
      s_col[i] = make_float4(cur[q], cur[hw + q], cur[2 * hw + q], 0.0f);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const int4 p = s_pos[i];
      const float4 a = s_col[i];
      const bool in = (unsigned)(p.x + dy) < (unsigned)h &&
                      (unsigned)(p.y + dx) < (unsigned)w;
      const int64_t at = (int64_t)p.z + shift;
#pragma unroll
      for (int k = 0; k < NREF; ++k) {
        const float* ref = refs + 3 * hw * k;
        float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
        if (in) {
          b0 = __ldg(ref + at);
          b1 = __ldg(ref + hw + at);
          b2 = __ldg(ref + 2 * hw + at);
        }
        // matcher._l1: the channels' absolute differences summed in
        // order, times the float32 constant; then b, b*b and a*b.
        float l1 = (fabsf(a.x - b0) + fabsf(a.y - b1) + fabsf(a.z - b2)) *
                   lab_scale;
        float bv = b0;
        float bb = b0 * b0;
        float ab = a.x * b0;
        if (BF16) {
          l1 = round_bf16(l1);
          bv = round_bf16(bv);
          bb = round_bf16(bb);
          ab = round_bf16(ab);
        }
        s[4 * k + 0] += (double)l1;
        s[4 * k + 1] += (double)bv;
        s[4 * k + 2] += (double)bb;
        s[4 * k + 3] += (double)ab;
      }
      if (fix_thread) {
        fn += 1.0;
        fa += (double)a.x;
        faa += (double)(a.x * a.x);
      }
    }
  }

  const int64_t row = part == 0 ? r : slot - r - 1;
  double* dst = (part == 0 ? out : scratch) + row * F * n_cand;
  if (live) {
#pragma unroll
    for (int f = 0; f < F; ++f) dst[(int64_t)f * n_cand + c] = s[f];
  }
  if (fix_thread) {
    double* fd = (part == 0 ? fix : fix_scratch) + 3 * row;
    fd[0] = fn;
    fd[1] = fa;
    fd[2] = faa;
  }
}

// Adds each region's later segments (scratch rows) to its first (out), in
// segment order; n_cols = 4 * NREF * n_cand, and the three fix sums after
// them.
__global__ void __launch_bounds__(COMBINE_THREADS)
bm_cost_combine_kernel(double* __restrict__ out, double* __restrict__ fix,
                       const double* __restrict__ scratch,
                       const double* __restrict__ fix_scratch,
                       const int64_t* __restrict__ seg_end, int n_cols) {
  const int r = blockIdx.y;
  const int64_t first = r ? seg_end[r - 1] : 0;
  const int parts = (int)(seg_end[r] - first);
  if (parts < 2) return;
  const int64_t row0 = first - r;  // the scratch row of segment 1
  const int j = blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (j < n_cols) {
    double acc = out[(int64_t)r * n_cols + j];
    for (int k = 1; k < parts; ++k)
      acc += scratch[(row0 + k - 1) * n_cols + j];
    out[(int64_t)r * n_cols + j] = acc;
  } else if (j < n_cols + 3) {
    const int f = j - n_cols;
    double acc = fix[3 * r + f];
    for (int k = 1; k < parts; ++k) acc += fix_scratch[3 * (row0 + k - 1) + f];
    fix[3 * r + f] = acc;
  }
}

template <int NREF, bool BF16>
cudaError_t launch_sums(const float* cur, const float* refs,
                        const int64_t* perm, const int64_t* bounds,
                        const int64_t* seg_end, const int64_t* cand,
                        double* out, double* fix, double* scratch,
                        double* fix_scratch, int n_regions, int n_slots, int h,
                        int w, int n_cand, int seg, float lab_scale,
                        cudaStream_t stream) {
  const dim3 grid((n_cand + THREADS - 1) / THREADS, n_slots);
  bm_cost_kernel<NREF, BF16><<<grid, THREADS, 0, stream>>>(
      cur, refs, perm, bounds, seg_end, cand, out, fix, scratch, fix_scratch,
      n_regions, h, w, n_cand, seg, lab_scale);
  return cudaGetLastError();
}

}  // namespace

// cur (3, h, w) and refs (n_ref, 3, h, w) planar float32; perm (h*w,) the
// stable label sort, bounds (n_regions + 1,), seg_end (n_regions,); cand
// (n_cand, 2) (dy, dx); out (n_regions, 4 n_ref, n_cand) and fix
// (n_regions, 3) float64; scratch (>= n_slots - n_regions rows of 4 n_ref
// n_cand) and fix_scratch (the same rows of 3). Two launches: the sums,
// then the combine. Returns a CUDA error code (0 on success).
extern "C" int bm_cost_launch(const void* cur, const void* refs,
                              const void* perm, const void* bounds,
                              const void* seg_end, const void* cand, void* out,
                              void* fix, void* scratch, void* fix_scratch,
                              int n_regions, int n_slots, int h, int w,
                              int n_cand, int n_ref, int bf16, int seg,
                              float lab_scale, void* stream) {
  if (n_ref < 1 || n_ref > 2 || n_regions < 1 || n_cand < 1 || seg < 1 ||
      n_slots < n_regions || n_slots > 65535 || n_regions > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  auto* c = (const float*)cur;
  auto* rf = (const float*)refs;
  auto* pm = (const int64_t*)perm;
  auto* bd = (const int64_t*)bounds;
  auto* se = (const int64_t*)seg_end;
  auto* cd = (const int64_t*)cand;
  auto* o = (double*)out;
  auto* fx = (double*)fix;
  auto* sc = (double*)scratch;
  auto* fs = (double*)fix_scratch;
  cudaError_t err;
  if (n_ref == 1) {
    err = bf16 ? launch_sums<1, true>(c, rf, pm, bd, se, cd, o, fx, sc, fs,
                                      n_regions, n_slots, h, w, n_cand, seg,
                                      lab_scale, st)
               : launch_sums<1, false>(c, rf, pm, bd, se, cd, o, fx, sc, fs,
                                       n_regions, n_slots, h, w, n_cand, seg,
                                       lab_scale, st);
  } else {
    err = bf16 ? launch_sums<2, true>(c, rf, pm, bd, se, cd, o, fx, sc, fs,
                                      n_regions, n_slots, h, w, n_cand, seg,
                                      lab_scale, st)
               : launch_sums<2, false>(c, rf, pm, bd, se, cd, o, fx, sc, fs,
                                       n_regions, n_slots, h, w, n_cand, seg,
                                       lab_scale, st);
  }
  if (err != cudaSuccess) return (int)err;
  const int n_cols = 4 * n_ref * n_cand;
  const dim3 grid((n_cols + 3 + COMBINE_THREADS - 1) / COMBINE_THREADS,
                  n_regions);
  bm_cost_combine_kernel<<<grid, COMBINE_THREADS, 0, st>>>(o, fx, sc, fs, se,
                                                          n_cols);
  return (int)cudaGetLastError();
}

// Blocks of the sums kernel (n_ref references, bf16 rounding or not) one
// SM holds at once, or -(CUDA error).
extern "C" int bm_cost_blocks_per_sm(int n_ref, int bf16) {
  int blocks = 0;
  cudaError_t err;
  if (n_ref == 1) {
    err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, bm_cost_kernel<1, true>, THREADS, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, bm_cost_kernel<1, false>, THREADS, 0);
  } else {
    err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, bm_cost_kernel<2, true>, THREADS, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &blocks, bm_cost_kernel<2, false>, THREADS, 0);
  }
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" const char* bm_cost_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
