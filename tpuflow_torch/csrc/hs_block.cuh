// The Horn-Schunck sweep bodies that csrc/hs_stencil.cu and
// csrc/hs_resident.cu share. Each sweep computes
//
//     ub  = box_W(u) / W^2,  vb = box_W(v) / W^2   (zeros beyond the frame)
//     upd = (gx*ub + gy*vb + gt) * inv_denom      (DIVIDE: / denominator)
//     u   = ub - gx*upd,     v = vb - gy*upd
//
// Both forms take the box sum in the plain version's order: each cell's
// W-high column sum top to bottom, then W adjacent column sums left to
// right from 0. With FMA contraction disabled they round as the plain
// PyTorch versions do.
//
// hs_block runs `fuse` sweeps on one staged tile (see csrc/hs_stencil.cu).
// The wide form (hs_colsum_cell, then hs_update_cell) runs one sweep of a
// window whose halo leaves no core in the staged tile: a pass that writes
// every cell's column sums to device memory, then a pass that adds them
// along the row and applies the update.

#pragma once

#include <cuda_runtime.h>

// `fuse` sweeps of one staged tile of SH rows and SW = 32*CX columns, run
// by a (32, SH/CY) block, then its core written back. Staged cell (y, x) is
// input cell (iy0 + y, ix0 + x) of an (in_h, in_w) array (zero beyond it),
// frame cell (fy0 + y, fx0 + x), and output cell (oy0 + y, ox0 + x) of an
// (out_h, out_w) array. KR is the box radius, or 0 to take it from
// `window`. DIVIDE: `inv` is not read; each sweep divides by
// alpha2 + gx^2 + gy^2 (formed once per cell at staging, the same bits as
// forming it every sweep) instead of multiplying by inv.
template <int SH, int CX, int CY, int KR, bool DIVIDE>
__device__ __forceinline__ void hs_block(
    const float* __restrict__ u_in, const float* __restrict__ v_in,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ gt, const float* __restrict__ inv,
    float* __restrict__ u_out, float* __restrict__ v_out, int in_h,
    int in_w, int iy0, int ix0, int fy0, int fx0, int img_h, int img_w,
    int out_h, int out_w, int oy0, int ox0, int window, int fuse,
    float inv_area, float alpha2) {
  constexpr int SW = 32 * CX;
  constexpr int N = SH * SW;
  extern __shared__ float smem[];
  float* s_u = smem;
  float* s_v = s_u + N;
  float* s_cu = s_v + N;  // column sums of u and v
  float* s_cv = s_cu + N;
  const int r = KR > 0 ? KR : window / 2;
  const int win = 2 * r + 1;
  const int tx = threadIdx.x;
  const int y0 = threadIdx.y * CY;

  // f_inv holds inv_denom, or with DIVIDE the denominator.
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
        d = DIVIDE ? alpha2 + a * a + b * b : inv[g];
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
          const float num = f_gx[j][i] * ub + f_gy[j][i] * vb + f_gt[j][i];
          const float upd = DIVIDE ? num / f_inv[j][i] : num * f_inv[j][i];
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

// The wide form's geometry. Its input (u, v) is an (in_h, in_w) array
// whose (0, 0) is frame cell (fy0, fx0); cells outside the frame read as
// zero. Its output is the (in_h - 2*off, in_w - 2*off) array whose (0, 0)
// is input cell (off, off): off is 0 for a whole frame (the box reaches
// past the array's edge, where it reads zeros) and r for a halo'd tile
// (the VALID box, which shrinks the tile by r on each side). The column
// sums are (in_h - 2*off, in_w), of pitch in_w. The fixed fields are read
// at cell (g0 + y, g0 + x) of an array of pitch g_w.
struct HsWide {
  int in_h, in_w, off, g_w, g0, fy0, fx0, img_h, img_w, r;
};

// Column sums of output row y and input column x: rows y + off - r ..
// y + off + r of u and v, top to bottom.
__device__ __forceinline__ void hs_colsum_cell(
    const HsWide& p, const float* __restrict__ u, const float* __restrict__ v,
    float* __restrict__ cs_u, float* __restrict__ cs_v, int y, int x) {
  const bool col_in = p.fx0 + x >= 0 && p.fx0 + x < p.img_w;
  // Rows of the input that hold frame cells.
  const int ylo = max(0, -p.fy0);
  const int yhi = min(p.in_h, p.img_h - p.fy0);
  const int top = y + p.off - p.r;
  float cu = 0.f, cv = 0.f;
  for (int dy = 0; dy <= 2 * p.r; ++dy) {
    const int iy = top + dy;
    float a = 0.f, b = 0.f;
    if (col_in && iy >= ylo && iy < yhi) {
      a = u[(size_t)iy * p.in_w + x];
      b = v[(size_t)iy * p.in_w + x];
    }
    cu = dy ? cu + a : a;
    cv = dy ? cv + b : b;
  }
  cs_u[(size_t)y * p.in_w + x] = cu;
  cs_v[(size_t)y * p.in_w + x] = cv;
}

// The update of output cell (y, x): column sums x + off - r .. x + off + r
// left to right from 0 (zero past the array), then the sweep; cells
// outside the frame are written as 0.
template <bool DIVIDE>
__device__ __forceinline__ void hs_update_cell(
    const HsWide& p, const float* __restrict__ cs_u,
    const float* __restrict__ cs_v, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ gt,
    const float* __restrict__ inv, float* __restrict__ u_out,
    float* __restrict__ v_out, int y, int x, float inv_area, float alpha2) {
  const int out_w = p.in_w - 2 * p.off;
  const int fy = p.fy0 + p.off + y;
  const int fx = p.fx0 + p.off + x;
  float u_new = 0.f, v_new = 0.f;
  if (fy >= 0 && fy < p.img_h && fx >= 0 && fx < p.img_w) {
    const float* pu = cs_u + (size_t)y * p.in_w;
    const float* pv = cs_v + (size_t)y * p.in_w;
    const int left = x + p.off - p.r;
    float su = 0.f, sv = 0.f;
    for (int dx = 0; dx <= 2 * p.r; ++dx) {
      const int c = left + dx;
      const bool in = c >= 0 && c < p.in_w;
      su += in ? pu[c] : 0.f;
      sv += in ? pv[c] : 0.f;
    }
    const size_t g = (size_t)(p.g0 + y) * p.g_w + p.g0 + x;
    const float a = gx[g];
    const float b = gy[g];
    const float ub = su * inv_area;
    const float vb = sv * inv_area;
    const float num = a * ub + b * vb + gt[g];
    const float upd = DIVIDE ? num / (alpha2 + a * a + b * b) : num * inv[g];
    u_new = ub - a * upd;
    v_new = vb - b * upd;
  }
  u_out[(size_t)y * out_w + x] = u_new;
  v_out[(size_t)y * out_w + x] = v_new;
}
