// The per-edge segment of GraphAttention as device code for NVIDIA Hopper
// (sm_90a) on the CUDA cores: what the float32 edge kernel of edge_kernel.cu
// runs.
//
// edge_segment() takes one tile of TR edge rows through
//   w   = radial MLP(edge scalars)      Linear+LN(fast var, eps 1e-5)+SiLU ..., Linear + offset
//   A1  = attr @ C1                     every CG coefficient of DTP1
//   Y1  = DTP1 pieces (lane slices of x1 times A1 columns, times w)
//   cmb = Y1 @ W_av + b_av              merged alpha / value linear
//   logits = (SmoothLeakyReLU(cmb[:ma]) * c) @ Dmat
//   mid = [silu(scalars) | gated * sigmoid(gates)]   (i-major irreps_mid)
//   A2  = attr @ C2;  Y2 = DTP2 pieces of mid;  val = Y2 @ W2   (b2 is left to the caller)
// and leaves the logits in a buffer of the caller and val in register
// accumulators (8 rows x up to 12 columns a thread).
//
// The DTP scratch (L1 lanes a row) never exists: each DTP piece (width <= 64)
// is computed into a small shared buffer and multiplied straight into the
// accumulators, so the products run from registers with every weight element
// reused for 8 rows.  The folded weights are read row by row through L1 from
// L2.  The radial MLP runs in the block, so the per-edge radial weights never
// reach device memory.
//
// Everything is f32 (plain FMA, no fast-math).  The tensor-core version of the
// same segment, which the mixed bfloat16 edge kernel and the fused attention
// kernel run, is edge_segment_mma() of edge_segment_mma.cuh.
//
// The host-side tables (piece offsets, term lists, weight-block starts, gate
// indices, radial widths) come from the port's build_edge_plan.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace edge {

constexpr int TR = 32;            // rows per tile
constexpr int NWARP = 4;          // warps per block
constexpr int NTHREADS = NWARP * 32;
constexpr int RPT = TR / NWARP;   // rows per thread in the products
constexpr int MAXJ = 12;          // product columns per lane (<= 384 columns)
constexpr int MAXW = 64;          // widest DTP piece

struct Cfg {
  int rows, dim_in, dim_sh, S, numel1, nA1, nA2;
  int np1, nt1, np2, nt2;
  int n_comb, ma, sd, gd, td, H, attn, n_rad, max_hidden, mid_dim;
  float sl_norm, silu_norm, sig_norm;
  int r0, r1;  // floats in the two shared regions
};

// cfg: 21 ints in the order of Cfg up to mid_dim; also sizes the two shared regions.
inline Cfg make_cfg(const int* cfg, float sl_norm, float silu_norm, float sig_norm) {
  Cfg c;
  c.rows = cfg[0], c.dim_in = cfg[1], c.dim_sh = cfg[2], c.S = cfg[3], c.numel1 = cfg[4];
  c.nA1 = cfg[5], c.nA2 = cfg[6], c.np1 = cfg[7], c.nt1 = cfg[8], c.np2 = cfg[9], c.nt2 = cfg[10];
  c.n_comb = cfg[11], c.ma = cfg[12], c.sd = cfg[13], c.gd = cfg[14], c.td = cfg[15], c.H = cfg[16];
  c.attn = cfg[17], c.n_rad = cfg[18], c.max_hidden = cfg[19], c.mid_dim = cfg[20];
  c.sl_norm = sl_norm;
  c.silu_norm = silu_norm;
  c.sig_norm = sig_norm;
  const int wmax = c.S > c.max_hidden ? c.S : c.max_hidden;
  int r0 = c.numel1;
  if (c.n_comb > r0) r0 = c.n_comb;
  if (c.nA2 + MAXW > r0) r0 = c.nA2 + MAXW;
  int r1 = 2 * wmax;
  if (c.nA1 + MAXW > r1) r1 = c.nA1 + MAXW;
  if (c.mid_dim > r1) r1 = c.mid_dim;
  c.r0 = TR * r0;
  c.r1 = TR * r1;
  return c;
}

// The int32 tables of one plan, as the host packs them.
struct Tables {
  const int *pieces1, *terms1, *pieces2, *terms2, *gate_idx, *rdims;
};

__device__ __forceinline__ Tables split_tables(const Cfg& c, const int* __restrict__ meta) {
  Tables t;
  t.pieces1 = meta;
  t.terms1 = t.pieces1 + 6 * c.np1;
  t.pieces2 = t.terms1 + 2 * c.nt1;
  t.terms2 = t.pieces2 + 6 * c.np2;
  t.gate_idx = t.terms2 + 2 * c.nt2;
  t.rdims = t.gate_idx + (c.gd ? c.td : 0);
  return t;
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// Round to bf16 (nearest even) and hold the result as a float.
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// A = attr_tile @ C  (TR x nA) into dst (row stride nA); rows past the end are zero.
__device__ __forceinline__ void attr_product(const Cfg& c, const float* __restrict__ attr, int row0, int nrows,
                             const float* __restrict__ C, int nA, float* dst) {
  for (int e = threadIdx.x; e < TR * nA; e += NTHREADS) {
    int r = e / nA, col = e - r * nA;
    float s = 0.f;
    if (r < nrows) {
      const float* a = attr + (size_t)(row0 + r) * c.dim_sh;
      for (int j = 0; j < c.dim_sh; ++j) s += a[j] * __ldg(C + j * nA + col);
    }
    dst[r * nA + col] = s;
  }
}

// acc[rr][j] += sum over the DTP's pieces of piece(r, u) * W[lane + u, col]
// where piece(r, u) = sum_t x(r, off + i_t * mul + u) * A(r, c_t) (* w(r, ws + u)).
// x rows are read from `xg` (global, stride ldx) or `xs` (shared, stride ldx).
template <bool X_GLOBAL, bool WEIGHTED>
__device__ __forceinline__ void dtp_product(const float* __restrict__ xg, const float* xs, int ldx, int row0, int nrows,
                            const int* __restrict__ pieces, const int* __restrict__ terms, int np,
                            const float* A, int nA, const float* wr, int ldw, float* P,
                            const float* __restrict__ W, int ncol, float (&acc)[RPT][MAXJ]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int p = 0; p < np; ++p) {
    const int off = __ldg(pieces + 6 * p), mul = __ldg(pieces + 6 * p + 1);
    const int ts = __ldg(pieces + 6 * p + 2), nt = __ldg(pieces + 6 * p + 3);
    const int ws = __ldg(pieces + 6 * p + 4), wl = __ldg(pieces + 6 * p + 5);
    for (int e = threadIdx.x; e < TR * mul; e += NTHREADS) {
      int r = e / mul, u = e - r * mul;
      float s = 0.f;
      if (r < nrows) {
        for (int t = 0; t < nt; ++t) {
          int i = __ldg(terms + 2 * (ts + t)), col = __ldg(terms + 2 * (ts + t) + 1);
          int xi = off + i * mul + u;
          float xv = X_GLOBAL ? __ldg(xg + (size_t)(row0 + r) * ldx + xi) : xs[r * ldx + xi];
          s += xv * A[r * nA + col];
        }
        if (WEIGHTED) s *= wr[r * ldw + ws + u];
      }
      P[r * MAXW + u] = s;
    }
    __syncthreads();
    const float* Wp = W + (size_t)wl * ncol;
#pragma unroll 2
    for (int k = 0; k < mul; ++k) {
      float w[MAXJ];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        int col = lane + 32 * j;
        w[j] = col < ncol ? __ldg(Wp + (size_t)k * ncol + col) : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) {
        float pv = P[(warp * RPT + rr) * MAXW + k];
#pragma unroll
        for (int j = 0; j < MAXJ; ++j) acc[rr][j] = fmaf(pv, w[j], acc[rr][j]);
      }
    }
    __syncthreads();
  }
}

// One tile of rows [row0, row0 + nrows) through the whole segment.  R0 and
// R1 are the two shared regions (c.r0 and c.r1 floats).  The logits of tile
// row r < lg_rows go to lg[r * H + h] (global or shared memory); acc returns
// val without its bias: thread (warp, lane) holds tile rows warp * RPT + rr
// and columns lane + 32 * j.  Ends on a block-wide barrier.
__device__ __forceinline__ void edge_segment(const Cfg& c, float* R0, float* R1, int row0, int nrows,
                             const float* __restrict__ x1, const float* __restrict__ attr,
                             const float* __restrict__ es, const Tables& tb,
                             const float* __restrict__ rad, const float* __restrict__ W_av,
                             const float* __restrict__ b_av, const float* __restrict__ Dmat,
                             const float* __restrict__ W2, const float* __restrict__ C1,
                             const float* __restrict__ C2, float* lg, int lg_rows,
                             float (&acc)[RPT][MAXJ]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // ---- radial MLP: ping-pong in R1, the last layer writes w (TR x numel1) into R0
  const int wmax = max(c.S, c.max_hidden);
  float* hin = R1;
  float* hout = R1 + TR * wmax;
  for (int e = tid; e < TR * c.S; e += NTHREADS) {
    int r = e / c.S, k = e - r * c.S;
    hin[r * wmax + k] = r < nrows ? __ldg(es + (size_t)(row0 + r) * c.S + k) : 0.f;
  }
  __syncthreads();
  const float* rp = rad;
  for (int l = 0; l < c.n_rad; ++l) {
    const int din = __ldg(tb.rdims + l), dout = __ldg(tb.rdims + l + 1);
    const bool last = l == c.n_rad - 1;
    const float* Wl = rp;
    rp += din * dout;
    const float* bl = rp;  // bias (hidden) or offset (last)
    rp += dout;
    float* dst = last ? R0 : hout;
    const int ld = last ? c.numel1 : wmax;
    for (int e = tid; e < TR * dout; e += NTHREADS) {
      int r = e / dout, o = e - r * dout;
      float s = 0.f;
      for (int k = 0; k < din; ++k) s += hin[r * wmax + k] * __ldg(Wl + k * dout + o);
      dst[r * ld + o] = s + __ldg(bl + o);
    }
    __syncthreads();
    if (!last) {
      const float* scale = rp;
      const float* shift = rp + dout;
      rp += 2 * dout;
      for (int r = warp; r < TR; r += NWARP) {
        float s = 0.f, ss = 0.f;
        for (int o = lane; o < dout; o += 32) {
          float v = hout[r * wmax + o];
          s += v;
          ss += v * v;
        }
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, m);
          ss += __shfl_xor_sync(0xffffffffu, ss, m);
        }
        const float mu = s / dout;
        const float inv = rsqrtf(ss / dout - mu * mu + 1e-5f);
        for (int o = lane; o < dout; o += 32) {
          float v = (hout[r * wmax + o] - mu) * inv * __ldg(scale + o) + __ldg(shift + o);
          hout[r * wmax + o] = v * sigmoidf_(v);
        }
      }
      __syncthreads();
      float* t = hin;
      hin = hout;
      hout = t;
    }
  }

  // ---- DTP1 fused with the alpha/value product (R1: A1 then the piece buffer)
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[rr][j] = 0.f;
  float* A1 = R1;
  float* P1 = R1 + TR * c.nA1;
  attr_product(c, attr, row0, nrows, C1, c.nA1, A1);
  __syncthreads();
  dtp_product<true, true>(x1, nullptr, c.dim_in, row0, nrows, tb.pieces1, tb.terms1, c.np1, A1, c.nA1,
                                R0, c.numel1, P1, W_av, c.n_comb, acc);

  // ---- cmb = acc + b_av into R0 (w is dead)
  float* cmb = R0;
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      int col = lane + 32 * j;
      if (col < c.n_comb) cmb[(warp * RPT + rr) * c.n_comb + col] = acc[rr][j] + __ldg(b_av + col);
    }
  __syncthreads();

  // ---- logits = (SmoothLeakyReLU(cmb[:, :ma]) * norm) @ Dmat
  for (int e = tid; e < TR * c.H; e += NTHREADS) {
    int r = e / c.H, h = e - r * c.H;
    float s = 0.f;
    for (int m = 0; m < c.ma; ++m) {
      float x = cmb[r * c.n_comb + m];
      float la = (0.6f * x + 0.4f * x * tanhf(0.5f * x)) * c.sl_norm;
      s += la * __ldg(Dmat + m * c.H + h);
    }
    if (r < lg_rows) lg[(size_t)r * c.H + h] = s;
  }

  // ---- gate: mid (TR x mid_dim, i-major) into R1
  float* mid = R1;
  for (int e = tid; e < TR * c.mid_dim; e += NTHREADS) {
    int r = e / c.mid_dim, a = e - r * c.mid_dim;
    const float* cr = cmb + r * c.n_comb + c.ma;
    float v;
    if (a < c.sd) {
      float x = cr[a];
      v = x * sigmoidf_(x) * c.silu_norm;
    } else if (c.gd) {
      int t = a - c.sd;
      v = cr[c.sd + c.gd + t] * (sigmoidf_(cr[c.sd + __ldg(tb.gate_idx + t)]) * c.sig_norm);
    } else {
      v = cr[a];
    }
    mid[r * c.mid_dim + a] = v;
  }
  __syncthreads();

  // ---- DTP2 fused with the value product (R0: A2 then the piece buffer)
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[rr][j] = 0.f;
  float* A2 = R0;
  float* P2 = R0 + TR * c.nA2;
  attr_product(c, attr, row0, nrows, C2, c.nA2, A2);
  __syncthreads();
  dtp_product<false, false>(nullptr, mid, c.mid_dim, row0, nrows, tb.pieces2, tb.terms2,
                                   c.np2, A2, c.nA2, nullptr, 0, P2, W2, c.attn, acc);
}

}  // namespace edge
