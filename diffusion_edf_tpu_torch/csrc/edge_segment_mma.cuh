// The per-edge segment of GraphAttention on Hopper's tensor cores (sm_90a):
// the device code of every edge kernel of the port.  It serves the float32
// edge kernel and the mixed bfloat16 edge kernel (edge_kernel.cu) and the
// fused attention kernel (fused_attention.cu).
//
// Per edge row: radial MLP, A1 = attr @ C1, DTP1, merged alpha / value
// linear, logits, gate, A2, DTP2, value linear; for one tile of 64 edge rows
// taken through a list of source rows, by a block of four warpgroups (512
// threads, at most 128 registers each).  How, and why:
//
// * Both folded products run on wgmma.  Y1 @ W_av: with BF16, bf16 operands
//   and f32 accumulation (m64n64k16), which is exactly the mixed mode's
//   contract (products of bf16 values are exact in f32); else at f32
//   accuracy as 3xTF32 (m64n64k8; x = hi + lo, a_lo b_hi + a_hi b_lo +
//   a_hi b_hi, the dropped a_lo b_lo is 2^-22 relative).  Y2 @ W2 is 3xTF32
//   in both.  The four warpgroups share the 64 rows and split the output
//   columns (a quarter each, 88 and 64 at the tensor field, one wgmma per
//   step); the accumulators stay in registers, and sixteen warps instead of
//   eight run the parts that stay on the CUDA cores.  The tensor cores add into an f32 accumulator by
//   truncation, which over the 588 additions of a 3xTF32 product at the
//   tensor field's depth pulls the sum 3.5e-5 low; Y2 @ W2, whose result the
//   mixed mode rounds to bf16, therefore takes every chunk into a fresh
//   accumulator that the CUDA cores add up (round to nearest).
// * The weights are staged, not streamed: the host stores W^T (and its hi /
//   lo TF32 parts, split once) padded and cut into chunks of 16 lanes of
//   depth, each chunk already in the shared-memory image wgmma reads
//   (wgmma.cuh), so one chunk is one contiguous block that all threads copy
//   with cp.async into a ring of two stages: the copy of chunk c + 1 runs
//   under the products of chunk c, and every staged element serves 64 rows.
// * The lanes of Y are the DTP's pieces laid end to end (every piece padded
//   to a multiple of 8 lanes), cut into chunks of 16 lanes whatever the
//   pieces' widths.  The host resolves every group of 8 lanes into one
//   record of 16 ints (where its x lanes start, its terms, where its radial
//   weights lie), kept in shared memory, so a thread reaches its operands in
//   one hop, and the x values of the next chunk are fetched from device
//   memory under the products of this one.  A thread
//   builds two elements of a chunk (one row x two lanes) and writes them
//   into the chunk's A image (hi and lo, or bf16); the wgmmas of chunk c run
//   while the threads build chunk c + 1.
// * The per-edge radial weights (64 x 480 floats at the tensor field) never
//   exist whole.  The radial MLP's last layer is computed in blocks of 64 of
//   its columns, each when the chunks first need it (the pieces come in the
//   order of their weight blocks), into a ring of two blocks in shared
//   memory: 2 rows x 4 columns a thread on the CUDA cores in f32, under the
//   wgmmas of the chunk just started.  The hidden layers use the same routine.
//
// Shared memory (bytes; tensor field: dim_in 240, n_comb 352, attn 240, nA
// 129, hid 64, S 128 / extractor: dim_in 120, n_comb 176, attn 120, hid 16):
//   A    64 x (nA | 1) floats: A1, later A2                   33,024 / 33,024
//   Y    2 stages x (64 x 16 hi + lo)                         16,384 / 16,384
//   B    the larger of 2 weight stages (npad x 16 x 4 x 2),
//        cmb (64 x (n_comb | 1)), the radial scratch and,
//        in the attention kernel, val (64 x (attn | 1))       90,368 / 49,152
//   RH   h (64 x (hid + 1) floats) + 2 blocks of w (64 x 66);
//        later mid (64 x 242 / 64 x 122 floats) over both      61,952 / 38,144
//   G    the group records of the DTP in hand (2 x chunks x 64) 12,544 / 6,272
//   misc source rows, logits, the attr tile                    3,584 /  3,584
//   total                                                    217,856 / 146,560
// (the same in the mixed mode at the tensor field: cmb is the largest there).  The
// launcher computes the same sums and refuses a launch over 232,448 bytes.
#pragma once

#include "wgmma.cuh"

namespace edge_mma {

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// Round to bf16 (nearest even) and hold the result as a float.
__device__ __forceinline__ float rbf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

constexpr int TR = 64;          // rows per tile
constexpr int NTHREADS = 512;   // four warpgroups
constexpr int NWG = NTHREADS / 128;
constexpr int KC = 16;          // Y lanes per chunk
constexpr int Y_STAGE = TR * KC * 4 * 2;  // bytes: hi and lo images
constexpr int WB = 64;          // columns of the radial MLP's last layer per block
constexpr int WB_LD = WB + 2;    // even, so a lane pair is 8-byte aligned; half of it odd, so rows fall on different banks
constexpr int GREC = 16;        // ints per group record
constexpr int MAXTERMS = GREC - 5;
constexpr int MAXSH = 16;       // widest edge attribute
constexpr int SMEM_LIMIT = 232448;
constexpr int NCFG = 20;

struct Cfg {
  int rows, dim_in, dim_sh, S, nA1, nA2, nchunk1, nchunk2;
  int n_comb, ma, sd, gd, td, H, attn, n_rad, hid, wmax, mid_dim, wcols;
  float sl_norm, silu_norm, sig_norm;
  int npad1, npad2;                        // rows of the W^T images: the columns padded to a multiple of 32
  int ldA, ldh, cmb_ld, mid_ld, val_ld;
  int stage1, stage2;                      // bytes of one staged chunk: W_av, W2
  int oA, oY, oB, oRH, oW, oG, oMisc, total;  // byte offsets of the shared regions
};

inline int align128(int x) { return (x + 127) & ~127; }
inline int imax(int a, int b) { return a > b ? a : b; }

// cfg: NCFG ints in the order of Cfg up to wcols.  False when the shapes are
// not ones the kernels take or the shared memory does not fit.
inline bool make_cfg(const int* cfg, float sl_norm, float silu_norm, float sig_norm, bool bf16, int static_bytes,
                     Cfg& c) {
  int* f = &c.rows;
  for (int i = 0; i < NCFG; ++i) f[i] = cfg[i];
  c.sl_norm = sl_norm, c.silu_norm = silu_norm, c.sig_norm = sig_norm;
  c.npad1 = 32 * ((c.n_comb + 31) / 32);
  c.npad2 = 32 * ((c.attn + 31) / 32);
  c.ldA = imax(imax(c.nA1, c.nA2), c.ma + 1) | 1;
  c.ldh = c.wmax + 1;
  c.cmb_ld = c.n_comb | 1;
  c.mid_ld = (c.mid_dim + 1) / 2 * 2;  // even (lane pairs are read 8 bytes at a time), half of it odd
  if (c.mid_ld / 2 % 2 == 0) c.mid_ld += 2;
  c.val_ld = c.attn | 1;
  c.stage1 = c.npad1 * KC * (bf16 ? 2 : 8);
  c.stage2 = c.npad2 * KC * 8;
  const int bB = imax(imax(2 * c.stage1, 2 * c.stage2),
                      imax(imax(TR * c.cmb_ld * 4, 2 * TR * c.ldh * 4), TR * c.val_ld * 4));
  const int bH = align128(TR * (c.hid + 1) * 4);
  const int bRH = imax(bH + 2 * TR * WB_LD * 4, TR * c.mid_ld * 4);
  c.oA = 0;
  c.oY = c.oA + align128(TR * c.ldA * 4);
  c.oB = c.oY + 2 * Y_STAGE;
  c.oRH = c.oB + align128(bB);
  c.oW = c.oRH + bH;
  c.oG = c.oRH + align128(bRH);
  c.oMisc = c.oG + 2 * imax(c.nchunk1, c.nchunk2) * GREC * 4;
  c.total = c.oMisc + align128(TR * 4 + TR * c.H * 4 + TR * c.dim_sh * 4);
  return c.hid <= c.wmax && c.wcols % WB == 0 && c.dim_sh <= MAXSH && c.total + static_bytes <= SMEM_LIMIT;
}

// The device operands of one plan, as mma_operands() of nn/edge_kernel.py builds them.
struct Operands {
  const int* meta;     // int32 tables: group records of DTP1 and DTP2, radial blocks per chunk, gates, radial widths
  const float* radh;   // hidden radial layers: W, b, LN scale, LN shift each
  const float* Rw;     // last radial layer (hid, wcols), its columns padded to a multiple of 64
  const float* Rb;     // its offset (wcols)
  const void* W1;      // W_av^T chunk images: [nchunk1][hi|lo][4][npad1][4] f32 or [nchunk1][2][npad1][8] bf16
  const float* b_av;
  const float* Dmat;
  const float* W2;     // W2^T chunk images [nchunk2][hi|lo][4][npad2][4]
  const float* C1;
  const float* C2;
};

// The int32 tables of one plan, as the host packs them (_mma_tables).  A
// group record: [0] the x lane of the group's first element for i = 0, [1]
// how many of its 8 lanes are real (even), [2] the number of terms, [3] the
// radial weight column of its first element (-1: unweighted), [4] the last
// block of radial weights its chunk reads, [5..] per term (i * mul) << 16 |
// A column.  x lanes and weight columns of a group's first element are even.
struct Tables {
  const int *groups1, *groups2, *gate_idx, *rdims;
};

__device__ __forceinline__ Tables split_tables(const Cfg& c, const int* __restrict__ meta) {
  Tables t;
  t.groups1 = meta;
  t.groups2 = t.groups1 + 2 * GREC * c.nchunk1;
  t.gate_idx = t.groups2 + 2 * GREC * c.nchunk2;
  t.rdims = t.gate_idx + (c.gd ? c.td : 0);
  return t;
}

// Two neighbouring lanes (the first even) in one load.
__device__ __forceinline__ float2 ldx2(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }
__device__ __forceinline__ float2 ldx2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Calls f(r, col, value) for every accumulator element of `acc` (NC columns a warpgroup).
template <int NC, typename F>
__device__ __forceinline__ void for_each_acc(const float (&acc)[NC / 2], F f) {
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NC / 2; ++i)
    f(16 * warp + g + 8 * ((i >> 1) & 1), wgi * NC + 8 * (i >> 2) + 2 * t + (i & 1), acc[i]);
}

// out[r, col] = sum_k h[r, k] * W[k, col] + bias[col] for the TR rows and
// ncols columns (a multiple of 4; W rows 16-byte aligned): 2 rows x 4 columns
// a thread, the weights read 16 bytes at a time.
__device__ __forceinline__ void dense_2x4(const float* h, int ldh, int din, const float* __restrict__ W, int ldw,
                                          int ncols, const float* __restrict__ bias, float* out, int ldo) {
  const int ncg = ncols >> 2;
  for (int e = threadIdx.x; e < (TR / 2) * ncg; e += NTHREADS) {
    const int tr = e / ncg, col = (e - tr * ncg) * 4;
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < din; ++k) {
      const float4 wv = __ldg(reinterpret_cast<const float4*>(W + (size_t)k * ldw + col));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float hv = h[(tr + 32 * i) * ldh + k];
        s[i][0] += hv * wv.x, s[i][1] += hv * wv.y, s[i][2] += hv * wv.z, s[i][3] += hv * wv.w;
      }
    }
    const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + col));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* d = out + (tr + 32 * i) * ldo + col;
      d[0] = s[i][0] + bv.x, d[1] = s[i][1] + bv.y, d[2] = s[i][2] + bv.z, d[3] = s[i][3] + bv.w;
    }
  }
}

// Block `b` of the radial MLP's last layer, w[:, 64 b : 64 b + 64] = h @ Rw + Rb,
// into its place in the ring of two.
__device__ __forceinline__ void radial_block(const Cfg& c, char* smem, const float* __restrict__ Rw,
                                             const float* __restrict__ Rb, int b) {
  dense_2x4(reinterpret_cast<const float*>(smem + c.oRH), c.hid + 1, c.hid, Rw + b * WB, c.wcols, WB, Rb + b * WB,
            reinterpret_cast<float*>(smem + c.oW) + (b & 1) * TR * WB_LD, WB_LD);
}

// A = attr tile @ C  (TR x nA) into dst (row stride ldA): a thread keeps one
// column of C in registers and takes 8 rows through it.
template <bool ROUND_BF16>
__device__ __forceinline__ void attr_product(const Cfg& c, const float* at, const float* __restrict__ C, int nA,
                                             float* dst) {
  for (int e = threadIdx.x; e < 8 * nA; e += NTHREADS) {
    const int rq = e / nA, col = e - rq * nA;
    float cc[MAXSH];
#pragma unroll
    for (int j = 0; j < MAXSH; ++j) cc[j] = j < c.dim_sh ? __ldg(C + j * nA + col) : 0.f;
    for (int r = 8 * rq; r < 8 * rq + 8; ++r) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < MAXSH; ++j)
        if (j < c.dim_sh) s += at[r * c.dim_sh + j] * cc[j];
      dst[r * c.ldA + col] = ROUND_BF16 ? rbf(s) : s;
    }
  }
}

// acc = Y @ W^T over all chunks of one DTP, where Y's lanes are built chunk
// by chunk from the group records: Y(r, lane) = sum_t x(r, x lane_t) * A(r, c_t)
// (* w(r, weight column)), w from the ring of radial blocks (WEIGHTED).  A
// thread builds one row x two lanes of a chunk, its two lanes read as one
// pair; its x row comes from device memory (`xrow`) or from `xs` in shared
// memory.  With BF16 every product and sum of a piece is rounded to bf16, Y
// is staged as bf16 and the product is a single bf16 wgmma; else Y is staged
// as TF32 hi and lo and the product is 3xTF32.  Warpgroup wgi owns the NC
// columns from wgi * NC.  The tensor cores add into their f32 accumulator by
// truncation, so a long run of wgmmas on one accumulator drifts low (588
// additions at the tensor field: 3.5e-5 relative).  With PROMOTE every
// chunk's products go into a fresh accumulator that the CUDA cores add to
// `acc` (round to nearest) once the chunk is complete; it costs a second set
// of registers.  Ends with every wgmma complete (not on a barrier).
//
// Measurement only (tools/torch_kernel_phases.py builds such variants, whose
// results are wrong): EDGE_MMA_SKIP_BUILD, _SKIP_COPY, _SKIP_PRODUCTS and
// _SKIP_RADIAL each leave one phase of the chunk loop out.
template <int NC, bool WEIGHTED, bool BF16, bool PROMOTE, typename XT>
__device__ __forceinline__ void dtp_mma(const Cfg& c, char* smem, const XT* __restrict__ xrow, const float* xs,
                                        const int* __restrict__ groups, int nchunk,
                                        const float* A, const float* __restrict__ Rw,
                                        const float* __restrict__ Rb, const char* __restrict__ W, int stage_bytes,
                                        int npad, float (&acc)[NC / 2]) {
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = 16 * warp + g + 8 * (wgi >> 1);  // the tile row this thread builds
  const int cl = 8 * (wgi & 1) + 2 * t;            // and the first of its two lanes of a chunk
  char* sY = smem + c.oY;
  char* sB = smem + c.oB;
  const float* sW = reinterpret_cast<const float*>(smem + c.oW) + row * WB_LD;
  const float* aRow = A + row * c.ldA;
  // the DTP's group records go to shared memory; rec: this thread's group of chunk 0
  int4* sG = reinterpret_cast<int4*>(smem + c.oG);
  for (int e = tid; e < 2 * nchunk * (GREC / 4); e += NTHREADS) sG[e] = __ldg(reinterpret_cast<const int4*>(groups) + e);
  const int4* rec = sG + (wgi & 1) * (GREC / 4);
  float part[NC / 2];  // PROMOTE: the accumulator of the chunk in flight
  auto promote = [&]() {  // the chunk in flight is complete: add it to acc
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) {
      wg::keep(part[i]);
      acc[i] += part[i];
    }
  };
  // the products of one chunk (operands in stage `st`) into d, on top of what d holds or afresh;
  // a descriptor counts in units of 16 bytes, so a step in depth or a stage is an addition
  const uint64_t dY = wg::tile_desc(wg::smem_u32(sY), TR, 0, 0);
  const uint64_t dB = wg::tile_desc(wg::smem_u32(sB), npad, wgi * NC, 0);
  auto start_products = [&](float (&d)[NC / 2], int st, int accumulate) {
    const uint64_t y0 = dY + (uint64_t)(st * (Y_STAGE >> 4)), b0 = dB + (uint64_t)(st * (stage_bytes >> 4));
    if (BF16) {
      wg::mma_bf16<NC>(d, y0, b0, accumulate);
    } else {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint64_t yh = y0 + (uint64_t)(ks * 2 * TR), yl = yh + (uint64_t)(TR * KC * 4 >> 4);
        const uint64_t bh = b0 + (uint64_t)(ks * 2 * npad), bl = bh + (uint64_t)(npad * KC * 4 >> 4);
        wg::mma_tf32<NC>(d, yl, bh, accumulate || ks > 0);
        wg::mma_tf32<NC>(d, yh, bl, 1);
        wg::mma_tf32<NC>(d, yh, bh, 1);
      }
    }
  };
  if (PROMOTE) {
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  }

  // the x values of a group's first four terms, fetched a chunk ahead (device memory is far)
  float2 xp[4];
  auto fetch_x = [&](const int4& r0, const int4& r1, const int4& r2) {
    const int xb = r0.x + 2 * t;
    const int tm[4] = {r1.y, r1.z, r1.w, r2.x};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int xi = xb + (tm[j] >> 16);
      xp[j] = make_float2(0.f, 0.f);
      if (2 * t < r0.y) xp[j] = xs == nullptr ? ldx2(xrow + xi) : *reinterpret_cast<const float2*>(xs + xi);
    }
  };

  // ---- prologue: W(0) starts; the radial blocks of chunk 0; the first group record and its x
  wg::cp_async_block(sB, W, stage_bytes, tid, NTHREADS);
  wg::cp_async_commit();
  int have = -1;  // radial blocks computed so far
  if (WEIGHTED) {
    for (const int need = __ldg(groups + 4); have < need;) radial_block(c, smem, Rw, Rb, ++have);
  }
  __syncthreads();
  int4 q0 = rec[0], q1 = rec[1], q2 = rec[2], q3 = rec[3];
  fetch_x(q0, q1, q2);
  for (int ch = 0; ch < nchunk; ++ch) {
    // ---- build the thread's two elements of Y: lanes cl, cl + 1 of the chunk in its row
    // (the products of chunk ch - 1 may still run)
    float y[2] = {0.f, 0.f};
#ifndef EDGE_MMA_SKIP_BUILD
    {
      const int xb = q0.x + 2 * t, nt = q0.z;
      const bool v = 2 * t < q0.y;
      const int tm[12] = {q1.y, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w, q3.x, q3.y, q3.z, q3.w, 0};
#pragma unroll
      for (int k0 = 0; k0 < 12; k0 += 4) {  // four terms at a time: their loads are in flight together
        if (k0 < nt) {
          float2 xv[4];
          float a[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int xi = xb + (tm[k0 + j] >> 16);
            a[j] = aRow[tm[k0 + j] & 0xFFFF];
            if (k0 == 0) {
              xv[j] = xp[j];
            } else {
              xv[j] = make_float2(0.f, 0.f);
              if (v) xv[j] = xs == nullptr ? ldx2(xrow + xi) : *reinterpret_cast<const float2*>(xs + xi);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (k0 + j < nt) {
              if (BF16) {
                const float t0 = rbf(__fmul_rn(xv[j].x, a[j])), t1 = rbf(__fmul_rn(xv[j].y, a[j]));
                y[0] = k0 + j == 0 ? t0 : rbf(__fadd_rn(y[0], t0));
                y[1] = k0 + j == 0 ? t1 : rbf(__fadd_rn(y[1], t1));
              } else {
                y[0] += xv[j].x * a[j];
                y[1] += xv[j].y * a[j];
              }
            }
          }
        }
      }
      if (WEIGHTED) {
        float2 w = make_float2(0.f, 0.f);
        if (v) w = *reinterpret_cast<const float2*>(sW + ((q0.w >> 6) & 1) * TR * WB_LD + (q0.w & (WB - 1)) + 2 * t);
        y[0] = BF16 ? rbf(__fmul_rn(y[0], rbf(w.x))) : y[0] * w.x;
        y[1] = BF16 ? rbf(__fmul_rn(y[1], rbf(w.y))) : y[1] * w.y;
      }
    }
#endif
    // the next chunk's group record; its x values set out now and land under what follows
    if (ch + 1 < nchunk) {
      rec += 2 * (GREC / 4);
      q0 = rec[0], q1 = rec[1], q2 = rec[2], q3 = rec[3];
      fetch_x(q0, q1, q2);
    }
    {
      char* st = sY + (ch & 1) * Y_STAGE + row * 16;
      if (BF16) {
        *reinterpret_cast<__nv_bfloat162*>(st + (cl >> 3) * (TR * 16) + (cl & 7) * 2) = __floats2bfloat162_rn(y[0], y[1]);
      } else {
        float hi[2], lo[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) wg::split_tf32(y[q], hi[q], lo[q]);
        char* d = st + (cl >> 2) * (TR * 16) + (cl & 3) * 4;
        *reinterpret_cast<float2*>(d) = make_float2(hi[0], hi[1]);
        *reinterpret_cast<float2*>(d + TR * KC * 4) = make_float2(lo[0], lo[1]);
      }
    }

    // ---- the products of chunk ch - 1 are complete and W(ch) has landed; W(ch + 1) starts
    wg::wait<0>();
    if (PROMOTE && ch > 0) promote();
    wg::cp_async_wait_all();
    wg::fence_async_smem();
    __syncthreads();
#ifndef EDGE_MMA_SKIP_COPY
    if (ch + 1 < nchunk) {
      wg::cp_async_block(sB + ((ch + 1) & 1) * stage_bytes, W + (size_t)(ch + 1) * stage_bytes, stage_bytes, tid,
                         NTHREADS);
      wg::cp_async_commit();
    }
#endif
    // ---- start the products of chunk ch: this warpgroup's NC columns in one wgmma per step
#ifndef EDGE_MMA_SKIP_PRODUCTS
    wg::fence();
    if (PROMOTE) start_products(part, ch & 1, 0);
    else start_products(acc, ch & 1, ch > 0);
    wg::commit();
#endif
    // ---- under them: the radial blocks the next chunk reads first (every thread is past its
    // reads of the block they replace)
    if (WEIGHTED && ch + 1 < nchunk) {
      const int need = q1.x;  // of chunk ch + 1, whose record is in hand
      if (have < need) {
#ifndef EDGE_MMA_SKIP_RADIAL
        while (have < need) radial_block(c, smem, Rw, Rb, ++have);
#else
        have = need;
#endif
        __syncthreads();
      }
    }
  }
  wg::wait<0>();
  if (PROMOTE) {
    promote();
  } else {
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) wg::keep(acc[i]);
  }
}

// One tile through the whole segment.  src (shared, TR ints) names the
// source row of every tile row, -1 for none; the caller has filled it and
// synchronised.  The logits of tile row r go to lg[r * H + h] (shared); acc2
// returns val without its bias in the accumulator layout of wgmma.cuh:
// warpgroup wgi holds columns wgi * NC2 ... + NC2 - 1 (NC1, NC2: a quarter of
// the padded widths of cmb and val).  Ends on a block-wide barrier.
template <int NC1, int NC2, bool BF16, typename XT>
__device__ __forceinline__ void edge_segment_mma(const Cfg& c, char* smem, const int* src,
                                                 const XT* __restrict__ x1, const float* __restrict__ attr,
                                                 const float* __restrict__ es, const Operands& op, float* lg,
                                                 float (&acc2)[NC2 / 2]) {
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2;
  const int row = 16 * warp + g + 8 * (wgi >> 1);  // the tile row whose Y lanes this thread builds
  const Tables tb = split_tables(c, op.meta);
  float* sA = reinterpret_cast<float*>(smem + c.oA);
  float* at = lg + TR * c.H;  // the attr tile (TR x dim_sh); rows without a source are zero
  // ---- the attr tile; radial MLP, hidden layers: ping-pong in the B region
  for (int e = tid; e < TR * c.dim_sh; e += NTHREADS) {
    const int r = e / c.dim_sh;
    at[e] = src[r] >= 0 ? __ldg(attr + (size_t)src[r] * c.dim_sh + (e - r * c.dim_sh)) : 0.f;
  }
  {
    float* hin = reinterpret_cast<float*>(smem + c.oB);
    float* hout = hin + TR * c.ldh;
    for (int e = tid; e < TR * c.S; e += NTHREADS) {
      const int r = e / c.S, k = e - r * c.S;
      hin[r * c.ldh + k] = src[r] >= 0 ? __ldg(es + (size_t)src[r] * c.S + k) : 0.f;
    }
    __syncthreads();
    const float* rp = op.radh;
    for (int l = 0; l + 1 < c.n_rad; ++l) {
      const int din = __ldg(tb.rdims + l), dout = __ldg(tb.rdims + l + 1);
      const float* Wl = rp;
      const float* bl = rp + din * dout;
      const float* scale = bl + dout;
      const float* shift = scale + dout;
      rp = shift + dout;
      dense_2x4(hin, c.ldh, din, Wl, dout, dout, bl, hout, c.ldh);
      __syncthreads();
      for (int r = tid >> 5; r < TR; r += NTHREADS / 32) {
        float s = 0.f, ss = 0.f;
        for (int o = lane; o < dout; o += 32) {
          const float v = hout[r * c.ldh + o];
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
          const float v = (hout[r * c.ldh + o] - mu) * inv * __ldg(scale + o) + __ldg(shift + o);
          hout[r * c.ldh + o] = v * sigmoidf_(v);
        }
      }
      __syncthreads();
      float* tmp = hin;
      hin = hout;
      hout = tmp;
    }
    // the last hidden activations move out of the B region
    float* sH = reinterpret_cast<float*>(smem + c.oRH);
    for (int e = tid; e < TR * c.hid; e += NTHREADS) {
      const int r = e / c.hid, k = e - r * c.hid;
      sH[r * (c.hid + 1) + k] = hin[r * c.ldh + k];
    }
  }
  // ---- A1 = attr @ C1
  attr_product<BF16>(c, at, op.C1, c.nA1, sA);
  __syncthreads();

  // ---- DTP1 with the alpha / value product
  {
    float acc1[NC1 / 2];
    // a tile row without a source reads row 0: its A1 is zero, so its Y is
    const XT* xrow = x1 + (size_t)max(src[row], 0) * c.dim_in;
    dtp_mma<NC1, true, BF16, false, XT>(c, smem, xrow, nullptr, tb.groups1, c.nchunk1, sA, op.Rw, op.Rb,
                                        reinterpret_cast<const char*>(op.W1), c.stage1, c.npad1, acc1);
    __syncthreads();  // every warpgroup is done with the weight stages: cmb goes over them
    float* cmb = reinterpret_cast<float*>(smem + c.oB);
    for_each_acc<NC1>(acc1, [&](int r, int col, float v) {
      if (col < c.n_comb) cmb[r * c.cmb_ld + col] = v + __ldg(op.b_av + col);
    });
  }
  __syncthreads();
  // ---- la = SmoothLeakyReLU(cmb[:, :ma]) * norm over the dead A1; gate: mid (i-major) over h and the w blocks
  const float* cmb = reinterpret_cast<const float*>(smem + c.oB);
  float* la = sA;
  for (int e = tid; e < TR * c.ma; e += NTHREADS) {
    const int r = e / c.ma, m = e - r * c.ma;
    const float x = cmb[r * c.cmb_ld + m];
    la[r * (c.ma + 1) + m] = (0.6f * x + 0.4f * x * tanhf(0.5f * x)) * c.sl_norm;
  }
  float* mid = reinterpret_cast<float*>(smem + c.oRH);
  for (int e = tid; e < TR * c.mid_dim; e += NTHREADS) {
    const int r = e / c.mid_dim, a = e - r * c.mid_dim;
    const float* cr = cmb + r * c.cmb_ld + c.ma;
    float v;
    if (a < c.sd) {
      const float x = cr[a];
      v = x * sigmoidf_(x) * c.silu_norm;
    } else if (c.gd) {
      const int k = a - c.sd;
      v = cr[c.sd + c.gd + k] * (sigmoidf_(cr[c.sd + __ldg(tb.gate_idx + k)]) * c.sig_norm);
    } else {
      v = cr[a];
    }
    mid[r * c.mid_ld + a] = v;
  }
  __syncthreads();
  // ---- logits = la @ Dmat
  for (int e = tid; e < TR * c.H; e += NTHREADS) {
    const int r = e / c.H, h = e - r * c.H;
    float s = 0.f;
    for (int m = 0; m < c.ma; ++m) s += la[r * (c.ma + 1) + m] * __ldg(op.Dmat + m * c.H + h);
    lg[e] = s;
  }
  __syncthreads();
  // ---- A2 = attr @ C2 (la is dead)
  attr_product<false>(c, at, op.C2, c.nA2, sA);
  __syncthreads();
  // ---- DTP2 with the value product
  dtp_mma<NC2, false, false, true, float>(c, smem, nullptr, mid + row * c.mid_ld, tb.groups2, c.nchunk2, sA,
                                          nullptr, nullptr, reinterpret_cast<const char*>(op.W2), c.stage2, c.npad2,
                                          acc2);
  __syncthreads();
}

}  // namespace edge_mma
