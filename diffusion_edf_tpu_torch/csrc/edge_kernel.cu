// Fused per-edge segment of GraphAttention for NVIDIA Hopper (sm_90a).
//
// Replaces: the JAX package's nn/edge_kernel.py::edge_kernel_call, the
// Pallas TPU kernel (pl.pallas_call body: _radial_fwd + _core), and its
// transposed variant _call_transposed (_radial_fwd_t + _core_t): the f32
// kernel serves both (the transpose only fixes a TPU lane layout), the mixed
// kernel is the transposed kernel's selective bfloat16 precision.
//
// Per edge row: radial MLP, DTP1, merged alpha/value linear, GATv2 logits,
// gate, DTP2, value linear.  Outputs: logits (rows, H) f32 and val (rows,
// attn), f32 or bf16.
//
// What bounds it: the two folded products cost 2*L1*Ncomb + 2*L2*attn flops a
// row (at the flagship's width L1 = L2 = 1568, Ncomb = 352, attn = 240: about
// 1.9 MFLOP) against about 2.5 KB of device-memory traffic a row (x1, attr,
// edge scalars in; logits, val out), so it is bound by operations, ~750
// flops per byte in f32; in the mixed mode the row's traffic falls to about
// 1.4 KB.
//
// Two kernels:
// * edge_kernel (f32): a block owns a tile of 32 rows and runs
//   edge_segment() of edge_segment.cuh: plain f32 FMA on the CUDA cores, the
//   weights streamed from L2.
// * edge_kernel_mixed (bf16 message and W_av): a block of four warpgroups owns
//   a tile of 64 rows and runs edge_segment_mma() of edge_segment_mma.cuh:
//   Y1 @ W_av as bf16 wgmma with f32 accumulation, Y2 @ W2 and the radial
//   MLP's last layer as 3xTF32 wgmma, the weights staged through shared
//   memory with cp.async.  Every DTP1 piece keeps the mixed mode's roundings;
//   only the order of the product's f32 sum differs from the CUDA-core
//   version it replaces.

#include "edge_segment.cuh"
#include "edge_segment_mma.cuh"

namespace {

using namespace edge;

__global__ void __launch_bounds__(NTHREADS)
edge_kernel(Cfg c, const float* __restrict__ x1, const float* __restrict__ attr,
            const float* __restrict__ es, const int* __restrict__ meta,
            const float* __restrict__ rad, const float* __restrict__ W_av,
            const float* __restrict__ b_av, const float* __restrict__ Dmat,
            const float* __restrict__ W2, const float* __restrict__ b2,
            const float* __restrict__ C1, const float* __restrict__ C2,
            float* __restrict__ logits, float* __restrict__ val) {
  extern __shared__ float smem[];
  float* R0 = smem;
  float* R1 = smem + c.r0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * TR;
  const int nrows = min(TR, c.rows - row0);
  const Tables tb = split_tables(c, meta);

  float acc[RPT][MAXJ];
  edge_segment(c, R0, R1, row0, nrows, x1, attr, es, tb, rad, W_av, b_av, Dmat, W2, C1, C2,
                  logits + (size_t)row0 * c.H, nrows, acc);

#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    int r = warp * RPT + rr;
    if (r < nrows) {
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        int col = lane + 32 * j;
        if (col < c.attn) val[(size_t)(row0 + r) * c.attn + col] = acc[rr][j] + __ldg(b2 + col);
      }
    }
  }
}

// The mixed mode: x1 and val bf16, W1 the bf16 chunk images of W_av^T.
template <int NC1, int NC2>
__global__ void __launch_bounds__(edge_mma::NTHREADS, 1)
edge_kernel_mixed(edge_mma::Cfg c, const __nv_bfloat16* __restrict__ x1, const float* __restrict__ attr,
                  const float* __restrict__ es, edge_mma::Operands op, const float* __restrict__ b2,
                  float* __restrict__ logits, __nv_bfloat16* __restrict__ val) {
  extern __shared__ __align__(128) char smem_mma[];
  int* src = reinterpret_cast<int*>(smem_mma + c.oMisc);
  float* lg = reinterpret_cast<float*>(src + edge_mma::TR);
  const int row0 = blockIdx.x * edge_mma::TR;
  for (int r = threadIdx.x; r < edge_mma::TR; r += edge_mma::NTHREADS) src[r] = row0 + r < c.rows ? row0 + r : -1;
  __syncthreads();
  float acc[NC2 / 2];
  edge_mma::edge_segment_mma<NC1, NC2, true>(c, smem_mma, src, x1, attr, es, op, lg, acc);
  for (int e = threadIdx.x; e < edge_mma::TR * c.H; e += edge_mma::NTHREADS)
    if (src[e / c.H] >= 0) logits[(size_t)row0 * c.H + e] = lg[e];
  // a thread holds pairs of neighbouring columns: one 4-byte store each
  edge_mma::for_each_acc<NC2>(acc, [&](int r, int col, float v) {
    if (src[r] >= 0 && col < c.attn)
      val[(size_t)(row0 + r) * c.attn + col] = __float2bfloat16_rn(v + __ldg(b2 + col));
  });
}

template <int NC1, int NC2>
int launch_mixed(const edge_mma::Cfg& c, const void* x1, const float* attr, const float* es,
                 const edge_mma::Operands& op, const float* b2, float* logits, void* val, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(edge_kernel_mixed<NC1, NC2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         c.total);
  if (err != cudaSuccess) return (int)err;
  const int grid = (c.rows + edge_mma::TR - 1) / edge_mma::TR;
  edge_kernel_mixed<NC1, NC2><<<grid, edge_mma::NTHREADS, c.total, stream>>>(
      c, (const __nv_bfloat16*)x1, attr, es, op, b2, logits, (__nv_bfloat16*)val);
  return (int)cudaGetLastError();
}

}  // namespace

// cfg: 21 ints in the order of Cfg up to mid_dim.  Returns cudaGetLastError().
// x1, W_av and val are float.
extern "C" int edge_kernel_launch(const int* cfg, float sl_norm, float silu_norm, float sig_norm,
                                  const float* x1, const float* attr, const float* es, const int* meta,
                                  const float* rad, const float* W_av, const float* b_av,
                                  const float* Dmat, const float* W2, const float* b2,
                                  const float* C1, const float* C2, float* logits, float* val,
                                  void* stream) {
  const Cfg c = make_cfg(cfg, sl_norm, silu_norm, sig_norm);
  const size_t smem = sizeof(float) * (size_t)(c.r0 + c.r1);
  cudaError_t err = cudaFuncSetAttribute(edge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (c.rows + TR - 1) / TR;
  edge_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(c, x1, attr, es, meta, rad, W_av, b_av, Dmat, W2, b2,
                                                              C1, C2, logits, val);
  return (int)cudaGetLastError();
}

// Selective bf16: x1 and val are __nv_bfloat16; the weights are the operands
// of edge_segment_mma.cuh (cfg: its NCFG ints).  Returns cudaGetLastError(),
// or -1 for widths the kernel has no instantiation for or a tile that does
// not fit the shared memory.
extern "C" int edge_kernel_bf16_launch(const int* cfg, float sl_norm, float silu_norm, float sig_norm,
                                       const void* x1, const float* attr, const float* es, const int* meta,
                                       const float* radh, const float* Rw, const float* Rb, const void* W1,
                                       const float* b_av, const float* Dmat, const float* W2, const float* b2,
                                       const float* C1, const float* C2, float* logits, void* val,
                                       void* stream) {
  edge_mma::Cfg c;
  if (!edge_mma::make_cfg(cfg, sl_norm, silu_norm, sig_norm, true, 0, c)) return -1;
  const edge_mma::Operands op{meta, radh, Rw, Rb, W1, b_av, Dmat, W2, C1, C2};
  cudaStream_t s = (cudaStream_t)stream;
  if (c.npad1 == 352 && c.npad2 == 256) return launch_mixed<88, 64>(c, x1, attr, es, op, b2, logits, val, s);
  if (c.npad1 == 192 && c.npad2 == 128) return launch_mixed<48, 32>(c, x1, attr, es, op, b2, logits, val, s);
  if (c.npad1 == 64 && c.npad2 == 32) return launch_mixed<16, 8>(c, x1, attr, es, op, b2, logits, val, s);
  return -1;
}
