// Fused per-edge segment of GraphAttention for NVIDIA Hopper (sm_90a).
//
// Replaces: the JAX package's nn/edge_kernel.py::edge_kernel_call, the
// Pallas TPU kernel (pl.pallas_call body: _radial_fwd + _core), and its
// transposed variant _call_transposed (_radial_fwd_t + _core_t): the f32
// instantiation serves both (the transpose only fixes a TPU lane layout), the
// bf16 instantiation is the transposed kernel's selective mixed precision.
//
// Per edge row (edge_segment.cuh has the steps): radial MLP, DTP1, merged
// alpha/value linear, GATv2 logits, gate, DTP2, value linear.
// Outputs: logits (rows, H) f32 and val (rows, attn), f32 or bf16.
//
// What bounds it: the two folded products cost 2*L1*Ncomb + 2*L2*attn flops a
// row (at the flagship's width L1 = L2 = 1568, Ncomb = 352, attn = 240: about
// 1.9 MFLOP) against about 2.5 KB of device-memory traffic a row (x1, attr,
// edge scalars in; logits, val out), so in f32 it is bound by operations,
// ~750 flops per byte.  In bf16 the row's traffic falls to about 1.4 KB and
// the products still run as f32 FMAs, so operations bound it all the more.
//
// What the design does about it: see edge_segment.cuh.  A block owns a tile
// of 32 rows.  Plain f32 FMA in the products of both modes; tensor cores
// (wgmma) and TMA are left for later.

#include "edge_segment.cuh"

namespace {

using namespace edge;

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
edge_kernel(Cfg c, const T* __restrict__ x1, const float* __restrict__ attr,
            const float* __restrict__ es, const int* __restrict__ meta,
            const float* __restrict__ rad, const T* __restrict__ W_av,
            const float* __restrict__ b_av, const float* __restrict__ Dmat,
            const float* __restrict__ W2, const float* __restrict__ b2,
            const float* __restrict__ C1, const float* __restrict__ C2,
            float* __restrict__ logits, T* __restrict__ val) {
  extern __shared__ float smem[];
  float* R0 = smem;
  float* R1 = smem + c.r0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * TR;
  const int nrows = min(TR, c.rows - row0);
  const Tables tb = split_tables(c, meta);

  float acc[RPT][MAXJ];
  edge_segment<T>(c, R0, R1, row0, nrows, x1, attr, es, tb, rad, W_av, b_av, Dmat, W2, C1, C2,
                  logits + (size_t)row0 * c.H, nrows, acc);

#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    int r = warp * RPT + rr;
    if (r < nrows) {
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        int col = lane + 32 * j;
        if (col < c.attn) store_val(val + (size_t)(row0 + r) * c.attn + col, acc[rr][j] + __ldg(b2 + col));
      }
    }
  }
}

template <typename T>
int launch(const int* cfg, float sl_norm, float silu_norm, float sig_norm, const void* x1, const float* attr,
           const float* es, const int* meta, const float* rad, const void* W_av, const float* b_av,
           const float* Dmat, const float* W2, const float* b2, const float* C1, const float* C2,
           float* logits, void* val, void* stream) {
  const Cfg c = make_cfg(cfg, sl_norm, silu_norm, sig_norm);
  const size_t smem = sizeof(float) * (size_t)(c.r0 + c.r1);
  cudaError_t err = cudaFuncSetAttribute(edge_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (c.rows + TR - 1) / TR;
  edge_kernel<T><<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      c, (const T*)x1, attr, es, meta, rad, (const T*)W_av, b_av, Dmat, W2, b2, C1, C2, logits, (T*)val);
  return (int)cudaGetLastError();
}

}  // namespace

// cfg: 21 ints in the order of Cfg up to mid_dim.  Both return cudaGetLastError().
// f32: x1, W_av and val are float.
extern "C" int edge_kernel_launch(const int* cfg, float sl_norm, float silu_norm, float sig_norm,
                                  const void* x1, const float* attr, const float* es, const int* meta,
                                  const float* rad, const void* W_av, const float* b_av,
                                  const float* Dmat, const float* W2, const float* b2,
                                  const float* C1, const float* C2, float* logits, void* val,
                                  void* stream) {
  return launch<float>(cfg, sl_norm, silu_norm, sig_norm, x1, attr, es, meta, rad, W_av, b_av, Dmat, W2, b2,
                       C1, C2, logits, val, stream);
}

// Selective bf16: x1, W_av and val are __nv_bfloat16; every other operand and the logits are float.
extern "C" int edge_kernel_bf16_launch(const int* cfg, float sl_norm, float silu_norm, float sig_norm,
                                       const void* x1, const float* attr, const float* es, const int* meta,
                                       const float* rad, const void* W_av, const float* b_av,
                                       const float* Dmat, const float* W2, const float* b2,
                                       const float* C1, const float* C2, float* logits, void* val,
                                       void* stream) {
  return launch<__nv_bfloat16>(cfg, sl_norm, silu_norm, sig_norm, x1, attr, es, meta, rad, W_av, b_av, Dmat, W2,
                               b2, C1, C2, logits, val, stream);
}
