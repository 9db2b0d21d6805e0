// Fused per-edge segment of GraphAttention for NVIDIA Hopper (sm_90a).
//
// Replaces: the JAX package's nn/edge_kernel.py::edge_kernel_call, the
// Pallas TPU kernel (pl.pallas_call body: _radial_fwd + _core), and its
// transposed variant _call_transposed (_radial_fwd_t + _core_t): the float32
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
// edge scalars in; logits, val out), so it is bound by operations; on the
// tensor cores, where an f32-accurate product is three TF32 products, the
// two sides come within a factor of two of each other.  On the model's own
// inputs about one row in ten is valid (the radius scales pad to their caps),
// so the work that counts is that of the rows the mask keeps.
//
// Both kernels run edge_segment_mma() of edge_segment_mma.cuh on tiles of 64
// rows, a block of four warpgroups a tile, the weights staged through shared
// memory by cp.async:
// * edge_kernel_f32: both products as 3xTF32 wgmma, Y1 @ W_av without the
//   promotion Y2 @ W2 gets (its truncation leaves about 1e-5 in logits and
//   val, well inside the 3e-4 tolerance; PERF.md §6).  Given a mask, it
//   computes only the rows the mask keeps: compact_kernel (compact.cuh, one
//   block, no host synchronisation) lists them in order, and a tile is 64
//   consecutive entries of the list, its outputs written back to their rows.
//   The grid is sized for every row valid; every block first writes zeros to
//   the dropped rows of its own range of 64 rows, then leaves at once if its
//   tile starts past the end of the list.  Without a mask, tile b is rows
//   64 b ... 64 b + 63.
// * edge_kernel_mixed (bf16 message and W_av): Y1 @ W_av as bf16 wgmma with
//   f32 accumulation, Y2 @ W2 as 3xTF32; every row.  Every DTP1 piece keeps
//   the mixed mode's roundings; only the order of the product's f32 sum
//   differs from the plain version.

#include "compact.cuh"
#include "edge_segment_mma.cuh"

namespace {

using namespace edge_mma;

// float32, every row (mask null) or the rows the mask keeps through the list
// `slots` of count[0] entries.
template <int NC1, int NC2>
__global__ void __launch_bounds__(NTHREADS, 1)
edge_kernel_f32(Cfg c, const float* __restrict__ x1, const float* __restrict__ attr, const float* __restrict__ es,
                const unsigned char* __restrict__ mask, const int* __restrict__ slots, const int* __restrict__ count,
                Operands op, const float* __restrict__ b2, float* __restrict__ logits, float* __restrict__ val) {
  extern __shared__ __align__(128) char smem[];
  const int tid = threadIdx.x;
  const int pos0 = blockIdx.x * TR;
  if (mask != nullptr) {  // the dropped rows of rows pos0 ... pos0 + 63
    const int n = min(TR, c.rows - pos0);
    for (int e = tid; e < n * c.H; e += NTHREADS)
      if (!mask[pos0 + e / c.H]) logits[(size_t)pos0 * c.H + e] = 0.f;
    for (int e = tid; e < n * c.attn; e += NTHREADS)
      if (!mask[pos0 + e / c.attn]) val[(size_t)pos0 * c.attn + e] = 0.f;
  }
  const int total = mask != nullptr ? __ldg(count) : c.rows;
  if (pos0 >= total) return;
  const int nrows = min(TR, total - pos0);
  int* src = reinterpret_cast<int*>(smem + c.oMisc);
  float* lg = reinterpret_cast<float*>(src + TR);
  for (int r = tid; r < TR; r += NTHREADS)
    src[r] = r >= nrows ? -1 : mask != nullptr ? __ldg(slots + pos0 + r) : pos0 + r;
  __syncthreads();

  float acc[NC2 / 2];
  edge_segment_mma<NC1, NC2, false>(c, smem, src, x1, attr, es, op, lg, acc);
  for (int e = tid; e < TR * c.H; e += NTHREADS) {
    const int r = e / c.H;
    if (src[r] >= 0) logits[(size_t)src[r] * c.H + (e - r * c.H)] = lg[e];
  }
  for_each_acc<NC2>(acc, [&](int r, int col, float v) {
    if (src[r] >= 0 && col < c.attn) val[(size_t)src[r] * c.attn + col] = v + __ldg(b2 + col);
  });
}

// The mixed mode: x1 and val bf16, W1 the bf16 chunk images of W_av^T.
template <int NC1, int NC2>
__global__ void __launch_bounds__(NTHREADS, 1)
edge_kernel_mixed(Cfg c, const __nv_bfloat16* __restrict__ x1, const float* __restrict__ attr,
                  const float* __restrict__ es, Operands op, const float* __restrict__ b2,
                  float* __restrict__ logits, __nv_bfloat16* __restrict__ val) {
  extern __shared__ __align__(128) char smem_mma[];
  int* src = reinterpret_cast<int*>(smem_mma + c.oMisc);
  float* lg = reinterpret_cast<float*>(src + TR);
  const int row0 = blockIdx.x * TR;
  for (int r = threadIdx.x; r < TR; r += NTHREADS) src[r] = row0 + r < c.rows ? row0 + r : -1;
  __syncthreads();
  float acc[NC2 / 2];
  edge_segment_mma<NC1, NC2, true>(c, smem_mma, src, x1, attr, es, op, lg, acc);
  for (int e = threadIdx.x; e < TR * c.H; e += NTHREADS)
    if (src[e / c.H] >= 0) logits[(size_t)row0 * c.H + e] = lg[e];
  // a thread holds pairs of neighbouring columns: one 4-byte store each
  for_each_acc<NC2>(acc, [&](int r, int col, float v) {
    if (src[r] >= 0 && col < c.attn)
      val[(size_t)(row0 + r) * c.attn + col] = __float2bfloat16_rn(v + __ldg(b2 + col));
  });
}

// scratch: rows + 3 ints (the list, then rowptr[0 .. 1] and one counter of compact_kernel).
template <int NC1, int NC2>
int launch_f32(const Cfg& c, const float* x1, const float* attr, const float* es, const unsigned char* mask,
               const Operands& op, const float* b2, float* logits, float* val, int* scratch, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(edge_kernel_f32<NC1, NC2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         c.total);
  if (err != cudaSuccess) return (int)err;
  const int* count = nullptr;  // rowptr[1]: the length of the list
  if (mask != nullptr) {
    compact_kernel<<<1, SCAN_THREADS, 0, stream>>>(mask, 1, c.rows, scratch, scratch + c.rows, scratch + c.rows + 2,
                                                   nullptr, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    count = scratch + c.rows + 1;
  }
  const int grid = (c.rows + TR - 1) / TR;
  edge_kernel_f32<NC1, NC2><<<grid, NTHREADS, c.total, stream>>>(c, x1, attr, es, mask, scratch, count, op, b2,
                                                                 logits, val);
  return (int)cudaGetLastError();
}

template <int NC1, int NC2>
int launch_mixed(const Cfg& c, const void* x1, const float* attr, const float* es, const Operands& op,
                 const float* b2, float* logits, void* val, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(edge_kernel_mixed<NC1, NC2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         c.total);
  if (err != cudaSuccess) return (int)err;
  const int grid = (c.rows + TR - 1) / TR;
  edge_kernel_mixed<NC1, NC2><<<grid, NTHREADS, c.total, stream>>>(
      c, (const __nv_bfloat16*)x1, attr, es, op, b2, logits, (__nv_bfloat16*)val);
  return (int)cudaGetLastError();
}

}  // namespace

// float32.  cfg: the NCFG ints of edge_segment_mma.cuh.  mask: one byte a
// row, or null for every row; scratch: rows + 3 ints, written before it is
// read (unused without a mask).  Returns cudaGetLastError(), or -1 for widths
// the kernel has no instantiation for or a tile that does not fit the shared
// memory (then nothing was launched).
extern "C" int edge_kernel_f32_launch(const int* cfg, float sl_norm, float silu_norm, float sig_norm,
                                      const float* x1, const float* attr, const float* es, const unsigned char* mask,
                                      const int* meta, const float* radh, const float* Rw, const float* Rb,
                                      const float* W1, const float* b_av, const float* Dmat, const float* W2,
                                      const float* b2, const float* C1, const float* C2, float* logits, float* val,
                                      int* scratch, void* stream) {
  Cfg c;
  if (!make_cfg(cfg, sl_norm, silu_norm, sig_norm, false, 0, c)) return -1;
  const Operands op{meta, radh, Rw, Rb, W1, b_av, Dmat, W2, C1, C2};
  cudaStream_t s = (cudaStream_t)stream;
#define F32_LAUNCH(A, B) launch_f32<A, B>(c, x1, attr, es, mask, op, b2, logits, val, scratch, s)
  if (c.npad1 == 352 && c.npad2 == 256) return F32_LAUNCH(88, 64);
  if (c.npad1 == 192 && c.npad2 == 128) return F32_LAUNCH(48, 32);
  if (c.npad1 == 64 && c.npad2 == 32) return F32_LAUNCH(16, 8);
#undef F32_LAUNCH
  return -1;
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
  Cfg c;
  if (!make_cfg(cfg, sl_norm, silu_norm, sig_norm, true, 0, c)) return -1;
  const Operands op{meta, radh, Rw, Rb, W1, b_av, Dmat, W2, C1, C2};
  cudaStream_t s = (cudaStream_t)stream;
  if (c.npad1 == 352 && c.npad2 == 256) return launch_mixed<88, 64>(c, x1, attr, es, op, b2, logits, val, s);
  if (c.npad1 == 192 && c.npad2 == 128) return launch_mixed<48, 32>(c, x1, attr, es, op, b2, logits, val, s);
  if (c.npad1 == 64 && c.npad2 == 32) return launch_mixed<16, 8>(c, x1, attr, es, op, b2, logits, val, s);
  return -1;
}
