// Fused edge attention of GraphAttention for NVIDIA Hopper (sm_90a): the
// per-edge segment, the masked softmax over the K neighbour slots of every
// destination row and the head-expanded weighted sum.
//
// Replaces: the JAX package's nn/fused_attention.py::_pallas_core, the Pallas
// TPU kernel whose body is core_math.
//
// Per destination row n, over its K slots k:
//   logits(k, h), val(k, f) = the edge segment, the radial MLP from the raw
//                             edge scalars included
//   l = mask ? logits + pre : -1e30;  m = max(max_k l, -0.5e30)
//   ea = mask ? exp(l - m) : 0;  alpha = ea / max(sum_k ea, 0.5) * post
//   out(n, f) = sum_k alpha(k, h(f)) * val(k, f)
// A masked slot contributes exactly 0 and a row with every slot masked gives
// exactly 0, as in core_math.
//
// What bounds it: the two folded products of the segment (about 1.9 MFLOP a
// slot at the flagship's width) on the slots the mask keeps, against every
// slot's inputs; neither logits nor val reach device memory.  On the model's
// own inputs one slot in ten is valid (the radius scales pad to their caps),
// so the work that counts is a tenth of the slots'.
//
// What the design does about it:
// * Only valid slots are computed.  compact_kernel (compact.cuh: one block,
//   no host synchronisation) takes a prefix sum over the mask and writes the
//   list of valid slots in order, the position in that list at which every
//   destination row starts, and zeroes the output and the row counters.
// * attention_kernel takes 64 consecutive entries of the list as one tile
//   through edge_segment_mma() (edge_segment_mma.cuh: both products as
//   3xTF32 wgmma, weights staged by cp.async), gathering x1, attr, the edge
//   scalars, pre and post through the list.  The grid is sized for every slot
//   valid; a block whose tile starts past the end of the list leaves at once.
// * A tile holds slots of several destination rows, in order.  The softmax
//   is taken per (destination row, head) over the row's run of tile rows
//   (its segment); val goes through shared memory and one thread per output
//   lane sums each segment.  A destination row whose valid slots lie in one
//   tile is written at once; one that spans tiles publishes (max,
//   denominator, sums) per tile, and the block that arrives last at the
//   row's counter combines the parts in tile order, so the result does not
//   depend on the order of arrival.  Rows without a valid slot keep the 0
//   that compact_kernel wrote.

#include "compact.cuh"
#include "edge_segment_mma.cuh"

namespace {

using namespace edge_mma;

constexpr int MAXH = 8;          // heads the softmax state is sized for
constexpr int STATIC_BYTES = 4 * (TR + 2 * (TR + 1) + 2 * TR * MAXH + 8);

template <int NC1, int NC2>
__global__ void __launch_bounds__(NTHREADS, 1)
attention_kernel(Cfg c, int Nd, int K, const float* __restrict__ x1, const float* __restrict__ attr,
                 const float* __restrict__ es, const float* __restrict__ pre, const float* __restrict__ post,
                 Operands op, const float* __restrict__ b2, const int* __restrict__ head_of_col,
                 const int* __restrict__ slots, const int* __restrict__ rowptr, float* __restrict__ out,
                 float* part, int* counters) {
  extern __shared__ __align__(128) char smem[];
  __shared__ int seg_row[TR], seg_lo[TR + 1], seg_tiles[TR + 1];  // destination row, first tile row, tiles it spans
  __shared__ float seg_m[TR * MAXH], seg_l[TR * MAXH];
  __shared__ int nseg_s, last_s[2];
  const int tid = threadIdx.x;
  const int total = __ldg(rowptr + Nd);
  const int pos0 = blockIdx.x * TR;
  if (pos0 >= total) return;
  const int nrows = min(TR, total - pos0);
  const int H = c.H;
  int* src = reinterpret_cast<int*>(smem + c.oMisc);
  float* lg = reinterpret_cast<float*>(src + TR);
  for (int r = tid; r < TR; r += NTHREADS) src[r] = r < nrows ? __ldg(slots + pos0 + r) : -1;
  __syncthreads();

  float acc[NC2 / 2];
  edge_segment_mma<NC1, NC2, false>(c, smem, src, x1, attr, es, op, lg, acc);

  // ---- val (+ b2) into shared memory over the dead weight stages; the tile's segments
  float* vs = reinterpret_cast<float*>(smem + c.oB);
  for_each_acc<NC2>(acc, [&](int r, int col, float v) {
    if (col < c.attn) vs[r * c.val_ld + col] = v + __ldg(b2 + col);
  });
  if (tid == 0) {
    int ns = 0;
    for (int r = 0; r < nrows; ++r) {
      const int n = src[r] / K;
      if (r == 0 || n != seg_row[ns - 1]) {
        seg_row[ns] = n;
        seg_lo[ns] = r;
        // the row's valid slots are positions [rowptr[n], rowptr[n + 1]) of the list
        seg_tiles[ns] = (__ldg(rowptr + n + 1) - 1) / TR - __ldg(rowptr + n) / TR + 1;
        ++ns;
      }
    }
    seg_lo[ns] = nrows;
    nseg_s = ns;
    last_s[0] = last_s[1] = 0;
  }
  __syncthreads();
  const int nseg = nseg_s;

  // ---- softmax per (segment, head): lg becomes exp(l - m) * post
  for (int e = tid; e < nseg * H; e += NTHREADS) {
    const int s = e / H, h = e - s * H;
    float m = -0.5e30f;
    for (int r = seg_lo[s]; r < seg_lo[s + 1]; ++r) {
      float l = lg[r * H + h];
      if (pre != nullptr) l += __ldg(pre + src[r]);
      lg[r * H + h] = l;
      m = fmaxf(m, l);
    }
    float sum = 0.f;
    for (int r = seg_lo[s]; r < seg_lo[s + 1]; ++r) {
      const float p = expf(lg[r * H + h] - m);
      sum += p;
      lg[r * H + h] = post != nullptr ? p * __ldg(post + src[r]) : p;
    }
    seg_m[e] = m;
    seg_l[e] = sum;
  }
  __syncthreads();

  // ---- weighted sums per segment, one thread per output lane.  A segment whose
  // destination row lies in this tile alone is final; else it is one part of its row:
  // part 0 of the tile when the row began in an earlier tile, part 1 when it begins here.
  const int stride = 2 * H + c.attn;
  for (int f = tid; f < c.attn; f += NTHREADS) {
    const int h = __ldg(head_of_col + f);
    for (int s = 0; s < nseg; ++s) {
      float o = 0.f;
      for (int r = seg_lo[s]; r < seg_lo[s + 1]; ++r) o = fmaf(lg[r * H + h], vs[r * c.val_ld + f], o);
      const int n = seg_row[s];
      if (seg_tiles[s] == 1) {
        out[(size_t)n * c.attn + f] = o / fmaxf(seg_l[s * H + h], 0.5f);
      } else {
        const int which = __ldg(rowptr + n) < pos0 ? 0 : 1;
        part[((size_t)blockIdx.x * 2 + which) * stride + 2 * H + f] = o;
      }
    }
  }
  for (int e = tid; e < nseg * H; e += NTHREADS) {
    const int s = e / H, h = e - s * H;
    if (seg_tiles[s] > 1) {
      const int which = __ldg(rowptr + seg_row[s]) < pos0 ? 0 : 1;
      float* rec = part + ((size_t)blockIdx.x * 2 + which) * stride;
      rec[h] = seg_m[e];
      rec[H + h] = seg_l[e];
    }
  }
  __threadfence();
  __syncthreads();
  // only the first and the last segment of a tile can be parts of a longer row
  if (tid == 0) {
    for (int q = 0; q < 2; ++q) {
      const int s = q == 0 ? 0 : nseg - 1;
      if ((q == 0 || nseg > 1) && seg_tiles[s] > 1)
        last_s[q] = atomicAdd(counters + seg_row[s], 1) == seg_tiles[s] - 1;
    }
  }
  __syncthreads();
  for (int q = 0; q < 2; ++q) {
    if (!last_s[q]) continue;
    __threadfence();
    const int n = seg_row[q == 0 ? 0 : nseg - 1];
    const int start = __ldg(rowptr + n);
    const int t0 = start / TR, t1 = t0 + seg_tiles[q == 0 ? 0 : nseg - 1];
    for (int f = tid; f < c.attn; f += NTHREADS) {
      const int h = __ldg(head_of_col + f);
      float M = -0.5e30f;
      for (int tb = t0; tb < t1; ++tb)
        M = fmaxf(M, __ldcg(part + ((size_t)tb * 2 + (start < tb * TR ? 0 : 1)) * stride + h));
      float L = 0.f, a = 0.f;
      for (int tb = t0; tb < t1; ++tb) {
        const float* rec = part + ((size_t)tb * 2 + (start < tb * TR ? 0 : 1)) * stride;
        const float w = expf(__ldcg(rec + h) - M);
        L = fmaf(__ldcg(rec + H + h), w, L);
        a = fmaf(__ldcg(rec + 2 * H + f), w, a);
      }
      out[(size_t)n * c.attn + f] = a / fmaxf(L, 0.5f);
    }
  }
}

template <int NC1, int NC2>
int launch(const Cfg& c, int Nd, int K, const float* x1, const float* attr, const float* es, const float* pre,
           const float* post, const Operands& op, const float* b2, const int* head_of_col, const int* slots,
           const int* rowptr, float* out, float* part, int* counters, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(attention_kernel<NC1, NC2>, cudaFuncAttributeMaxDynamicSharedMemorySize, c.total);
  if (err != cudaSuccess) return (int)err;
  const int grid = (Nd * K + TR - 1) / TR;
  attention_kernel<NC1, NC2><<<grid, NTHREADS, c.total, stream>>>(c, Nd, K, x1, attr, es, pre, post, op, b2,
                                                                  head_of_col, slots, rowptr, out, part, counters);
  return (int)cudaGetLastError();
}

}  // namespace

// cfg: the NCFG ints of edge_segment_mma.cuh, cfg[0] = Nd * K.  mask is one
// byte a slot; pre and post may be null.  Scratch, all written before it is
// read: slots (Nd * K ints), rowptr (Nd + 1 ints), counters (Nd ints), part
// (ceil(Nd * K / 64) * 2 * (2 * H + attn) floats).  Returns
// cudaGetLastError(), or -1 for widths the kernel has no instantiation for or
// a tile that does not fit the shared memory.
extern "C" int fused_attention_launch(const int* cfg, float sl_norm, float silu_norm, float sig_norm, int Nd, int K,
                                      const float* x1, const float* attr, const float* es,
                                      const unsigned char* mask, const float* pre, const float* post,
                                      const int* meta, const float* radh, const float* Rw, const float* Rb,
                                      const float* W1, const float* b_av, const float* Dmat, const float* W2,
                                      const float* b2, const float* C1, const float* C2, const int* head_of_col,
                                      float* out, int* slots, int* rowptr, int* counters, float* part,
                                      void* stream) {
  Cfg c;
  if (!make_cfg(cfg, sl_norm, silu_norm, sig_norm, false, STATIC_BYTES, c) || c.H > MAXH) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  compact_kernel<<<1, SCAN_THREADS, 0, s>>>(mask, Nd, K, slots, rowptr, counters, out, Nd * c.attn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Operands op{meta, radh, Rw, Rb, W1, b_av, Dmat, W2, C1, C2};
#define ATTN_LAUNCH(A, B) \
  launch<A, B>(c, Nd, K, x1, attr, es, pre, post, op, b2, head_of_col, slots, rowptr, out, part, counters, s)
  if (c.npad1 == 352 && c.npad2 == 256) return ATTN_LAUNCH(88, 64);
  if (c.npad1 == 192 && c.npad2 == 128) return ATTN_LAUNCH(48, 32);
  if (c.npad1 == 64 && c.npad2 == 32) return ATTN_LAUNCH(16, 8);
#undef ATTN_LAUNCH
  return -1;
}
