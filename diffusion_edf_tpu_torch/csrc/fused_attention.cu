// Fused edge attention of GraphAttention for NVIDIA Hopper (sm_90a): the
// per-edge segment, the masked softmax over the K neighbour slots of every
// destination row and the head-expanded weighted sum, in one launch.
//
// Replaces: the JAX package's nn/fused_attention.py::_pallas_core, the Pallas
// TPU kernel whose body is core_math.
//
// Per destination row n, over its K slots k:
//   logits(k, h), val(k, f) = the edge segment (edge_segment.cuh), the radial
//                             MLP from the raw edge scalars included
//   l = mask ? logits + pre : -1e30;  m = max(max_k l, -0.5e30)
//   ea = mask ? exp(l - m) : 0;  alpha = ea / max(sum_k ea, 0.5) * post
//   out(n, f) = sum_k alpha(k, h(f)) * val(k, f)
// A masked slot contributes exactly 0 and a row with every slot masked gives
// 0 (the 0.5 floor on the denominator), as in core_math.
//
// What bounds it: the same two folded products as the edge kernel (about 1.9
// MFLOP a slot at the flagship's width) against the slot's inputs only, since
// neither logits nor val reach device memory (val alone is K x attn floats a
// row, 200 KB at K = 208): operations, in f32.
//
// What the design does about it: K is walked in tiles of 32 slots.  A tile
// goes through edge_segment, which leaves its logits in shared memory and its
// val in registers; the softmax is kept online across tiles as a running max
// and denominator per head and attn running sums per destination row,
// rescaled when the max moves.  Lane f uses the alpha of its own head h(f),
// so no (H, attn) tensor exists.  The last tile is padded inside the kernel.
// With few destination rows (64 at the tensor field) one block a row would
// leave half the card idle, so the tiles of a row are dealt to `nsplit`
// blocks; each writes its (max, denominator, sums) to scratch and the block
// that finishes last (a counter per row) combines them in split order, so
// the result does not depend on the order of arrival.

#include "edge_segment.cuh"

namespace {

using namespace edge;

constexpr int MAXH = 8;  // heads the softmax state is sized for

__global__ void __launch_bounds__(NTHREADS)
fused_attention_kernel(Cfg c, int K, int nsplit, const float* __restrict__ x1, const float* __restrict__ attr,
                       const float* __restrict__ es, const unsigned char* __restrict__ mask,
                       const float* __restrict__ pre, const float* __restrict__ post,
                       const int* __restrict__ meta, const float* __restrict__ rad,
                       const float* __restrict__ W_av, const float* __restrict__ b_av,
                       const float* __restrict__ Dmat, const float* __restrict__ W2,
                       const float* __restrict__ b2, const float* __restrict__ C1,
                       const float* __restrict__ C2, const int* __restrict__ head_of_col,
                       float* __restrict__ out, float* part, int* counters) {
  extern __shared__ float smem[];
  float* R0 = smem;
  float* R1 = smem + c.r0;
  float* lg = R1 + c.r1;      // TR x H: logits, then exp(l - m)
  float* pw = lg + TR * c.H;  // TR x H: exp(l - m) * post
  __shared__ float m_run[MAXH], l_run[MAXH], scale[MAXH];
  __shared__ int is_last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.x, split = blockIdx.y;
  const int H = c.H;
  const int ntiles = (K + TR - 1) / TR;
  const Tables tb = split_tables(c, meta);

  if (tid < H) {
    m_run[tid] = -0.5e30f;
    l_run[tid] = 0.f;
  }
  float o[MAXJ];
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) o[j] = 0.f;
  float acc[RPT][MAXJ];

  for (int t = split; t < ntiles; t += nsplit) {
    const int k0 = t * TR;
    const int nrows = min(TR, K - k0);
    const size_t row0 = (size_t)n * K + k0;
    edge_segment<float>(c, R0, R1, (int)row0, nrows, x1, attr, es, tb, rad, W_av, b_av, Dmat, W2, C1, C2,
                        lg, TR, acc);
    // l = mask ? logits + pre : -1e30
    for (int e = tid; e < TR * H; e += NTHREADS) {
      int r = e / H;
      bool valid = r < nrows && mask[row0 + r] != 0;
      float v = lg[e];
      if (pre != nullptr && valid) v += __ldg(pre + row0 + r);
      lg[e] = valid ? v : -1e30f;
    }
    __syncthreads();
    if (tid < H) {
      float mt = m_run[tid];
      for (int r = 0; r < TR; ++r) mt = fmaxf(mt, lg[r * H + tid]);
      scale[tid] = expf(m_run[tid] - mt);
      m_run[tid] = mt;
    }
    __syncthreads();
    for (int e = tid; e < TR * H; e += NTHREADS) {
      int r = e / H, h = e - r * H;
      bool valid = r < nrows && mask[row0 + r] != 0;
      float p = valid ? expf(lg[e] - m_run[h]) : 0.f;
      lg[e] = p;
      pw[e] = (post != nullptr && valid) ? p * __ldg(post + row0 + r) : p;
    }
    __syncthreads();
    if (tid < H) {
      float s = 0.f;
      for (int r = 0; r < TR; ++r) s += lg[r * H + tid];
      l_run[tid] = l_run[tid] * scale[tid] + s;
    }
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      int col = lane + 32 * j;
      if (col < c.attn) {
        const int h = __ldg(head_of_col + col);
        const float b = __ldg(b2 + col);
        float a = o[j] * scale[h];
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) a = fmaf(pw[(warp * RPT + rr) * H + h], acc[rr][j] + b, a);
        o[j] = a;
      }
    }
    __syncthreads();
  }

  // ---- sum the four warps' partial sums (R0 is free: every tile ended on a barrier)
  float* red = R0;
#pragma unroll
  for (int j = 0; j < MAXJ; ++j) {
    int col = lane + 32 * j;
    if (col < c.attn) red[warp * c.attn + col] = o[j];
  }
  __syncthreads();
  if (nsplit == 1) {
    for (int col = tid; col < c.attn; col += NTHREADS) {
      float s = 0.f;
      for (int w = 0; w < NWARP; ++w) s += red[w * c.attn + col];
      out[(size_t)n * c.attn + col] = s / fmaxf(l_run[__ldg(head_of_col + col)], 0.5f);
    }
    return;
  }

  // ---- split rows: publish (max, denominator, sums); the last block of the row combines
  const int stride = 2 * H + c.attn;
  float* mine = part + ((size_t)n * nsplit + split) * stride;
  if (tid < H) {
    mine[tid] = m_run[tid];
    mine[H + tid] = l_run[tid];
  }
  for (int col = tid; col < c.attn; col += NTHREADS) {
    float s = 0.f;
    for (int w = 0; w < NWARP; ++w) s += red[w * c.attn + col];
    mine[2 * H + col] = s;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + n, 1) == nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* row = part + (size_t)n * nsplit * stride;
  for (int col = tid; col < c.attn; col += NTHREADS) {
    const int h = __ldg(head_of_col + col);
    float M = -0.5e30f;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, __ldcg(row + s * stride + h));
    float L = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(__ldcg(row + s * stride + h) - M);
      L = fmaf(__ldcg(row + s * stride + H + h), w, L);
      a = fmaf(__ldcg(row + s * stride + 2 * H + col), w, a);
    }
    out[(size_t)n * c.attn + col] = a / fmaxf(L, 0.5f);
  }
}

}  // namespace

// cfg: 21 ints in the order of Cfg up to mid_dim, cfg[0] = Nd * K.  mask is
// one byte a slot; pre and post may be null.  part holds Nd * nsplit *
// (2 * H + attn) floats and counters Nd zeroed ints when nsplit > 1.
// Returns cudaGetLastError().
extern "C" int fused_attention_launch(const int* cfg, float sl_norm, float silu_norm, float sig_norm, int Nd, int K,
                                      int nsplit, const float* x1, const float* attr, const float* es,
                                      const unsigned char* mask, const float* pre, const float* post,
                                      const int* meta, const float* rad, const float* W_av, const float* b_av,
                                      const float* Dmat, const float* W2, const float* b2, const float* C1,
                                      const float* C2, const int* head_of_col, float* out, float* part,
                                      int* counters, void* stream) {
  const edge::Cfg c = edge::make_cfg(cfg, sl_norm, silu_norm, sig_norm);
  if (c.H > MAXH) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(c.r0 + c.r1 + 2 * edge::TR * c.H);
  cudaError_t err =
      cudaFuncSetAttribute(fused_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Nd, nsplit);
  fused_attention_kernel<<<grid, edge::NTHREADS, smem, (cudaStream_t)stream>>>(
      c, K, nsplit, x1, attr, es, mask, pre, post, meta, rad, W_av, b_av, Dmat, W2, b2, C1, C2, head_of_col, out,
      part, counters);
  return (int)cudaGetLastError();
}
