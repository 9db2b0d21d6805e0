// The list of valid slots of a mask, for the kernels that compute only the
// slots a mask keeps (sm_90a): the float32 edge kernel (edge_kernel.cu) and
// the fused attention kernel (fused_attention.cu).  One block, no host
// synchronisation: the caller sizes its grid for every slot valid, and a
// block whose tile starts past the end of the list leaves at once.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int SCAN_THREADS = 1024;

// mask: Nd x K bytes.  slots: the flat indices of the valid slots in order;
// rowptr[n]: how many valid slots precede destination row n (rowptr[Nd] is
// their number); counters (Nd) and out (out_n floats) are zeroed.  The edge
// kernel passes Nd = 1 and K = rows: rowptr[1] is then the length of the list.
__global__ void __launch_bounds__(SCAN_THREADS)
compact_kernel(const unsigned char* __restrict__ mask, int Nd, int K, int* __restrict__ slots,
               int* __restrict__ rowptr, int* __restrict__ counters, float* __restrict__ out, int out_n) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = Nd * K;
  const int per = (N + SCAN_THREADS - 1) / SCAN_THREADS;
  const int lo = min(tid * per, N), hi = min(lo + per, N);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += mask[i] != 0;
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    warp_sum[lane] = v;  // inclusive over warps
  }
  __syncthreads();
  int pos = incl - cnt + (warp ? warp_sum[warp - 1] : 0);
  int n = lo / K, k = lo - n * K;
  for (int i = lo; i < hi; ++i) {
    if (k == 0) rowptr[n] = pos;
    if (mask[i] != 0) slots[pos++] = i;
    if (++k == K) k = 0, ++n;
  }
  if (tid == 0) rowptr[Nd] = warp_sum[SCAN_THREADS / 32 - 1];
  for (int i = tid; i < Nd; i += SCAN_THREADS) counters[i] = 0;
  for (int i = tid; i < out_n; i += SCAN_THREADS) out[i] = 0.f;
}

}  // namespace
