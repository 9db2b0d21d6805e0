// Transpose of a constant-table gather along the last axis, for NVIDIA
// Hopper (sm_90a): the backward of nn/gather.py::gather_last.
//
//   out(r, i) = sum over k in [ptr(i), ptr(i + 1)) of g(r, lanes(k)),  k ascending
//
// Replaces no TPU kernel: the JAX package leaves the backward of its gathers
// to XLA.  Autograd's own backward of index_select is zeros + index_add_, a
// float atomic scatter; in tp.apply_dtp_cm some 33 positions of a row read
// each column, so every atomic address is hit ~33 times from one row, and
// that scatter ran at ~3 % of the bandwidth bound (PERF.md).  The table is
// a constant, so its inverse (ptr, lanes: CSR, built once on the host) turns
// the scatter into a fixed sum with no atomics.
//
// What bounds it: bytes.  Each row of g (P elements) is read once and each
// row of out (width elements) written once; the CSR (a few tens of KB) is
// read by every block from L1 and L2.
//
// What the design does about it:
// * A block takes ROWS consecutive rows of g, one contiguous stretch of
//   memory, and stages it in shared memory with 16-byte cp.async copies, all
//   in flight at once (the elements before the first 16-byte boundary and
//   after the last are copied one by one).  ROWS is chosen so that a block
//   stages ~64 KB: three blocks share an SM, and one block's copies run
//   under another's sums.
// * Then each thread takes one output column for a group of up to RPT rows
//   and sums the column's segment from shared memory in ascending order, one
//   read of lanes(k) serving the RPT rows: no atomics, the same order on
//   every run.  Consecutive threads take consecutive columns, so the writes
//   of out are coalesced.
// * An empty segment gives 0.  That is how the table of apply_dtp_cm's
//   coefficient gather treats its zero column, which collects every missing
//   term: that column's gradient is discarded by pad's backward, so its
//   table leaves the segment empty and the kernel writes 0 without summing.

#include <algorithm>

#include "wgmma.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int RPT = 4;                  // rows a thread sums at once
constexpr int STAGE_BYTES = 64 * 1024;  // what a block stages: three blocks an SM
constexpr int MAX_SMEM = 232448;        // the most dynamic shared memory a block may have (227 KB)

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
gather_last_t_kernel(const T* __restrict__ g, const int* __restrict__ ptr, const int* __restrict__ lanes,
                     T* __restrict__ out, int rows, int P, int width, int rows_per_block) {
  extern __shared__ __align__(16) char smem[];
  T* s = reinterpret_cast<T*>(smem);
  constexpr int VEC = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, rows - r0);
  const int n = nrows * P;
  const T* src = g + (long long)r0 * P;
  // element e of the stretch lands at s[shift + e]: a 16-byte boundary of g meets one of shared memory
  const int shift = (int)((reinterpret_cast<uintptr_t>(src) / sizeof(T)) % VEC);
  const int head = min(n, (VEC - shift) % VEC);
  const int nvec = (n - head) / VEC;
  for (int e = tid; e < head; e += NTHREADS) s[shift + e] = __ldg(src + e);
  for (int v = tid; v < nvec; v += NTHREADS) wg::cp_async16(s + shift + head + v * VEC, src + head + v * VEC);
  wg::cp_async_commit();
  for (int e = head + nvec * VEC + tid; e < n; e += NTHREADS) s[shift + e] = __ldg(src + e);
  wg::cp_async_wait_all();
  __syncthreads();

  const int groups = (nrows + RPT - 1) / RPT;
  for (int item = tid; item < groups * width; item += NTHREADS) {
    const int grp = item / width, col = item - grp * width;
    const int live = min(RPT, nrows - grp * RPT);
    const T* row = s + shift + grp * RPT * P;
    T acc[RPT] = {};
    const int k1 = __ldg(ptr + col + 1);
    for (int k = __ldg(ptr + col); k < k1; ++k) {
      const int lane = __ldg(lanes + k);
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        if (j < live) acc[j] += row[j * P + lane];
    }
    T* o = out + (long long)(r0 + grp * RPT) * width + col;
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (j < live) o[(long long)j * width] = acc[j];
  }
}

template <typename T>
int launch(const void* g, const int* ptr, const int* lanes, void* out, int rows, int P, int width,
           cudaStream_t stream) {
  const long long row_bytes = (long long)P * sizeof(T);
  int rpb = (int)std::max(1LL, STAGE_BYTES / row_bytes);
  if (rpb > RPT) rpb -= rpb % RPT;  // whole groups of RPT rows
  const long long bytes = rpb * row_bytes + 16;  // + the shift of the first element
  if (bytes > MAX_SMEM) return -1;
  cudaError_t err =
      cudaFuncSetAttribute(gather_last_t_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = (rows + rpb - 1) / rpb;
  gather_last_t_kernel<T><<<grid, NTHREADS, bytes, stream>>>(static_cast<const T*>(g), ptr, lanes,
                                                             static_cast<T*>(out), rows, P, width, rpb);
  return (int)cudaGetLastError();
}

}  // namespace

// g (rows, P) and out (rows, width), contiguous, of elements of elem_bytes bytes (4: float, 8: double); ptr
// (width + 1) and lanes (ptr[width]) int32.  Returns 0, a cudaError, or -1 where a row exceeds shared memory.
extern "C" int gather_last_t_launch(const void* g, const int* ptr, const int* lanes, void* out, int rows, int P,
                                    int width, int elem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4) return launch<float>(g, ptr, lanes, out, rows, P, width, s);
  if (elem_bytes == 8) return launch<double>(g, ptr, lanes, out, rows, P, width, s);
  return -1;
}
