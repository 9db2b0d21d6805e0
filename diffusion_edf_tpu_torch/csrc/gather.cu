// Transpose of a constant-table gather along the last axis, for NVIDIA
// Hopper (sm_90a): the backward of nn/gather.py::gather_last.
//
//   out(r, i) = sum over k in [ptr(i), ptr(i + 1)) of g(r, lanes(k)),  k ascending
//
// Replaces no TPU kernel: the JAX package leaves the backward of its gathers
// to XLA.  Autograd's own backward of index_select is zeros + index_add_, a
// float atomic scatter; in tp.apply_dtp_cm some 33 positions of a row read
// each column, so every atomic address is hit ~33 times from one row, and
// that scatter ran at ~3 % of the bandwidth bound (PERF.md); in
// IrrepsLinear's weight assembly nine positions in ten read the one zero
// element.  The table is a constant, so its inverse (ptr, lanes: CSR, built
// once on the host) turns the scatter into a fixed sum with no atomics.
//
// What bounds it: bytes.  Of each row of g, the kept positions are read
// once (a partial table's left-out ones not at all: 41 % of apply_dtp_cm's
// X and C positions are kept, 9 % of IrrepsLinear's largest row), and each
// row of out written once; the CSR (up to a few hundred KB) is read by
// every row from L2.  A single row (IrrepsLinear's: up to 551,936 positions
// into 28,673 columns, ~0.65 MB) is bound by the launch's latency instead.
//
// What the design does about it:
// * One thread per output column of one row, consecutive threads on
//   consecutive columns: the reads of ptr and the writes of out are
//   coalesced, and a row's columns / NTHREADS blocks run side by side.
//   Rows follow one another in a 1-D grid, so a single long row is about
//   one wave on 132 SMs and thousands of short ones are many.
// * Each thread reads its segment's lanes and the gradient at them straight
//   from device memory (a row of a few KB stays in L1 and L2 while its
//   block sums it) and sums them in ascending order: no atomics, no shared
//   memory, the same result on every run.
// * An empty segment gives 0.  That is how the tables of apply_dtp_cm's
//   coefficient gather and of IrrepsLinear treat their zero column, which
//   collects every missing term: that column's gradient is discarded (by
//   pad's and by cat's backward), so the table leaves the segment empty and
//   the kernel writes 0 without summing.
//
// Why no shared-memory staging: a kernel that staged whole rows with
// cp.async reads the left-out positions too.  On the train steps' shapes it
// was slower on every partial table and every grid of a few rows, and
// faster (up to 1.4 times) only on full tables of many rows, 0.04 ms of a
// 60-ms step (PERF.md).

namespace {

constexpr int NTHREADS = 256;

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
gather_last_t_kernel(const T* __restrict__ g, const int* __restrict__ ptr, const int* __restrict__ lanes,
                     T* __restrict__ out, int P, int width, int col_blocks) {
  const int row = blockIdx.x / col_blocks;
  const int col = (blockIdx.x - row * col_blocks) * NTHREADS + threadIdx.x;
  if (col >= width) return;
  const T* src = g + (long long)row * P;
  T acc = 0;
  const int k1 = __ldg(ptr + col + 1);
  for (int k = __ldg(ptr + col); k < k1; ++k) acc += __ldg(src + __ldg(lanes + k));
  out[(long long)row * width + col] = acc;
}

template <typename T>
int launch(const void* g, const int* ptr, const int* lanes, void* out, int rows, int P, int width,
           cudaStream_t stream) {
  const int col_blocks = (width + NTHREADS - 1) / NTHREADS;
  gather_last_t_kernel<T><<<(unsigned)((long long)col_blocks * rows), NTHREADS, 0, stream>>>(
      static_cast<const T*>(g), ptr, lanes, static_cast<T*>(out), P, width, col_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// g (rows, P) and out (rows, width), contiguous, of elements of elem_bytes bytes (4: float, 8: double); ptr
// (width + 1) and lanes (ptr[width]) int32.  Returns 0, a cudaError, or -1 for another element size.
extern "C" int gather_last_t_launch(const void* g, const int* ptr, const int* lanes, void* out, int rows, int P,
                                    int width, int elem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4) return launch<float>(g, ptr, lanes, out, rows, P, width, s);
  if (elem_bytes == 8) return launch<double>(g, ptr, lanes, out, rows, P, width, s);
  return -1;
}
