// Per-pillar sums of the kept LiDAR points, in a fixed order, written by hand
// for Hopper (sm_90a) and bound through a plain C interface (ctypes).
//
// Replaces no TPU kernel. The JAX package takes these sums as an XLA
// scatter-add (pixelspointspolygons_tpu/ops/voxelize.py, `segment_sum` in
// `assign_pillars`), which on the CPU adds each pillar's kept points one by
// one in sorted order. On the card PyTorch's `index_add_` adds them with
// atomics in no fixed order, so the centroids, the decorated features and
// every LiDAR and fusion output after them changed in their last bits from
// one call to the next. This kernel adds them in the CPU's order, so the
// card gives the CPU's bits, every time. The plain PyTorch version of the
// same function is pixelspointspolygons_torch/ops/voxelize.py::pillar_sums;
// the wrapper is ::pillar_sums_cuda.
//
// What it computes, for sample b and pillar p < n_cells, from the points
// pts (B, N, C) and pillar ids pid (B, N) int64 of `assign_pillars`, sorted
// by pillar id (a stable sort, so a pillar's points form one run in input
// order; ids of points outside the grid or padding are n_cells and come
// last):
//   - n = min(run length of p, cap);
//   - sums[b, p, k] = ((+0 + x_0k) + x_1k) + ... + x_(n-1)k over the run's
//     first n points, each add rounded to the points' type;
//   - counts[b, p] = n.
// The dump cell p = n_cells gets zeros. Types: float and double.
//
// What bounds it: bytes. Each kept coordinate is read once and added once
// (one add per 4 or 8 bytes), and each thread finds its run by two binary
// searches in its sample's ids (about 2 x 18 reads of 8 bytes). At the main
// path (16 clouds padded to 200,000 points, cap 64) the kept points are
// about 9 MB of the 38 MB of points; the padding rows are never read.
//
// Design: one thread per (sample, pillar, coordinate). It finds the run's
// start and end by binary search, then adds its coordinate of the run's
// first n points in order; neighbouring threads read neighbouring
// coordinates. The loop has no data-dependent exit, so loads can be issued
// ahead of the chain of adds. Nothing is shared between threads and no
// atomics are used: the result does not depend on scheduling. This is the
// simple form; a pillar pooled by one block, which the PFN of K6 needs, is
// later work (ROADMAP §2).
//
// Rounding. Compiled with --fmad=false, although only adds are involved:
// the sum is the plain version's, add for add. Starting from +0.0 and
// adding in order, the sum is never -0.0, so the plain version's extra
// adds of +0.0 (its empty slots) leave its bits unchanged.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// the first index in row[0, n) whose id is >= key (row sorted ascending)
__device__ __forceinline__ long long lower_bound(const int64_t* __restrict__ row, long long n, int64_t key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (row[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pillar_sums_kernel(const T* __restrict__ pts, const int64_t* __restrict__ pid, T* __restrict__ sums,
                       int32_t* __restrict__ counts, int B, long long N, int C, int n_cells, int cap) {
  const long long cells = (long long)n_cells + 1;
  const long long total = (long long)B * cells * C;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int k = (int)(i % C);
  const long long cell = i / C;  // b * cells + p
  const long long b = cell / cells;
  const int p = (int)(cell % cells);
  if (p == n_cells) {  // the dump cell
    sums[i] = T(0);
    if (k == 0) counts[cell] = 0;
    return;
  }
  const int64_t* row = pid + b * N;
  const long long start = lower_bound(row, N, p);
  const long long end = lower_bound(row, N, (int64_t)p + 1);
  const long long run = end - start;
  const int n = run < cap ? (int)run : cap;
  const T* x = pts + (b * N + start) * C + k;
  T acc = T(0);
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    acc = acc + x[(long long)j * C];
  }
  sums[i] = acc;
  if (k == 0) counts[cell] = n;
}

template <typename T>
int launch(const void* pts, const int64_t* pid, void* sums, int32_t* counts, int B, long long N, int C,
           int n_cells, int cap, void* stream) {
  const long long total = (long long)B * ((long long)n_cells + 1) * C;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  pillar_sums_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pts), pid, static_cast<T*>(sums), counts, B, N, C, n_cells, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// pts (B, N, C) float (dtype 0) or double (dtype 1), pid (B, N) int64, both
// sorted by pillar id; sums (B, n_cells + 1, C) of pts' type, counts
// (B, n_cells + 1) int32; all contiguous on the current device. Returns the
// cudaError_t of the launch (0 = launched), or -1 for an unknown dtype.
extern "C" int pillar_sums_launch(const void* pts, const int64_t* pid, void* sums, int32_t* counts, int B,
                                  long long N, int C, int n_cells, int cap, int dtype, void* stream) {
  if (dtype == 0) return launch<float>(pts, pid, sums, counts, B, N, C, n_cells, cap, stream);
  if (dtype == 1) return launch<double>(pts, pid, sums, counts, B, N, C, n_cells, cap, stream);
  return -1;
}
