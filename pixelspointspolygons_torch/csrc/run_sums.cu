// Per-segment sums of the PillarFeatureNet's point rows, in a fixed order,
// written by hand for Hopper (sm_90a) and bound through a plain C interface
// (ctypes).
//
// Replaces no TPU kernel. It is the backward of two of the PillarFeatureNet's
// operations (pixelspointspolygons_torch/models/pointpillars.py): the gather
// of each pillar's pooled features back to its points, `pooled[pillar_id]`,
// and the count of the points that tie for a pillar's maximum in the segment
// max's gradient. The JAX package takes both as XLA scatter-adds, which on
// the CPU add each segment's rows one by one in row order. On the card
// PyTorch sorts the 3.2M ids for the first and, under
// `torch.use_deterministic_algorithms`, builds two (N, C) int64 index
// tensors for the second (9.8 GB each at 384 channels). This kernel adds in
// the CPU's order from the layout the voxelizer leaves, so the card gives the
// CPU's bits, every time. The plain PyTorch version of the same function is
// pixelspointspolygons_torch/ops/run_sums.py::run_sums; the wrapper is
// ::run_sums_cuda.
//
// What it computes, from rows x (N, C) and segment ids (N,) int64 in the
// layout of the PillarFeatureNet's flat point set: B samples of Np = N / B
// rows each, sample b's ids in [b K, (b + 1) K), its last id b K + K - 1
// the dump cell; every other id's rows form one contiguous run (a pillar's
// kept points, first in its sorted run). The dump cell's rows (padding,
// points outside the grid, points past a pillar's cap) lie anywhere in the
// sample. For each segment s:
//   out[s, c] = ((+0 + x[r0, c]) + x[r1, c]) + ... over its rows r0 < r1 < ...,
//   each add rounded to x's type (bfloat16 adds in float and rounds each sum
//   to bfloat16, as PyTorch's CPU scatter-add and index_put_ do).
// A segment with no rows is left as the caller set it (zeros). Types: float,
// double, bfloat16.
//
// What bounds it: bytes. The least are x, the ids and the output (0.87 GB
// at the main path's size: 16 clouds padded to 200,000 points, 64 float
// channels, 785 segments a cloud; 0.26 ms at the card's memory rate). Here
// the dump cells' rows are a chain of adds as long as a sample (200,000), one
// chain per (sample, channel): those chains, not the bytes, set the time.
//
// Design, one launch, blocks of two kinds:
//   - The first B * ceil(C / 32) blocks walk the dump chains: block (b, j)
//     owns channels [32 j, 32 j + 32) of sample b. Eight warps stage the
//     sample's rows in tiles of kTileBytes (a row's 32 channels, a lane
//     each, coalesced) with a flag per row (its id is the dump's) into one
//     of two buffers, while warp 0 adds the previous tile's flagged rows,
//     lane c channel c, one row after another. They are dispatched first.
//   - The other blocks take 32 rows a warp: a lane a row, a row whose id is
//     not its sample's dump and differs from the row before starts a run.
//     For each start (in order) the warp finds the run's end, 32 ids a
//     round, then adds the run's rows, lane c channel c (and c + 32, ...).
// No tree, no shuffle reduction, no atomics: each sum is one ordered chain.
//
// Rounding. Compiled with --fmad=false, although only adds are involved:
// the sum is the plain version's, add for add. Starting from +0.0 and adding
// in order, a sum is never -0.0, so the plain version's extra adds of +0.0
// leave its bits unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 9;                // warp 0 walks a dump chain, warps 1-8 stage its rows
constexpr int kThreads = 32 * kWarps;
constexpr int kLoaders = kWarps - 1;
constexpr int kTileBytes = 16384;        // a staged tile: rows x 32 channels
constexpr int kMaxTileRows = kTileBytes / (32 * 2);  // bfloat16's 256

template <typename T>
struct Add;

template <>
struct Add<float> {
  using Acc = float;
  static __device__ __forceinline__ Acc add(Acc a, float v) { return a + v; }
  static __device__ __forceinline__ float out(Acc a) { return a; }
};

template <>
struct Add<double> {
  using Acc = double;
  static __device__ __forceinline__ Acc add(Acc a, double v) { return a + v; }
  static __device__ __forceinline__ double out(Acc a) { return a; }
};

template <>
struct Add<__nv_bfloat16> {
  using Acc = float;  // holds a bfloat16 value exactly
  static __device__ __forceinline__ Acc add(Acc a, __nv_bfloat16 v) {
    return __bfloat162float(__float2bfloat16_rn(a + __bfloat162float(v)));
  }
  static __device__ __forceinline__ __nv_bfloat16 out(Acc a) { return __float2bfloat16_rn(a); }
};

// One (sample, 32-channel) dump chain, in row order over the whole sample.
template <typename T>
__device__ void dump_chain(const T* __restrict__ x, const int64_t* __restrict__ ids, T* __restrict__ out,
                           int C, long long rows_per_sample, long long segs_per_sample, int chunks,
                           unsigned char* smem) {
  constexpr int kRows = kTileBytes / (32 * (int)sizeof(T));
  constexpr int kPerLoader = kRows / kLoaders;
  T(*buf)[kRows][32] = reinterpret_cast<T(*)[kRows][32]>(smem);
  unsigned char(*flag)[kMaxTileRows] = reinterpret_cast<unsigned char(*)[kMaxTileRows]>(smem + 2 * kTileBytes);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = blockIdx.x / chunks;
  const int c = (blockIdx.x % chunks) * 32 + lane;
  const long long row0 = b * rows_per_sample;
  const int64_t dump = b * segs_per_sample + segs_per_sample - 1;
  const long long tiles = (rows_per_sample + kRows - 1) / kRows;

  // loader warp w stages rows w, w + 8, ... of tile t into buffer `slot`
  auto stage = [&](int slot, long long t) {
    const int w = warp - 1;
    T v[kPerLoader];
#pragma unroll
    for (int k = 0; k < kPerLoader; ++k) {
      const long long r = t * kRows + w + k * kLoaders;
      v[k] = (r < rows_per_sample && c < C) ? x[(row0 + r) * C + c] : T();
    }
#pragma unroll
    for (int k = 0; k < kPerLoader; ++k) buf[slot][w + k * kLoaders][lane] = v[k];
    if (lane < kPerLoader) {
      const long long r = t * kRows + w + lane * kLoaders;
      flag[slot][w + lane * kLoaders] = r < rows_per_sample && ids[row0 + r] == dump;
    }
  };

  typename Add<T>::Acc acc = 0;
  if (warp > 0) stage(0, 0);
  __syncthreads();
  for (long long t = 0; t < tiles; ++t) {
    const int slot = (int)(t & 1);
    if (warp > 0) {
      if (t + 1 < tiles) stage(slot ^ 1, t + 1);
    } else {
#pragma unroll 8
      for (int i = 0; i < kRows; ++i) {
        if (flag[slot][i]) acc = Add<T>::add(acc, buf[slot][i][lane]);
      }
    }
    __syncthreads();
  }
  if (warp == 0 && c < C) out[dump * C + c] = Add<T>::out(acc);
}

// The pillar runs that start in one warp's 32 rows.
template <typename T>
__device__ void pillar_runs(const T* __restrict__ x, const int64_t* __restrict__ ids, T* __restrict__ out,
                            long long n_rows, int C, long long rows_per_sample, long long segs_per_sample,
                            long long warp_index) {
  const int lane = threadIdx.x & 31;
  const long long base = warp_index * 32;
  if (base >= n_rows) return;  // the whole warp
  const long long r = base + lane;
  int64_t id = -1;
  bool start = false;
  if (r < n_rows) {
    id = ids[r];
    const long long b = r / rows_per_sample;
    const bool first = r == b * rows_per_sample;
    start = id != b * segs_per_sample + segs_per_sample - 1 && (first || ids[r - 1] != id);
  }
  unsigned starts = __ballot_sync(0xffffffffu, start);
  while (starts) {
    const int src = __ffs(starts) - 1;
    starts &= starts - 1;
    const long long r0 = base + src;
    const int64_t s = __shfl_sync(0xffffffffu, id, src);
    const long long sample_end = (r0 / rows_per_sample + 1) * rows_per_sample;
    long long end = r0 + 1;
    for (;;) {
      const long long q = end + lane;
      const bool other = q >= sample_end || ids[q] != s;
      const unsigned m = __ballot_sync(0xffffffffu, other);
      if (m) {
        end += __ffs(m) - 1;
        break;
      }
      end += 32;
    }
    for (int c = lane; c < C; c += 32) {
      typename Add<T>::Acc acc = 0;
#pragma unroll 4
      for (long long q = r0; q < end; ++q) acc = Add<T>::add(acc, x[q * C + c]);
      out[s * C + c] = Add<T>::out(acc);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) run_sums_kernel(const T* __restrict__ x,
                                                            const int64_t* __restrict__ ids, T* __restrict__ out,
                                                            long long n_rows, int C, long long rows_per_sample,
                                                            long long segs_per_sample, int dump_blocks,
                                                            int chunks) {
  __shared__ __align__(16) unsigned char smem[2 * kTileBytes + 2 * kMaxTileRows];
  if ((int)blockIdx.x < dump_blocks) {
    dump_chain<T>(x, ids, out, C, rows_per_sample, segs_per_sample, chunks, smem);
    return;
  }
  const long long warp_index = (long long)(blockIdx.x - dump_blocks) * kWarps + (threadIdx.x >> 5);
  pillar_runs<T>(x, ids, out, n_rows, C, rows_per_sample, segs_per_sample, warp_index);
}

template <typename T>
int launch(const void* x, const int64_t* ids, void* out, long long n_rows, int C, int samples,
           long long segs_per_sample, void* stream) {
  if (n_rows == 0 || samples == 0) return 0;
  const int chunks = (C + 31) / 32;
  const int dump_blocks = samples * chunks;
  const long long run_warps = (n_rows + 31) / 32;
  const long long blocks = dump_blocks + (run_warps + kWarps - 1) / kWarps;
  run_sums_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), ids, static_cast<T*>(out), n_rows, C, n_rows / samples, segs_per_sample,
      dump_blocks, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, C) float (dtype 0), double (1) or bfloat16 (2), ids (N,) int64, out
// (samples * segs_per_sample, C) of x's type, zeroed by the caller; all
// contiguous on the current device, N a multiple of samples. Returns the
// cudaError_t of the launch (0 = launched), or -1 for an unknown dtype or a
// C below 1.
extern "C" int run_sums_launch(const void* x, const int64_t* ids, void* out, long long n_rows, int C,
                               int samples, long long segs_per_sample, int dtype, void* stream) {
  if (C < 1) return -1;
  if (dtype == 0) return launch<float>(x, ids, out, n_rows, C, samples, segs_per_sample, stream);
  if (dtype == 1) return launch<double>(x, ids, out, n_rows, C, samples, segs_per_sample, stream);
  if (dtype == 2) return launch<__nv_bfloat16>(x, ids, out, n_rows, C, samples, segs_per_sample, stream);
  return -1;
}

// out[0] = warps a block, out[1] = bytes a staged tile, out[2..4] = the
// blocks an SM of the current device holds at once in float, double and
// bfloat16 (registers and shared memory allow); returns the cudaError_t of
// that query
extern "C" int run_sums_config(int* out) {
  out[0] = kWarps;
  out[1] = kTileBytes;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], run_sums_kernel<float>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], run_sums_kernel<double>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], run_sums_kernel<__nv_bfloat16>, kThreads, 0);
}
