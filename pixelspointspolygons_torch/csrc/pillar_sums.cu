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
// The dump cell p = n_cells gets zeros. Types: float and double; 1 to
// kMaxC = 32 / kPerWarp coordinates a point (4 as built).
//
// What bounds it: bytes. The least are the kept points and the outputs
// (8.2 MB at the main path's size: 16 clouds padded to 200,000 points, 784
// pillars, cap 64; 0.0024 ms at the card's memory rate). This design also
// reads the id of every row that is not padding once (5.5 MB more), and a
// call costs a launch. Each kept coordinate is read once and added once;
// the padding rows and the points past a pillar's cap are never read.
//
// Design: a block takes a tile of kTile consecutive positions [ts, te) of
// one sample's sorted rows (2,048 as built; position N, one past the last
// row, counts as a row of id n_cells) and owns the pillars whose runs start
// in it, empty ones included: the ids q with id(ts - 1) < q <= id(te - 1).
// No pillar is searched for:
//   - One read decides: a tile whose row before it is padding holds only
//     padding and stops at once (most tiles: 78.5 % of the main path's
//     rows are padding), and so does a tile inside one run. The blocks go
//     in the order of their tiles' positions, every sample's first tile
//     first, so the tiles that hold points are dispatched before the
//     padding's.
//   - One read of the tile's ids, coalesced, kScan a thread, and of the
//     kAhead ids after it: a position whose id differs from the one before
//     starts the pillars between the two ids, so each owned pillar's start
//     is found at once, and the last one's run ends at the first id after
//     the tile that is larger. A run that reaches past the look-ahead while
//     its cap does too (a pillar of thousands of points) has its end
//     searched by one warp, 32-fold a round.
//   - Points staged in shared memory, coalesced: the block takes its
//     pillars kPillars at a time, a warp kPerWarp consecutive ones, whose
//     kept points are kPerWarp stretches of the sample's rows. The warp
//     copies them as whole 16-byte units (cp.async.cg, a unit a lane; a
//     stretch starts anywhere in a unit) laid one after another, in chunks
//     of kStageBytes into one of its two buffers, and copies the next chunk
//     while it sums this one.
//   - The adds stay one ordered chain per (pillar, coordinate): lane
//     t * C + k adds coordinate k of the warp's pillar t, one point after
//     another, and carries the sum into the next chunk. No tree, no shuffle
//     reduction, no atomics: the result does not depend on scheduling.
// (Two earlier designs, a warp a pillar and a block a span of 32 pillars,
// searched the sorted ids for each pillar or each span: 5 and 3 rounds of
// scattered reads before the first add, which cost more than the sums;
// PERF.md, PR 15.)
//
// A 16-byte unit may reach up to 15 bytes before a stretch or after it:
// inside the points' allocation, whose start is aligned and whose size
// PyTorch's allocator rounds up to 512 bytes; those bytes are not added.
//
// Rounding. Compiled with --fmad=false, although only adds are involved:
// the sum is the plain version's, add for add. Starting from +0.0 and
// adding in order, the sum is never -0.0, so the plain version's extra
// adds of +0.0 (its empty slots) leave its bits unchanged.

#include <cuda_runtime.h>

#include <cstdint>

#ifndef PS_WARPS
#define PS_WARPS 8
#endif
#ifndef PS_PER_WARP
#define PS_PER_WARP 8
#endif
#ifndef PS_STAGE_BYTES
#define PS_STAGE_BYTES 2944
#endif
#ifndef PS_SCAN
#define PS_SCAN 8
#endif
#ifndef PS_MIN_BLOCKS
#define PS_MIN_BLOCKS 3
#endif

namespace {

constexpr int kWarps = PS_WARPS;             // warps a block
constexpr int kPerWarp = PS_PER_WARP;        // pillars a warp takes at a time
constexpr int kPillars = kWarps * kPerWarp;  // pillars a block takes at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kScan = PS_SCAN;               // tile positions a thread reads
constexpr int kTile = kThreads * kScan;      // positions a block owns
constexpr int kAhead = kThreads;             // positions read after the tile, one a thread
constexpr int kStageBytes = PS_STAGE_BYTES;  // each of a warp's two staging buffers
// blocks an SM must hold at once, which caps the registers: 3 x 132 SMs
// hold the main path's 342 tiles that hold points (a cap of 4 blocks, 64
// registers, ran 10 % slower)
constexpr int kMinBlocks = PS_MIN_BLOCKS;
constexpr int kMaxC = 32 / kPerWarp;         // coordinates a point: a lane each, for each of the warp's pillars
constexpr unsigned kFull = 0xffffffffu;
static_assert(32 % kPerWarp == 0, "a warp's lanes split evenly among its pillars");
static_assert(kStageBytes % 16 == 0, "a chunk holds whole 16-byte units");

// The first index in row[lo, hi) whose id is >= key (row sorted ascending,
// the answer known to lie in [lo, hi]), found by one warp: each round 31
// lanes read evenly spaced ids and one ballot narrows the interval 32-fold.
__device__ __forceinline__ long long warp_lower_bound(const int64_t* __restrict__ row, long long lo, long long hi,
                                                      int64_t key, int lane) {
  while (lo < hi) {  // the same on every lane
    const long long len = hi - lo;
    // probe j of 31, q_0 <= ... <= q_30 in [lo, hi): row < key holds for
    // the first c of them and for none after
    const long long q = lo + (((lane + 1) * len) >> 5);
    const int c = __popc(__ballot_sync(kFull, lane < 31 && row[q] < key));
    const long long left = c > 0 ? lo + ((c * len) >> 5) + 1 : lo;      // q_(c-1) + 1
    const long long right = c < 31 ? lo + (((c + 1) * len) >> 5) : hi;  // q_c
    lo = left;
    hi = right;
  }
  return lo;
}

// one 16-byte copy, both addresses 16-byte aligned
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most one group of copies (the latest) is still in flight
__device__ __forceinline__ void wait_all_but_latest() { asm volatile("cp.async.wait_group 1;\n" ::); }

// The warp's staged stream: pillar t's kept points, widened to whole
// 16-byte units from the global unit from[t] (address / 16), laid one after
// another, stream unit u being pillar t's for unit[t] <= u < unit[t + 1].
// Copies the stream units [u0, u0 + count) into the shared buffer `to`, a
// unit a lane and copy.
__device__ __forceinline__ void stage_chunk(char* to, const unsigned long long* from, const int* unit, int u0,
                                            int count, int lane) {
  for (int i = lane; i < count; i += 32) {
    const int u = u0 + i;
    int t = 0;
    while (u >= unit[t + 1]) ++t;
    copy16_async(to + 16 * i, reinterpret_cast<const void*>((from[t] + (u - unit[t])) << 4));
  }
}

#ifdef PS_TRACE
// per block, clock64() at the kernel's steps and globaltimer at its start
// and end, for pillar_sums_bench.py: 0 start, 1 the check read, 2 the owned
// pillars' starts (first pass), 3 thread 0's first chunk landed, 4 its sums
// done, 5 and 6 globaltimer at the start and the end; a block that stops
// after the check leaves 2-4 and 6 at 0
constexpr int kTraceBlocks = 8192, kTraceMarks = 7;
__device__ long long trace_marks[kTraceBlocks][kTraceMarks];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TRACE_SET(k, v) \
  if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) trace_marks[blockIdx.x][k] = (v)
#else
#define TRACE_SET(k, v)
#endif
#define TRACE_MARK(k) TRACE_SET(k, clock64())

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    pillar_sums_kernel(const T* __restrict__ pts, const int64_t* __restrict__ pid, T* __restrict__ sums,
                       int32_t* __restrict__ counts, long long N, int C, int n_cells, int cap, int B) {
  __shared__ __align__(16) char stage[kWarps][2][kStageBytes];
  __shared__ long long start_of[kPillars + 1];  // in a pass: the start of pillar q_lo + k
  __shared__ long long last_start, last_end;    // the last owned pillar's run
  __shared__ unsigned long long warp_from[kWarps][kPerWarp];
  __shared__ int warp_unit[kWarps][kPerWarp + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // blocks in the order of their tiles' positions, every sample's first
  // tile first: the tiles that hold points start before the padding's
  const long long b = blockIdx.x % B;
  const long long ts = (long long)(blockIdx.x / B) * kTile;
  const long long te = ts + kTile < N + 1 ? ts + kTile : N + 1;
  const int64_t* ids = pid + b * N;
  TRACE_MARK(0);
  TRACE_SET(5, global_ns());
  TRACE_SET(2, 0);
  TRACE_SET(3, 0);
  TRACE_SET(4, 0);
  TRACE_SET(6, 0);

  // the id before the tile (-1 before the first row) and its last one (row
  // N: n_cells); ids are at most n_cells, so they fit an int
  const int before = ts > 0 ? (int)ids[ts - 1] : -1;
  const int last = te - 1 < N ? (int)ids[te - 1] : n_cells;
  TRACE_MARK(1);
  if (before == n_cells || last == before) return;  // only padding, or inside one run: nothing owned

  // the tile's positions ts + threadIdx.x + r * kThreads: each id and the
  // one before it (every read first, then the compares), and the position
  // kAhead after it
  int cur[kScan], prev[kScan];
#pragma unroll
  for (int r = 0; r < kScan; ++r) {
    const long long i = ts + threadIdx.x + (long long)r * kThreads;
    cur[r] = i < te ? (i < N ? (int)ids[i] : n_cells) : last;
    prev[r] = i < te ? (i > ts ? (int)ids[i - 1] : before) : last;
  }
  const long long ahead = te + threadIdx.x;
  const int ahead_cur = ahead < N ? (int)ids[ahead] : n_cells;
  const int ahead_prev = ahead <= N ? (int)ids[ahead - 1] : n_cells;
  // the last owned pillar's run: its start, and its end, the first position
  // after the tile whose id is larger
#pragma unroll
  for (int r = 0; r < kScan; ++r) {
    if (prev[r] < cur[r] && cur[r] == last) last_start = ts + threadIdx.x + (long long)r * kThreads;
  }
  const bool ends = last < n_cells && ahead <= N && ahead_prev <= last && ahead_cur > last;
  if (ends) last_end = ahead;
  if (!__syncthreads_or(ends) && last < n_cells) {
    // the run reaches past the look-ahead (so te + kAhead <= N): its end
    // matters only below its start + cap
    const long long lo = te + kAhead;
    const long long hi = last_start + cap < N ? last_start + cap : N;
    if (hi <= lo) {
      if (threadIdx.x == 0) last_end = lo;
    } else if (warp == 0) {
      const long long end = warp_lower_bound(ids, lo, hi, (int64_t)last + 1, lane);
      if (lane == 0) last_end = end;
    }
    __syncthreads();
  }

  for (int q_lo = before + 1; q_lo <= last; q_lo += kPillars) {
    // the starts of the pillars q_lo ... q_lo + kPillars (the last owned
    // one's end stands for the start of the one after it)
#pragma unroll
    for (int r = 0; r < kScan; ++r) {
      if (prev[r] < cur[r]) {
        const long long i = ts + threadIdx.x + (long long)r * kThreads;
        const int hi = cur[r] < q_lo + kPillars ? cur[r] : q_lo + kPillars;
        for (int q = prev[r] + 1 > q_lo ? prev[r] + 1 : q_lo; q <= hi; ++q) start_of[q - q_lo] = i;
      }
    }
    if (threadIdx.x == 0 && last < n_cells && last + 1 <= q_lo + kPillars) start_of[last + 1 - q_lo] = last_end;
    __syncthreads();
    if (q_lo == before + 1) TRACE_MARK(2);

    // lane t < kPerWarp: the warp's pillar q_lo + k0 + t, its kept points
    // and their 16-byte units in the warp's stream
    const int k0 = warp * kPerWarp;
    int n = 0, shift = 0;
    if (lane < kPerWarp) {
      const int q = q_lo + k0 + lane;
      const bool real = q <= last && q < n_cells;
      const long long run = real ? start_of[k0 + lane + 1] - start_of[k0 + lane] : 0;
      n = run < cap ? (int)run : cap;
      const unsigned long long at =
          reinterpret_cast<unsigned long long>(pts + (b * N + (real ? start_of[k0 + lane] : 0)) * C);
      shift = (int)(at & 15);
      warp_from[warp][lane] = at >> 4;
    }
    const int bytes = n * C * (int)sizeof(T);
    const int own = bytes > 0 ? (shift + bytes + 15) / 16 : 0;
    int units = own;
#pragma unroll
    for (int d = 1; d < kPerWarp; d <<= 1) {  // inclusive prefix over the warp's pillars
      const int other = __shfl_up_sync(kFull, units, d);
      if (lane >= d) units += other;
    }
    if (lane < kPerWarp) warp_unit[warp][lane + 1] = units;
    if (lane == 0) warp_unit[warp][0] = 0;
    const int total = __shfl_sync(kFull, units, kPerWarp - 1);
    // lane t * C + k adds coordinate k of pillar t: its `count` values lie
    // at the stream's bytes at, at + step, ...
    const int mine = lane / C;
    const int coord = lane % C;
    const int src_lane = mine < kPerWarp ? mine : 0;
    const int first_unit = __shfl_sync(kFull, units - own, src_lane);
    const int first_shift = __shfl_sync(kFull, shift, src_lane);
    const int count_of = __shfl_sync(kFull, n, src_lane);
    const int count = mine < kPerWarp ? count_of : 0;
    int at = 16 * first_unit + first_shift + coord * (int)sizeof(T);
    const int step = C * (int)sizeof(T);
    __syncwarp();

    constexpr int kUnits = kStageBytes / 16;  // units a chunk
    const int chunks = (total + kUnits - 1) / kUnits;
    int left = count;
    T acc = T(0);
    if (chunks > 0) {
      stage_chunk(stage[warp][0], warp_from[warp], warp_unit[warp], 0, total < kUnits ? total : kUnits, lane);
    }
    commit_copies();
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {  // into the other buffer, summed last round
        const int u1 = (c + 1) * kUnits;
        stage_chunk(stage[warp][(c + 1) & 1], warp_from[warp], warp_unit[warp], u1,
                    total - u1 < kUnits ? total - u1 : kUnits, lane);
      }
      commit_copies();
      wait_all_but_latest();  // this lane's copies of chunk c have landed
      __syncwarp();           // and every lane's are visible to the warp
      if (c == 0 && q_lo == before + 1) TRACE_MARK(3);
      // this lane's values in chunk c: those before the chunk's end, in order
      const int end = (c + 1) * kStageBytes;
      const int here = at < end ? (end - at + step - 1) / step : 0;
      const int m = here < left ? here : left;
      const T* x = reinterpret_cast<const T*>(stage[warp][c & 1] + (at - c * kStageBytes));
#pragma unroll 8
      for (int j = 0; j < m; ++j) acc = acc + x[j * C];
      at += m * step;
      left -= m;
      __syncwarp();  // buffer c & 1 is read before round c + 1 copies into it
    }
    if (q_lo == before + 1) TRACE_MARK(4);

    const int q = q_lo + k0 + mine;
    if (mine < kPerWarp && q <= last) {  // the dump cell's sum is 0 and its count 0
      const long long cell = b * ((long long)n_cells + 1) + q;
      sums[cell * C + coord] = acc;
      if (coord == 0) counts[cell] = count;
    }
    __syncthreads();  // start_of and the warp's stream are read before the next pass writes them
  }
  TRACE_SET(6, global_ns());
}

template <typename T>
int launch(const void* pts, const int64_t* pid, void* sums, int32_t* counts, int B, long long N, int C,
           int n_cells, int cap, void* stream) {
  if (B == 0) return 0;
  const long long tiles_per_sample = N / kTile + 1;  // row N too
  const long long blocks = (long long)B * tiles_per_sample;
  pillar_sums_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pts), pid, static_cast<T*>(sums), counts, N, C, n_cells, cap, B);
  return (int)cudaGetLastError();
}

}  // namespace

// pts (B, N, C) float (dtype 0) or double (dtype 1), pid (B, N) int64, both
// sorted by pillar id; sums (B, n_cells + 1, C) of pts' type, counts
// (B, n_cells + 1) int32; all contiguous on the current device. Returns the
// cudaError_t of the launch (0 = launched), or -1 for an unknown dtype or a
// C outside 1 to kMaxC.
extern "C" int pillar_sums_launch(const void* pts, const int64_t* pid, void* sums, int32_t* counts, int B,
                                  long long N, int C, int n_cells, int cap, int dtype, void* stream) {
  if (C < 1 || C > kMaxC) return -1;
  if (dtype == 0) return launch<float>(pts, pid, sums, counts, B, N, C, n_cells, cap, stream);
  if (dtype == 1) return launch<double>(pts, pid, sums, counts, B, N, C, n_cells, cap, stream);
  return -1;
}

#ifdef PS_TRACE
// the marks of the last launch's first min(blocks, kTraceBlocks) blocks
extern "C" int pillar_sums_trace(long long* out, int blocks) {
  const int n = blocks < kTraceBlocks ? blocks : kTraceBlocks;
  return (int)cudaMemcpyFromSymbol(out, trace_marks, sizeof(long long) * kTraceMarks * n);
}
#endif

// out[0] = warps a block, out[1] = pillars a warp, out[2] = bytes a staged
// chunk, out[3] = tile positions a thread reads, out[4] = the most
// coordinates a point, out[5] and out[6] = the blocks an SM of the current
// device holds at once in float and in double (registers and shared memory
// allow); returns the cudaError_t of that query
extern "C" int pillar_sums_config(int* out) {
  out[0] = kWarps;
  out[1] = kPerWarp;
  out[2] = kStageBytes;
  out[3] = kScan;
  out[4] = kMaxC;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5], pillar_sums_kernel<float>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[6], pillar_sums_kernel<double>, kThreads, 0);
}
