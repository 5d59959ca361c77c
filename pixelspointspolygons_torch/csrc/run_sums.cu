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
// What bounds it: the larger of two times.
//   - Bytes: x, the ids and the output, each moved once (0.85 GB at the main
//     path's size: 16 clouds padded to 200,000 points, 64 float channels,
//     785 segments a cloud; 0.253 ms at the card's 3.35 TB/s; 4.96 GB and
//     1.481 ms at 384 channels).
//   - The chain: a sample's dump cell collects most of its rows (169,211 of
//     200,000 in the main path's longest sample), and their sum is one chain
//     of dependent adds per (sample, channel), in row order. No other order
//     gives the same bits, so the longest sample's dump rows times the
//     latency of one dependent add, over the clock, is a floor no layout of
//     the work can pass: run_sums_bench.py measures 4.11 cycles a float add
//     at 1.98 GHz, 169,211 x 4.11 / 1.98 GHz = 0.351 ms (8.05 cycles a
//     double add, 27.8 a bfloat16 add with its rounding).
// At 64 channels the chain is the larger; at 384 the bytes.
//
// Design, one launch, blocks of two kinds:
//   - Chain blocks, dispatched first (they are the long pole): block (b, j)
//     owns channels [32 j, 32 j + 32) of sample b. Warp 0 is the chain; warps
//     1 to kProducers fill a ring of kStages slots in dynamic shared memory,
//     tile t of kRows rows (kStageBytes of 32 channels) by warp
//     1 + t % kProducers. A producer reads the tile's ids one tile ahead
//     into registers, finds the dump rows by ballot, and copies only those
//     rows' 32 channels, compacted, into the tile's slot as 16-byte cp.async
//     units (a row's units side by side, a lane a unit), then writes +0.0
//     into the slot's other rows. Each slot has a full and an empty
//     mbarrier; the producer's copies arrive on the full one as they land
//     (cp.async.mbarrier.arrive). No block-wide barrier in the loop.
//     The chain warp adds every row of every slot, lane c channel c: a
//     tile's groups of kGroup rows unrolled, the next group read into
//     registers while this one is added (the next tile's first group before
//     this tile's last is added), so its dependent path is the adds alone,
//     without a branch; a +0.0 row leaves a sum begun at +0.0 unchanged (see
//     Rounding). It adds 200,000 rows a chain where 169,211 are needed, the
//     price of a loop without a data-dependent trip count: a loop over the
//     compacted rows' groups alone ran at 10-14 cycles a row (its reads
//     exposed once a group), this one at 6-7.
//     The ring's depth: at 64 channels each of the 32 chain blocks streams
//     23 MB (its sample's ids and its 32 channels of each dump row) within
//     the chain's ~0.4 ms, ~60 GB/s a block; the trace reads ~1,300 cycles
//     (0.65 us; 2,800 at the 90th percentile) from a tile's copies requested
//     to landed, so 40-85 KB must be in flight a block: 6 slots of 16 KB, 4
//     in flight while the chain holds one and a producer fills one. 99 KB a
//     block lets two blocks share an SM, so the 192 chain blocks at 384
//     channels run in one wave. A producer is at most one use of a slot
//     ahead of the chain (kProducers <= kStages), so a wait by parity is
//     never ambiguous.
//   - Run blocks: a block takes a tile of kWarps * 32 * kRunScan positions
//     of one sample, a warp 32 * kRunScan of them, all samples' first tiles
//     first. One coalesced read of the ids decides: a tile without a run
//     start (a row whose id is not the dump's and differs from the row
//     before) stops there. Else each warp lists the boundaries (the rows
//     whose id differs from the row before) of its part by ballot, so the
//     runs that start there and their ends are known at once; the last
//     run's end, if it lies past the part, is searched 32 ids a round. The
//     warp stages its runs' rows, kRunLaneCh * 32 channels at a time, by
//     cp.async in chunks of kRunChunk bytes into two buffers, copying the
//     next chunk while it adds this one, and adds each run's rows in row
//     order, lane c channel c (and c + 32, ...).
// No tree, no shuffle reduction, no atomics: each sum is one ordered chain.
//
// Rows are copied in 16-byte units, so x's start and a row's bytes
// (C * sizeof(T)) must be multiples of 16, as on the main path (64 and 384
// channels in a fresh tensor); the wrapper pads other widths with zero
// channels (ops/run_sums.py::_launch).
//
// Rounding. Compiled with --fmad=false, although only adds are involved:
// the sum is the plain version's, add for add. Starting from +0.0 and adding
// in order, a sum is never -0.0, so the plain version's extra adds of +0.0
// (and the chain's +0.0 rows) leave its bits unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifndef RS_PRODUCERS
#define RS_PRODUCERS 4
#endif
#ifndef RS_STAGES
#define RS_STAGES 6
#endif
#ifndef RS_STAGE_BYTES
#define RS_STAGE_BYTES 16384
#endif
#ifndef RS_GROUP
#define RS_GROUP 16
#endif
#ifndef RS_RUN_SCAN
#define RS_RUN_SCAN 8
#endif

namespace {

constexpr int kProducers = RS_PRODUCERS;      // warps that fill a chain block's ring
constexpr int kWarps = 1 + kProducers;        // warp 0 is the chain
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = RS_STAGES;            // ring slots
constexpr int kStageBytes = RS_STAGE_BYTES;   // a slot's rows x 32 channels
constexpr int kGroup = RS_GROUP;              // rows the chain warp reads ahead
constexpr int kRunScan = RS_RUN_SCAN;         // ids a lane reads in a run tile
constexpr int kRunPart = 32 * kRunScan;       // positions a warp owns in a run tile
constexpr int kRunTile = kWarps * kRunPart;   // positions a run block owns
constexpr int kRunChunk = 8192;               // each of a run warp's two staging buffers
constexpr int kRunLaneCh = 4;                 // channels a lane adds at a time in a run warp
constexpr unsigned kFull = 0xffffffffu;
static_assert(kStages >= 2, "the chain holds one slot while the next fills");
// a producer waits for a slot's empty phase by its parity, which names the
// phase only while the producer is at most one use of the slot ahead: its
// tile t follows its tile t - kProducers, which waited for t - kProducers -
// kStages to be added, so t - 2 kStages has been
static_assert(kProducers <= kStages, "a producer is at most one use of a slot ahead of the chain");
static_assert(kRunChunk % 16 == 0 && kRunChunk >= 32 * kRunLaneCh * 8, "a chunk holds a row of doubles");

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one 16-byte copy, both addresses 16-byte aligned
__device__ __forceinline__ void copy16_async(void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(smem_addr(bar)) : "memory");
}

// the barrier's phase completes only when this thread's earlier cp.async
// copies have landed too
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

#ifdef RS_TRACE
// clock64() at each chain tile's steps, for run_sums_bench.py: 0 its copies
// requested (the producer), 1 the chain waits for it, 2 landed (the wait
// passed), 3 added (the chain released its slot); globaltimer at each chain
// block's start and end
constexpr int kTraceBlocks = 64, kTraceTiles = 2048;
__device__ long long trace_marks[kTraceBlocks][kTraceTiles][4];
__device__ long long trace_ns[kTraceBlocks][2];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TRACE_TILE(t, k)                                                            \
  if (lane == 0 && blockIdx.x < kTraceBlocks && (t) < kTraceTiles) \
  trace_marks[blockIdx.x][t][k] = clock64()
#define TRACE_NS(k) \
  if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) trace_ns[blockIdx.x][k] = global_ns()
#else
#define TRACE_TILE(t, k)
#define TRACE_NS(k)
#endif

// The chain blocks' shared memory: full[kStages] and empty[kStages]
// mbarriers, each producer's list of its tile's dump rows, and the slots.
template <typename T>
struct Chain {
  static constexpr int kRows = kStageBytes / (32 * (int)sizeof(T));  // rows a slot
  static constexpr int kUnits = 2 * (int)sizeof(T);                  // 16-byte units a staged row
  static constexpr int kRowBytes = 16 * kUnits;
  static constexpr int kIds = kRows / 32;  // ids a producer lane reads a tile
  static constexpr int kListOff = 16 * kStages;
  static constexpr int kSlotOff = (kListOff + 2 * kProducers * kRows + 15) / 16 * 16;
  static constexpr int kBytes = kSlotOff + kStages * kRows * kRowBytes;
  static_assert(kRows % 32 == 0 && kRows % kGroup == 0, "a slot holds whole ballots and whole groups");
};

// A run warp's shared memory: its boundaries (position, id) and two chunks.
struct Runs {
  static constexpr int kListBytes = ((2 * kRunPart + 1) * 4 + 15) / 16 * 16;
  static constexpr int kWarpBytes = kListBytes + 2 * kRunChunk;
  static constexpr int kBytes = kWarps * kWarpBytes;
};

template <typename T>
constexpr int smem_bytes() {
  return Chain<T>::kBytes > Runs::kBytes ? Chain<T>::kBytes : Runs::kBytes;
}

// One (sample, 32-channel) dump chain, in row order over the whole sample.
template <typename T>
__device__ void dump_chain(const T* __restrict__ x, const int64_t* __restrict__ ids, T* __restrict__ out, int C,
                           long long rows_per_sample, long long segs_per_sample, int chunks, char* smem) {
  using Ch = Chain<T>;
  constexpr int kRows = Ch::kRows, kRowBytes = Ch::kRowBytes, kIds = Ch::kIds, kUnits = Ch::kUnits;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + Ch::kListOff);
  char* slots = smem + Ch::kSlotOff;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = blockIdx.x / chunks;
  const int c0 = (blockIdx.x % chunks) * 32;
  const int width = (C - c0 < 32 ? C - c0 : 32) * (int)sizeof(T);  // bytes of a row's channels here
  const long long row0 = b * rows_per_sample;
  const int64_t dump = b * segs_per_sample + segs_per_sample - 1;
  const long long tiles = (rows_per_sample + kRows - 1) / kRows;
  TRACE_NS(0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);   // the producer warp's lanes
      mbar_init(&empty[s], 32);  // the chain warp's lanes
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp > 0) {
    // producer: tiles warp - 1, warp - 1 + kProducers, ...
    unsigned short* my_list = list + (warp - 1) * kRows;
    int64_t next[kIds];
    auto read_ids = [&](long long t) {
#pragma unroll
      for (int m = 0; m < kIds; ++m) {
        const long long r = t * kRows + m * 32 + lane;
        next[m] = r < rows_per_sample ? ids[row0 + r] : -1;
      }
    };
    long long t = warp - 1;
    if (t < tiles) read_ids(t);
    for (; t < tiles; t += kProducers) {
      int64_t id[kIds];
#pragma unroll
      for (int m = 0; m < kIds; ++m) id[m] = next[m];
      if (t + kProducers < tiles) read_ids(t + kProducers);  // in flight while this tile is copied
      const int s = (int)(t % kStages);
      const long long use = t / kStages;
      if (use > 0) mbar_wait(&empty[s], (unsigned)((use - 1) & 1));
      __syncwarp();  // this warp's list is read (by its last tile's copies) before it is written
      // the dump rows, compacted in row order
      int n = 0;
#pragma unroll
      for (int m = 0; m < kIds; ++m) {
        const bool is_dump = id[m] == dump;
        const unsigned mask = __ballot_sync(kFull, is_dump);
        if (is_dump) my_list[n + __popc(mask & ((1u << lane) - 1))] = (unsigned short)(m * 32 + lane);
        n += __popc(mask);
      }
      __syncwarp();
      char* slot = slots + s * kRows * kRowBytes;
      for (int i = lane; i < n * kUnits; i += 32) {  // a lane a 16-byte unit, a row's units side by side
        const int k = i / kUnits, u = i % kUnits;
        const uintptr_t at = reinterpret_cast<uintptr_t>(x + (row0 + t * kRows + my_list[k]) * C + c0);
        if (u * 16 < width) copy16_async(slot + k * kRowBytes + 16 * u, at + 16 * u);
      }
      // +0.0 rows after them: the chain adds the whole slot
      for (int k = n; k < kRows; ++k) reinterpret_cast<T*>(slot + k * kRowBytes)[lane] = T();
      TRACE_TILE(t, 0);
      mbar_arrive_on_copies(&full[s]);
      mbar_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // the chain: every row of every slot added, the next group read while
  // this one is added (a tile's groups unrolled, so the reads are scheduled
  // early and the dependent path is the adds alone)
  constexpr int kGroups = kRows / kGroup;
  typename Add<T>::Acc acc = 0;
  int s = 0;
  unsigned parity = 0;
  auto row = [&](int slot, int r) -> T {
    return *reinterpret_cast<const T*>(slots + (slot * kRows + r) * kRowBytes + lane * (int)sizeof(T));
  };
  TRACE_TILE(0, 1);
  mbar_wait(&full[0], 0);
  TRACE_TILE(0, 2);
  T v[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) v[i] = row(0, i);
  for (long long t = 0; t < tiles; ++t) {
    const int here = s;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      T w[kGroup];
      if (g + 1 < kGroups) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) w[i] = row(here, (g + 1) * kGroup + i);
      } else {
        if (t + 1 < tiles) {  // the next tile's first group
          if (++s == kStages) {
            s = 0;
            parity ^= 1;
          }
          TRACE_TILE(t + 1, 1);
          mbar_wait(&full[s], parity);
          TRACE_TILE(t + 1, 2);
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) w[i] = row(s, i);
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) acc = Add<T>::add(acc, v[i]);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) v[i] = w[i];
    }
    mbar_arrive(&empty[here]);
    TRACE_TILE(t, 3);
  }
  if (c0 + lane < C) out[dump * C + c0 + lane] = Add<T>::out(acc);
  TRACE_NS(1);
}

// The pillar runs that start in one warp's part [p0, p1) of sample b's rows.
// Inlined, so that cur and bound stay in registers.
template <typename T>
__device__ __forceinline__ void pillar_runs(const T* __restrict__ x, const int64_t* __restrict__ sid,
                                            T* __restrict__ out, int C, long long b, long long rows_per_sample,
                                            long long segs_per_sample, long long p0, long long p1,
                                            const int (&cur)[kRunScan], const bool (&bound)[kRunScan], char* smem) {
  const int lane = threadIdx.x & 31;
  const int dump = (int)(segs_per_sample - 1);  // local ids: id - b K
  const long long seg0 = b * segs_per_sample;
  int* bpos = reinterpret_cast<int*>(smem);
  int* bid = bpos + kRunPart + 1;
  char* buf = smem + Runs::kListBytes;

  // the boundaries in row order: bpos[i] its position, bid[i] its id; the
  // stretch of boundary i is [bpos[i], bpos[i + 1])
  int nb = 0;
#pragma unroll
  for (int r = 0; r < kRunScan; ++r) {
    const unsigned mask = __ballot_sync(kFull, bound[r]);
    if (bound[r]) {
      const int i = nb + __popc(mask & ((1u << lane) - 1));
      bpos[i] = (int)(p0 + r * 32 + lane);
      bid[i] = cur[r];
    }
    nb += __popc(mask);
  }
  __syncwarp();
  const int last = bid[nb - 1];
  long long end = p1;
  if (last != dump) {  // the last run reaches p1 or past it: its end is the first other id
    for (long long q = p1;; q += 32) {
      const long long p = q + lane;
      const bool other = p >= rows_per_sample || (int)(sid[p] - seg0) != last;
      const unsigned mask = __ballot_sync(kFull, other);
      if (mask) {
        end = q + __ffs(mask) - 1;
        break;
      }
    }
  }
  if (lane == 0) bpos[nb] = (int)end;
  __syncwarp();

  int total = 0;  // the runs' rows
  for (int i = lane; i < nb; i += 32) total += bid[i] != dump ? bpos[i + 1] - bpos[i] : 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) total += __shfl_xor_sync(kFull, total, d);
  int first = 0;
  while (bid[first] == dump) ++first;

  const T* xs = x + b * rows_per_sample * C;
  for (int c0 = 0; c0 < C; c0 += 32 * kRunLaneCh) {
    const int wch = C - c0 < 32 * kRunLaneCh ? C - c0 : 32 * kRunLaneCh;
    const int width = wch * (int)sizeof(T);  // a staged row's bytes, a multiple of 16
    const int per_chunk = kRunChunk / width;
    const int chunks = (total + per_chunk - 1) / per_chunk;
    // the copy cursor and the add cursor: boundary i, row r of its run
    int ci = first, cr = 0, ai = first, ar = 0;
    auto stage = [&](char* to, int rows) {
      for (int j = 0; j < rows; ++j) {
        const uintptr_t at = reinterpret_cast<uintptr_t>(xs + (long long)(bpos[ci] + cr) * C + c0);
        for (int u = lane; u < width / 16; u += 32) copy16_async(to + j * width + 16 * u, at + 16 * u);
        if (++cr == bpos[ci + 1] - bpos[ci]) {
          cr = 0;
          do ++ci;
          while (ci < nb && bid[ci] == dump);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    typename Add<T>::Acc acc[kRunLaneCh];
#pragma unroll
    for (int m = 0; m < kRunLaneCh; ++m) acc[m] = 0;
    stage(buf, total < per_chunk ? total : per_chunk);
    for (int ch = 0; ch < chunks; ++ch) {
      const int rows = total - ch * per_chunk < per_chunk ? total - ch * per_chunk : per_chunk;
      if (ch + 1 < chunks) {
        const int left = total - (ch + 1) * per_chunk;
        stage(buf + ((ch + 1) & 1) * kRunChunk, left < per_chunk ? left : per_chunk);
      } else {
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this lane's copies of chunk ch have landed
      __syncwarp();                                             // and every lane's are visible to the warp
      const char* here = buf + (ch & 1) * kRunChunk;
      for (int j = 0; j < rows; ++j) {
        const char* p = here + j * width;
#pragma unroll
        for (int m = 0; m < kRunLaneCh; ++m) {
          const int c = lane + 32 * m;
          if (c < wch) acc[m] = Add<T>::add(acc[m], *reinterpret_cast<const T*>(p + c * (int)sizeof(T)));
        }
        if (++ar == bpos[ai + 1] - bpos[ai]) {
          T* o = out + (seg0 + bid[ai]) * C + c0;
#pragma unroll
          for (int m = 0; m < kRunLaneCh; ++m) {
            const int c = lane + 32 * m;
            if (c < wch) o[c] = Add<T>::out(acc[m]);
            acc[m] = 0;
          }
          ar = 0;
          do ++ai;
          while (ai < nb && bid[ai] == dump);
        }
      }
      __syncwarp();  // buffer ch & 1 is read before round ch + 1 copies into it
    }
  }
}

// (kThreads, 1): with the block size alone ptxas held the float and double
// kernels to 48 and 56 registers and spilled; shared memory caps a chain
// block at two an SM whatever the registers
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    run_sums_kernel(const T* __restrict__ x, const int64_t* __restrict__ ids, T* __restrict__ out, int C, int samples,
                    long long rows_per_sample, long long segs_per_sample, int dump_blocks, int chunks) {
  extern __shared__ __align__(16) char smem[];
  if ((int)blockIdx.x < dump_blocks) {
    dump_chain<T>(x, ids, out, C, rows_per_sample, segs_per_sample, chunks, smem);
    return;
  }
  // a run tile: every sample's first tile first (32-bit division: a 64-bit
  // one is a call, whose saved registers spill)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = (int)blockIdx.x - dump_blocks;
  const long long b = u % samples;
  const long long p0 = (long long)(u / samples) * kRunTile + (long long)warp * kRunPart;
  const long long p1 = p0 + kRunPart < rows_per_sample ? p0 + kRunPart : rows_per_sample;
  const long long seg0 = b * segs_per_sample;
  const int dump = (int)(segs_per_sample - 1);
  const int64_t* sid = ids + b * rows_per_sample;
  // the part's ids, local (id - b K; -2 past the sample), and which rows
  // start a stretch (a boundary) and which a run
  int cur[kRunScan];
  bool bound[kRunScan];
#pragma unroll
  for (int r = 0; r < kRunScan; ++r) {
    const long long p = p0 + r * 32 + lane;
    cur[r] = p < p1 ? (int)(sid[p] - seg0) : -2;
  }
  int before = p0 > 0 && p0 < rows_per_sample ? (int)(sid[p0 - 1] - seg0) : -1;
  bool starts = false;
#pragma unroll
  for (int r = 0; r < kRunScan; ++r) {
    const int up = __shfl_up_sync(kFull, cur[r], 1);
    const int prev = lane == 0 ? before : up;
    before = __shfl_sync(kFull, cur[r], 31);
    bound[r] = cur[r] != -2 && cur[r] != prev;
    starts |= bound[r] && cur[r] != dump;
  }
  if (!__syncthreads_or(starts)) return;  // only dump rows, or inside one run: nothing owned
  if (!__any_sync(kFull, starts)) return;
  pillar_runs<T>(x, sid, out, C, b, rows_per_sample, segs_per_sample, p0, p1, cur, bound,
                 smem + warp * Runs::kWarpBytes);
}

template <typename T>
int launch(const void* x, const int64_t* ids, void* out, long long n_rows, int C, int samples,
           long long segs_per_sample, void* stream) {
  if (n_rows == 0 || samples == 0) return 0;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || (C * sizeof(T)) % 16 != 0) return -1;
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(run_sums_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (C + 31) / 32;
  const int dump_blocks = samples * chunks;
  const long long rows_per_sample = n_rows / samples;
  const long long blocks = dump_blocks + (long long)samples * ((rows_per_sample + kRunTile - 1) / kRunTile);
  run_sums_kernel<T><<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), ids, static_cast<T*>(out), C, samples, rows_per_sample, segs_per_sample,
      dump_blocks, chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int blocks_per_sm(int* out) {
  constexpr int smem = smem_bytes<T>();
  const cudaError_t err = cudaFuncSetAttribute(run_sums_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, run_sums_kernel<T>, kThreads, smem);
}

}  // namespace

// x (N, C) float (dtype 0), double (1) or bfloat16 (2), ids (N,) int64, out
// (samples * segs_per_sample, C) of x's type, zeroed by the caller; all
// contiguous on the current device, N a multiple of samples, x's start and
// C * sizeof(T) multiples of 16 bytes. Returns the cudaError_t of the launch
// (0 = launched), or -1 for an unknown dtype, a C below 1 or rows not
// 16-byte aligned.
extern "C" int run_sums_launch(const void* x, const int64_t* ids, void* out, long long n_rows, int C,
                               int samples, long long segs_per_sample, int dtype, void* stream) {
  if (C < 1) return -1;
  if (dtype == 0) return launch<float>(x, ids, out, n_rows, C, samples, segs_per_sample, stream);
  if (dtype == 1) return launch<double>(x, ids, out, n_rows, C, samples, segs_per_sample, stream);
  if (dtype == 2) return launch<__nv_bfloat16>(x, ids, out, n_rows, C, samples, segs_per_sample, stream);
  return -1;
}

#ifdef RS_TRACE
// the marks of the last launch's first min(blocks, kTraceBlocks) chain
// blocks: marks (blocks, kTraceTiles, 4), ns (blocks, 2)
extern "C" int run_sums_trace(long long* marks, long long* ns, int blocks) {
  const int n = blocks < kTraceBlocks ? blocks : kTraceBlocks;
  const cudaError_t err = cudaMemcpyFromSymbol(marks, trace_marks, sizeof(long long) * kTraceTiles * 4 * n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(ns, trace_ns, sizeof(long long) * 2 * n);
}
#endif

// out[0] = warps a block, out[1] = bytes a ring slot holds (rows x 32
// channels), out[2] = ring slots, out[3] = rows the chain reads ahead,
// out[4] = positions a run block owns, out[5] = dynamic shared memory a
// block (float), out[6..8] = the blocks an SM of the current device holds at
// once in float, double and bfloat16 (registers and shared memory allow);
// returns the cudaError_t of that query
extern "C" int run_sums_config(int* out) {
  out[0] = kWarps;
  out[1] = kStageBytes;
  out[2] = kStages;
  out[3] = kGroup;
  out[4] = kRunTile;
  out[5] = smem_bytes<float>();
  int err = blocks_per_sm<float>(&out[6]);
  if (err != 0) return err;
  err = blocks_per_sm<double>(&out[7]);
  if (err != 0) return err;
  return blocks_per_sm<__nv_bfloat16>(&out[8]);
}
