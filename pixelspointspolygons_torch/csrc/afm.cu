// Attraction-field map (AFM) for the HiSup training targets, written by hand
// for Hopper (sm_90a) and bound through a plain C interface (ctypes).
//
// Replaces pixelspointspolygons_tpu/ops/afm_pallas.py::afm_pallas (kernel
// body _afm_kernel). The plain PyTorch version of the same function is
// pixelspointspolygons_torch/ops/afm.py::afm; the wrapper is ::afm_cuda.
//
// What it computes, for sample b and pixel (y, x) of an H x W grid:
//   - the squared distance to every valid segment of lines (B, L, 4) =
//     [x1, y1, x2, y2], with t = ((x-x1)dx + (y-y1)dy) / (dx^2+dy^2+1e-6)
//     clipped to [0, 1];
//   - the first minimum over segments (strict <, the same as argmin);
//   - afmap (B, 2, H, W) f32 = -sign(a) * log(|a / size| + 1e-6) for the
//     offsets a = ax (size W) and a = ay (size H) to the nearest point;
//   - label (B, H, W) i32 = index of the nearest segment.
// A sample with no valid segment gets zeros. Any L is taken.
//
// What bounds it: FP32 instructions, not memory. Every (pixel, valid
// segment) pair needs 14 FP32 operations (an add for the numerator, the
// quotient, the clamp, the offsets and the distance, a compare, an FMA
// counted as 2), and every column and every row 2 more per segment for its
// term. At the HiSup main path (B=16, 224 x 224) that is 0.8 M pairs per
// valid segment of the batch, while the outputs are 9.6 MB (about 3 us at
// 3.35 TB/s) and the inputs a few KB. Only three of the operations may be
// fused multiply-adds (see "Rounding"), so the work is issue-bound on the
// FP32 pipes. Where a
// sample has few segments (most of the main path's hold about 20), the
// fixed cost of a tile (staging, merge, epilogue) weighs as much as its
// pairs. PERF.md has the measurements. The design cuts the instructions
// issued per pair and spreads uneven samples over the card:
//   - No division. Each segment carries rcp = RN(1/den), computed once
//     when it is staged (and the epilogue divides by W and H through their
//     reciprocals the same way). The quotient is then
//       q0 = RN(num * rcp),  q = RN(q0 + RN(num - q0 * den) * rcp)
//     in one multiply and two FMAs: the remainder num - q0*den is exact in
//     an FMA, and one correction step from a correctly rounded reciprocal
//     gives the correctly rounded quotient (Markstein), so t has the bits
//     of an IEEE division. tests/test_torch_afm.py checks this arithmetic
//     on the CPU and tests/test_torch_kernels.py against __fdiv_rn on the
//     card (afm_division_check below). The one difference is the sign of a
//     zero quotient (num = -0 gives +0 here, -0 by division), which the
//     clamp of t to [0, 1] and the |a / size| of the encoding make
//     harmless. The clamp is a saturating FMA.
//   - An R x C tile of pixels per thread. Pixels in one column share
//     (x - x1) * dx and pixels in one row share (y - y1) * dy, so a thread
//     computes C + R such terms per segment and each of its R * C numerators
//     is one add. Each term is rounded as the plain version rounds it and an
//     IEEE add is commutative, so every distance keeps its bits.
//   - Only (best distance, segment index) is carried per pixel. After the
//     last segment the offsets of the winner are computed once more, from
//     its row of `lines`, with the same operations in the same order.
//   - The block stages a sample's segments in shared memory in chunks of
//     kChunk raw indices, with all its threads: a ballot per warp and a
//     prefix over the warps compact the valid ones, in index order, into
//     records {x1, y1, dx, dy} {rcp, den, index, 0} that the pixel loop
//     reads as two 16-byte broadcast loads. Padding rows cost nothing in the
//     pixel loop, and (best, index) is carried across chunks, so the result
//     is the first minimum over the whole list for any L.
//   - The warps of a block share one tile of 32 x (R * C) pixels and split
//     the segments between them: warp w walks records w, w + kWarps, ... in
//     index order. A sample's work is spread over kWarps times as many
//     warps as it has tiles, which keeps every scheduler busy when a few
//     samples hold most of the segments (the main path: 3 of 16 samples
//     hold 768 of its 1,033). At the end each warp leaves its (best,
//     index) per pixel in shared memory, and the first minimum over the
//     warps is the smallest distance, the lower index on a tie.
//   - The epilogue gives each thread one pixel of the tile, so a warp
//     stores a row of 32 neighbouring pixels. Pixels past the ragged edge
//     compute and do not store: every thread stays through every
//     __syncthreads.
//   - Blocks walk the samples fastest (blockIdx.x % B), so samples with
//     many segments spread over the whole grid instead of forming its tail.
//   - The kernel allocates nothing and launches on the caller's stream.
// Tensor cores, wgmma and TMA do not apply: the numerator cannot be turned
// into a matrix product without reassociating it, which changes the labels,
// and the inputs are a few KB that one staging pass reads.
//
// Rounding. Labels are bit-exact with the plain version: this file is
// compiled with --fmad=false (no --use_fast_math), and every expression
// keeps the plain version's order of operations, so each distance rounds
// the same way and the first minimum is the same segment. The three
// multiply-adds that the JAX package fuses on the CPU (dx*dx + dy*dy,
// x1 + t*dx, ax*ax + ay*ay; see ops/afm.py) are explicit __fmaf_rn here and
// fused the same way in the plain version; the two FMAs of the quotient
// round to the bits of the division they replace; nothing else is fused.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The tile, set at build time; a timing sweep may pass others with -D.
#ifndef AFM_ROWS
#define AFM_ROWS 2
#endif
#ifndef AFM_COLS
#define AFM_COLS 2
#endif
#ifndef AFM_WARPS
#define AFM_WARPS 4
#endif

namespace {

constexpr int kR = AFM_ROWS;      // rows of pixels per thread
constexpr int kC = AFM_COLS;      // columns of pixels per thread
constexpr int kWarps = AFM_WARPS; // warps per block, each with a share of the segments
constexpr int kChunk = 512;       // raw segment indices staged at a time (16 KB)

constexpr int kThreads = 32 * kWarps;
constexpr int kLanesX = 32 / kC;   // lanes along x; kC lanes along y
constexpr int kTileW = 32;         // columns of a block's tile
constexpr int kTileH = kR * kC;    // rows of a block's tile
constexpr int kTilePixels = kTileW * kTileH;
static_assert(32 % kC == 0, "a warp's 32 lanes must tile its 32 columns");
static_assert(2 * kChunk * 16 + kWarps * kTilePixels * 8 + kWarps * 4 <= 48 * 1024,
              "a block must stay within the 48 KB of shared memory a launch gets by default");

struct Segment {
  float x1, y1, dx, dy, den, rcp;
};

__device__ __forceinline__ Segment make_segment(float x1, float y1, float x2, float y2) {
  Segment s;
  s.x1 = x1;
  s.y1 = y1;
  s.dx = x2 - x1;
  s.dy = y2 - y1;
  s.den = __fmaf_rn(s.dx, s.dx, s.dy * s.dy) + 1e-6f;
  s.rcp = __frcp_rn(s.den);
  return s;
}

// RN(num / den) from rcp = RN(1 / den), but +0 where num = -0 (see above)
__device__ __forceinline__ float quotient(float num, float den, float rcp) {
  const float q0 = num * rcp;
  return __fmaf_rn(__fmaf_rn(-q0, den, num), rcp, q0);
}

// -sign(a) * log(|a / size| + 1e-6), with rcp = RN(1 / size)
__device__ __forceinline__ float encode_offset(float a, float size, float rcp) {
  const float s = (a > 0.f) ? 1.f : ((a < 0.f) ? -1.f : 0.f);
  return (-s) * logf(fabsf(quotient(a, size, rcp)) + 1e-6f);
}

__global__ void __launch_bounds__(kThreads)
afm_kernel(const float* __restrict__ lines, const uint8_t* __restrict__ valid,
           float* __restrict__ afmap, int32_t* __restrict__ label,
           int B, int L, int H, int W, int chunk, int tiles_x) {
  extern __shared__ float4 s_seg[];  // 2 * chunk records
  __shared__ int s_count[kWarps];
  __shared__ float s_best[kWarps][kTilePixels];  // each warp's first minimum
  __shared__ int s_win[kWarps][kTilePixels];

  const int b = blockIdx.x % B;
  const int tile = blockIdx.x / B;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tx0 = (tile % tiles_x) * kTileW;
  const int ty0 = (tile / tiles_x) * kTileH;
  const int lx = lane % kLanesX;
  const int ly = lane / kLanesX;
  float px[kC], py[kR];
#pragma unroll
  for (int c = 0; c < kC; ++c) px[c] = (float)(tx0 + lx + kLanesX * c);
#pragma unroll
  for (int r = 0; r < kR; ++r) py[r] = (float)(ty0 + ly + kC * r);

  float best[kR][kC];
  int win[kR][kC];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      best[r][c] = INFINITY;
      win[r][c] = 0;
    }
  }

  const float* lb = lines + (size_t)b * L * 4;
  const uint8_t* vb = valid + (size_t)b * L;
  int total = 0;
  for (int c0 = 0; c0 < L; c0 += chunk) {
    const int c1 = min(c0 + chunk, L);
    int n = 0;
    for (int i0 = c0; i0 < c1; i0 += kThreads) {
      // the row is read with its flag, so that one round trip to memory
      // serves both
      const int i = i0 + threadIdx.x;
      float x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f;
      bool ok = false;
      if (i < c1) {
        const float* l = lb + 4 * (size_t)i;
        x1 = l[0];
        y1 = l[1];
        x2 = l[2];
        y2 = l[3];
        ok = vb[i] != 0;
      }
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) s_count[warp] = __popc(m);
      __syncthreads();
      int pos = n + __popc(m & ((1u << lane) - 1u));
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int cw = s_count[w];
        pos += (w < warp) ? cw : 0;
        n += cw;
      }
      if (ok) {
        const Segment s = make_segment(x1, y1, x2, y2);
        s_seg[2 * pos] = make_float4(s.x1, s.y1, s.dx, s.dy);
        s_seg[2 * pos + 1] = make_float4(s.rcp, s.den, __int_as_float(i), 0.f);
      }
      __syncthreads();
    }

    // warp w takes the records w, w + kWarps, ...: each warp walks its
    // share in index order, so it keeps the first minimum of its share
    for (int k = warp; k < n; k += kWarps) {
      const float4 g = s_seg[2 * k];      // x1, y1, dx, dy
      const float4 h = s_seg[2 * k + 1];  // rcp, den, index
      float tx[kC], ty[kR];
#pragma unroll
      for (int c = 0; c < kC; ++c) tx[c] = (px[c] - g.x) * g.z;
#pragma unroll
      for (int r = 0; r < kR; ++r) ty[r] = (py[r] - g.y) * g.w;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float t = __saturatef(quotient(tx[c] + ty[r], h.y, h.x));
          const float ax = __fmaf_rn(t, g.z, g.x) - px[c];
          const float ay = __fmaf_rn(t, g.w, g.y) - py[r];
          const float d = __fmaf_rn(ax, ax, ay * ay);
          if (d < best[r][c]) {
            best[r][c] = d;
            win[r][c] = __float_as_int(h.z);
          }
        }
      }
    }
    total += n;
    __syncthreads();  // the next chunk overwrites the records
  }
  if (total == 0) {  // the same in every thread: no valid segment
    const int hw = H * W;
    for (int q = threadIdx.x; q < kTilePixels; q += kThreads) {
      const int x = tx0 + q % kTileW, y = ty0 + q / kTileW;
      if (x >= W || y >= H) continue;
      const size_t p = (size_t)y * W + x;
      afmap[(size_t)b * 2 * hw + p] = 0.f;
      afmap[(size_t)b * 2 * hw + hw + p] = 0.f;
      label[(size_t)b * hw + p] = 0;
    }
    return;
  }

#pragma unroll
  for (int r = 0; r < kR; ++r) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int q = (ly + kC * r) * kTileW + lx + kLanesX * c;
      s_best[warp][q] = best[r][c];
      s_win[warp][q] = win[r][c];
    }
  }
  __syncthreads();

  // one pixel of the tile per thread: the first minimum over the warps'
  // shares (the lower index on a tie), then the winner's offsets once
  // more, with the same operations in the same order as in the pair loop
  const int hw = H * W;
  const float rcp_w = __frcp_rn((float)W), rcp_h = __frcp_rn((float)H);
  for (int q = threadIdx.x; q < kTilePixels; q += kThreads) {
    const int x = tx0 + q % kTileW, y = ty0 + q / kTileW;
    if (x >= W || y >= H) continue;
    const size_t p = (size_t)y * W + x;
    float d = s_best[0][q];
    int k = s_win[0][q];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float dw = s_best[w][q];
      const int kw = s_win[w][q];
      if (dw < d || (dw == d && dw < INFINITY && kw < k)) {
        d = dw;
        k = kw;
      }
    }
    const float* l = lb + 4 * (size_t)k;
    const Segment s = make_segment(l[0], l[1], l[2], l[3]);
    const float fx = (float)x, fy = (float)y;
    const float num = (fx - s.x1) * s.dx + (fy - s.y1) * s.dy;
    const float t = __saturatef(quotient(num, s.den, s.rcp));
    const float ax = __fmaf_rn(t, s.dx, s.x1) - fx;
    const float ay = __fmaf_rn(t, s.dy, s.y1) - fy;
    afmap[(size_t)b * 2 * hw + p] = encode_offset(ax, (float)W, rcp_w);
    afmap[(size_t)b * 2 * hw + hw + p] = encode_offset(ay, (float)H, rcp_h);
    label[(size_t)b * hw + p] = k;
  }
}

// counts[0] += pairs whose quotient differs from __fdiv_rn other than by
// the sign of a zero; counts[1] += pairs that differ only by that sign
__global__ void division_check_kernel(const float* __restrict__ num, const float* __restrict__ den,
                                      long long n, unsigned long long* counts) {
  unsigned long long bad = 0, signed_zero = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float a = num[i], d = den[i];
    const float got = quotient(a, d, __frcp_rn(d));
    const float want = __fdiv_rn(a, d);
    if (__float_as_uint(got) == __float_as_uint(want) || (got != got && want != want)) continue;
    if (got == 0.f && want == 0.f) {
      ++signed_zero;
    } else {
      ++bad;
    }
  }
  if (bad) atomicAdd(&counts[0], bad);
  if (signed_zero) atomicAdd(&counts[1], signed_zero);
}

}  // namespace

// lines (B, L, 4) f32, valid (B, L) u8 (torch.bool), afmap (B, 2, H, W) f32,
// label (B, H, W) i32; all contiguous on the current device. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int afm_launch(const float* lines, const uint8_t* valid, float* afmap,
                          int32_t* label, int B, int L, int H, int W, void* stream) {
  if (B == 0 || H * W == 0) return 0;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int chunk = L < kChunk ? L : kChunk;
  const size_t smem = (size_t)chunk * 2 * sizeof(float4);
  afm_kernel<<<tiles_x * tiles_y * B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lines, valid, afmap, label, B, L, H, W, chunk, tiles_x);
  return (int)cudaGetLastError();
}

// The tile and chunk this file was built with: {kR, kC, kWarps, kChunk}.
extern "C" void afm_config(int* out) {
  out[0] = kR;
  out[1] = kC;
  out[2] = kWarps;
  out[3] = kChunk;
}

// Holds the kernel's quotient to __fdiv_rn over n pairs (num, den), adding
// to counts (2 x u64, on the device). Returns the cudaError_t of the launch.
extern "C" int afm_division_check(const float* num, const float* den, long long n,
                                  unsigned long long* counts, void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + 255) / 256;
  division_check_kernel<<<blocks < 4096 ? (int)blocks : 4096, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      num, den, n, counts);
  return (int)cudaGetLastError();
}
