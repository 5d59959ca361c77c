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
// A sample with no valid segment gets zeros.
//
// What bounds it: FP32 arithmetic, not memory. Every (pixel, valid segment)
// pair costs 18 FP32 operations, one of them an IEEE division that takes
// several instructions. At the HiSup main path (B=16, 224 x 224) that is
// 0.8 M pairs per valid segment of the batch, while the outputs are 9.6 MB
// (about 3 us at 3.35 TB/s) and the inputs a few KB.
//
// Design, kept simple:
//   - one thread per pixel, grid (ceil(H*W / 256), B); the ragged edge is
//     masked, so there is no constraint on H or W;
//   - warp 0 of each block compacts the sample's valid segments, with their
//     original index, into shared memory (L * 24 bytes), so padding rows cost
//     nothing in the pixel loop;
//   - every lane of a warp walks the same segment list (no divergence);
//   - stores are coalesced along x;
//   - the kernel allocates nothing and launches on the caller's stream.
//
// Labels are bit-exact with the plain version: this file is compiled with
// --fmad=false and IEEE division (no --use_fast_math), and every expression
// keeps the plain version's order of operations, so each distance rounds
// the same way and the first minimum is the same segment. The three
// multiply-adds that the JAX package fuses on the CPU (dx*dx + dy*dy,
// x1 + t*dx, ax*ax + ay*ay; see ops/afm.py) are explicit __fmaf_rn here and
// fused the same way in the plain version; nothing else is contracted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float encode_offset(float a, float size) {
  const float s = (a > 0.f) ? 1.f : ((a < 0.f) ? -1.f : 0.f);
  return (-s) * logf(fabsf(a / size) + 1e-6f);
}

__global__ void __launch_bounds__(kThreads)
afm_kernel(const float* __restrict__ lines, const uint8_t* __restrict__ valid,
           float* __restrict__ afmap, int32_t* __restrict__ label,
           int L, int H, int W) {
  extern __shared__ float smem[];
  float* s_x1 = smem;
  float* s_y1 = s_x1 + L;
  float* s_dx = s_y1 + L;
  float* s_dy = s_dx + L;
  float* s_den = s_dy + L;
  int* s_idx = reinterpret_cast<int*>(s_den + L);
  __shared__ int s_n;

  const int b = blockIdx.y;
  const float* lb = lines + (size_t)b * L * 4;
  const uint8_t* vb = valid + (size_t)b * L;

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
    for (int i0 = 0; i0 < L; i0 += 32) {
      const int i = i0 + lane;
      const bool ok = i < L && vb[i] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const int pos = base + __popc(m & ((1u << lane) - 1u));
        const float x1 = lb[4 * i + 0];
        const float y1 = lb[4 * i + 1];
        const float dx = lb[4 * i + 2] - x1;
        const float dy = lb[4 * i + 3] - y1;
        s_x1[pos] = x1;
        s_y1[pos] = y1;
        s_dx[pos] = dx;
        s_dy[pos] = dy;
        s_den[pos] = __fmaf_rn(dx, dx, dy * dy) + 1e-6f;
        s_idx[pos] = i;
      }
      base += __popc(m);
    }
    if (lane == 0) s_n = base;
  }
  __syncthreads();

  const int hw = H * W;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  float* out_x = afmap + (size_t)b * 2 * hw;
  float* out_y = out_x + hw;
  int32_t* out_l = label + (size_t)b * hw;
  const int n = s_n;
  if (n == 0) {
    out_x[p] = 0.f;
    out_y[p] = 0.f;
    out_l[p] = 0;
    return;
  }

  const float px = (float)(p % W);
  const float py = (float)(p / W);
  float best = INFINITY;
  float bax = 0.f, bay = 0.f;
  int bidx = 0;
  for (int k = 0; k < n; ++k) {
    const float x1 = s_x1[k];
    const float y1 = s_y1[k];
    const float dx = s_dx[k];
    const float dy = s_dy[k];
    float t = ((px - x1) * dx + (py - y1) * dy) / s_den[k];
    t = fminf(fmaxf(t, 0.f), 1.f);
    const float ax = __fmaf_rn(t, dx, x1) - px;
    const float ay = __fmaf_rn(t, dy, y1) - py;
    const float d = __fmaf_rn(ax, ax, ay * ay);
    if (d < best) {
      best = d;
      bax = ax;
      bay = ay;
      bidx = s_idx[k];
    }
  }
  out_x[p] = encode_offset(bax, (float)W);
  out_y[p] = encode_offset(bay, (float)H);
  out_l[p] = bidx;
}

}  // namespace

// lines (B, L, 4) f32, valid (B, L) u8 (torch.bool), afmap (B, 2, H, W) f32,
// label (B, H, W) i32; all contiguous on the current device. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int afm_launch(const float* lines, const uint8_t* valid, float* afmap,
                          int32_t* label, int B, int L, int H, int W, void* stream) {
  if (B == 0 || H * W == 0) return 0;
  const dim3 grid((H * W + kThreads - 1) / kThreads, B);
  const size_t smem = (size_t)L * (5 * sizeof(float) + sizeof(int));
  afm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      lines, valid, afmap, label, L, H, W);
  return (int)cudaGetLastError();
}
