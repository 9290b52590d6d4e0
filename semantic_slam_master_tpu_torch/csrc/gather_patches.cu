// Square keypoint patch gather (a pure copy), f32 in and out.
//
// Replaces the XLA gather semantic_slam_master_tpu/ops/sampling.py::
// gather_patches, which the learned frontend's sub-patch refinement calls
// (models/frontend.py, refine_at: 21x21 windows, radius 10), and its
// Pallas twin ops/pallas/patches.py::gather_patches_pallas, which no JAX
// path calls (kept in interpret mode; its 32x32 form is the padded mode
// here, which no path of the port calls either).
//
// For keypoint n of frame b: cx = clamp(rint(x), x_lo, x_hi),
// cy = clamp(rint(y), y_lo, y_hi) (rint rounds half to even like
// jnp.round; +-inf saturate and NaN lands on the low bound, as XLA's
// float-to-int32 conversion (NaN to 0) before its clip, since every low
// bound is >= 0), and out[b, n, i, j] =
// img[b, cy - r + i, cx - r + j] for i, j < side. The two callers differ
// only in side and clamp:
//   gather_patches         side 2r+1, clamp [r, W-1-r] x [r, H-1-r];
//   gather_patches_padded  side 32,   clamp [r, W-(32-r)] x [r, H-(32-r)]
//                          (the Pallas kernel's padded window).
// The wrapper checks that the clamped window lies inside the frame.
//
// Bound on the H100: memory, and the latency of the centre read followed
// by the scattered row reads. Per keypoint it reads side^2 f32 (21 rows of
// 84 bytes at the path's radius) and writes side^2 f32 contiguously;
// there is no arithmetic. The TPU kernel issued one DMA per patch, whose
// 8/128-aligned start rule made it a recorded negative result there; on
// the card a gather has no alignment rule. The design:
// - one warp per keypoint, 8 consecutive keypoints (flat b * N + n) per
//   256-thread block: the path's 8 x 500 keypoints are 500 blocks, one
//   wave; the warp reads its centre's two floats as broadcast loads;
// - lane l takes the window's flattened elements k = l + 32 t, so each
//   warp-wide load covers 32 consecutive window pixels (one or two row
//   segments) and each warp-wide store 128 contiguous bytes of the output,
//   which is the window in the same order: no shared memory, no barrier;
// - every load of a lane is issued before its first store (14 in flight
//   per lane at radius 10), through the read-only path; a lane walks
//   (row, column) by constant steps, without a division per element;
// - 16 slots per lane, so a pass covers 512 window pixels (the path's
//   441 in one pass, the padded mode's 1,024 in two) and the kernel fits
//   40 registers (6 blocks per SM) without spilling.
// Staging the block's windows in shared memory for 16-byte stores, rows
// per lane instead of the flat order, 4 keypoints per block and other
// register caps were slower on the H100 (PERF.md, section 6).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // keypoints per block
constexpr int kThreads = 32 * kWarps;

constexpr int kSlots = 16;  // window pixels per lane and pass

// clamp(rint(v), lo, hi), clamped in float so that +-inf and values past
// the int range saturate; fmaxf takes lo for NaN.
__device__ __forceinline__ int round_clip(float v, int lo, int hi) {
  return (int)fminf(fmaxf(rintf(v), (float)lo), (float)hi);
}

__global__ void __launch_bounds__(kThreads, 6)
    gather_patches_kernel(const float* __restrict__ img, const float* __restrict__ centers,
                          float* __restrict__ out, int total, int N, int H, int W, int radius, int side,
                          int x_lo, int x_hi, int y_lo, int y_hi) {
  const int lane = threadIdx.x & 31;
  const int kp = blockIdx.x * kWarps + (threadIdx.x >> 5);  // b * N + n
  if (kp >= total) return;
  const int area = side * side;
  const int x0 = round_clip(__ldg(centers + 2 * kp), x_lo, x_hi) - radius;
  const int y0 = round_clip(__ldg(centers + 2 * kp + 1), y_lo, y_hi) - radius;
  const float* src = img + (size_t)(kp / N) * H * W + (size_t)y0 * W + x0;
  float* dst = out + (size_t)kp * area;
  // Element k + 32 lies step_i rows and step_j columns past element k,
  // plus one row when the column wraps.
  const int step_i = 32 / side;
  const int step_j = 32 - step_i * side;
  for (int k0 = 0; k0 < area; k0 += 32 * kSlots) {
    int i = (k0 + lane) / side;
    int j = (k0 + lane) - i * side;
    float v[kSlots];
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      if (k0 + lane + 32 * t < area) v[t] = __ldg(src + (size_t)i * W + j);
      i += step_i;
      j += step_j;
      if (j >= side) {
        j -= side;
        ++i;
      }
    }
#pragma unroll
    for (int t = 0; t < kSlots; ++t)
      if (k0 + lane + 32 * t < area) dst[k0 + lane + 32 * t] = v[t];
  }
}

}  // namespace

extern "C" int semslam_gather_patches(const void* img, const void* centers, void* out, int B, int N, int H,
                                      int W, int radius, int side, int x_lo, int x_hi, int y_lo, int y_hi,
                                      void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const int total = B * N;
  const int blocks = (total + kWarps - 1) / kWarps;
  gather_patches_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)centers, (float*)out, total, N, H, W, radius, side, x_lo, x_hi, y_lo,
      y_hi);
  return (int)cudaGetLastError();
}
