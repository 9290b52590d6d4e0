// Square keypoint patch gather (a pure copy), f32 in and out.
//
// Replaces the TPU kernel semantic_slam_master_tpu/ops/pallas/patches.py
// (gather_patches_pallas / _patch_kernel) and the XLA gather it is the
// twin of, ops/sampling.py::gather_patches, which the learned frontend's
// sub-patch refinement calls (models/frontend.py, refine_at: 21x21
// windows, radius 10).
//
// For keypoint n of frame b: cx = clamp(rint(x), x_lo, x_hi),
// cy = clamp(rint(y), y_lo, y_hi) (rint rounds half to even like
// jnp.round), and out[b, n, i, j] = img[b, cy - r + i, cx - r + j] for
// i, j < side. The two callers differ only in side and clamp:
//   gather_patches         side 2r+1, clamp [r, W-1-r] x [r, H-1-r];
//   gather_patches_padded  side 32,   clamp [r, W-(32-r)] x [r, H-(32-r)]
//                          (the Pallas kernel's padded window).
// The wrapper checks that the clamped window lies inside the frame.
//
// Bound on the H100: memory, and the latency of scattered row reads.
// Per keypoint it reads side^2 f32 (21 rows of 84 bytes at the path's
// radius) and writes side^2 f32 contiguously; there is no arithmetic.
// The TPU kernel issued one DMA per patch, whose 8/128-aligned start
// rule made it a recorded negative result there; on the card a gather
// has no alignment rule. One 128-thread block serves one keypoint and
// walks the flattened window: consecutive threads take consecutive
// pixels, so each warp reads one or two row segments and writes 128
// contiguous bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void gather_patches_kernel(const float* __restrict__ img,
                                      const float* __restrict__ centers,
                                      float* __restrict__ out, int N, int H,
                                      int W, int radius, int side, int x_lo,
                                      int x_hi, int y_lo, int y_hi) {
  const int kp = blockIdx.x;  // b * N + n
  const int b = kp / N;
  const float fx = rintf(centers[2 * (size_t)kp]);
  const float fy = rintf(centers[2 * (size_t)kp + 1]);
  const int cx = (int)fminf(fmaxf(fx, (float)x_lo), (float)x_hi);
  const int cy = (int)fminf(fmaxf(fy, (float)y_lo), (float)y_hi);
  const float* src =
      img + (size_t)b * H * W + (size_t)(cy - radius) * W + (cx - radius);
  float* dst = out + (size_t)kp * side * side;
  const int count = side * side;
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const int i = k / side;
    const int j = k - i * side;
    dst[k] = src[(size_t)i * W + j];
  }
}

}  // namespace

extern "C" int semslam_gather_patches(const void* img, const void* centers,
                                      void* out, int B, int N, int H, int W,
                                      int radius, int side, int x_lo, int x_hi,
                                      int y_lo, int y_hi, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  gather_patches_kernel<<<B * N, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)centers, (float*)out, N, H, W, radius,
      side, x_lo, x_hi, y_lo, y_hi);
  return (int)cudaGetLastError();
}
