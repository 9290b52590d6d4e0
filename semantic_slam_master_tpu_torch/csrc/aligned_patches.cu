// Aligned 32x32 keypoint patch gather with fused u8 quantisation.
//
// Replaces the TPU kernel semantic_slam_master_tpu/ops/pallas/patches.py
// (gather_aligned_patches / _aligned_patch_kernel), the patch source of
// ops/orb.py::describe_matmul.
//
// For keypoint n of frame b: cx = clamp(rint(x), 15, W - 18),
// cy = clamp(rint(y), 15, H - 17) (ops/orb.py::_patch_centers; rint rounds
// half to even like jnp.round), and out[b, n, r, c] =
// q(img[b, cy - 15 + r, cx - 15 + c]) with the quantiser
// q(v) = rint(min(max(v, 0), 1) * 255) of ops/orb.py::_quantize_u8, stored
// as bf16 (integers <= 255 are exact there), ready for the bf16 all-bin
// descriptor product.
//
// Bound on the H100: memory, and latency of scattered reads. Per keypoint
// it reads 4 KB (32 rows of 32 f32) and writes 2 KB; there is no
// arithmetic to speak of. The TPU kernel needed 8/128-aligned DMA
// supersets and an in-VMEM roll; here a direct gather has no alignment
// rule, so each warp reads one 32-pixel patch row (128 contiguous bytes,
// coalesced) and writes one 64-byte bf16 row. One 256-thread block serves
// one keypoint: 8 warps x 4 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 32;
constexpr int kRadius = 15;
constexpr int kThreads = 256;

__global__ void aligned_patches_kernel(const float* __restrict__ img,
                                       const float* __restrict__ xy,
                                       __nv_bfloat16* __restrict__ out, int N,
                                       int H, int W) {
  const int kp = blockIdx.x;  // b * N + n
  const int b = kp / N;
  const float fx = rintf(xy[2 * (size_t)kp]);
  const float fy = rintf(xy[2 * (size_t)kp + 1]);
  const int cx = (int)fminf(fmaxf(fx, (float)kRadius), (float)(W - 18));
  const int cy = (int)fminf(fmaxf(fy, (float)kRadius), (float)(H - 17));
  const float* src =
      img + (size_t)b * H * W + (size_t)(cy - kRadius) * W + (cx - kRadius);
  __nv_bfloat16* dst = out + (size_t)kp * kPatch * kPatch;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = warp; r < kPatch; r += kThreads / 32) {
    const float v = src[(size_t)r * W + lane];
    const float q = rintf(fminf(fmaxf(v, 0.0f), 1.0f) * 255.0f);
    dst[r * kPatch + lane] = __float2bfloat16_rn(q);
  }
}

}  // namespace

extern "C" int semslam_aligned_patches(const void* img, const void* xy,
                                       void* out, int B, int N, int H, int W,
                                       void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  aligned_patches_kernel<<<B * N, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)xy, (__nv_bfloat16*)out, N, H, W);
  return (int)cudaGetLastError();
}
