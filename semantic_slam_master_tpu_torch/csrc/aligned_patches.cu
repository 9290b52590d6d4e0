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
// Bound on the H100: memory. Per keypoint it reads 4 KB (32 rows of 32
// f32, shared in part with its neighbours) and writes 2 KB; there is no
// arithmetic to speak of. What sets the time at the path's few thousand
// keypoints per launch is latency: the xy load, then the rows. The TPU
// kernel needed 8/128-aligned DMA supersets and an in-VMEM roll; on the
// card a gather has no alignment rule. The design:
// - one warp per keypoint, 8 keypoints per 256-thread block (the path's
//   largest launch, 16 x 202 keypoints, is 404 blocks, fewer than the
//   card holds at once);
// - lane c reads column c of all 32 rows into registers (32 independent
//   loads in flight, each warp-wide load one coalesced 128-byte row), then
//   quantises;
// - the bf16 patch goes through 2 KB of shared memory per warp so that
//   each lane writes it with four 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 32;
constexpr int kRadius = 15;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kStagePitch = kPatch + 8;  // bf16 per staged row: 80 bytes, 16-byte aligned

__device__ __forceinline__ float quantize(float v) {
  return rintf(fminf(fmaxf(v, 0.0f), 1.0f) * 255.0f);
}

// Clamped top-left corner (x, y) of keypoint xy's patch.
__device__ __forceinline__ int2 corner(float2 xy, int H, int W) {
  const int cx = (int)fminf(fmaxf(rintf(xy.x), (float)kRadius), (float)(W - 18));
  const int cy = (int)fminf(fmaxf(rintf(xy.y), (float)kRadius), (float)(H - 17));
  return make_int2(cx - kRadius, cy - kRadius);
}

__global__ void __launch_bounds__(kThreads)
    aligned_patches_kernel(const float* __restrict__ img, const float2* __restrict__ xy,
                           __nv_bfloat16* __restrict__ out, int total, int N, int H, int W) {
  __shared__ __align__(16) __nv_bfloat16 stage[kWarps][kPatch * kStagePitch];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kp = blockIdx.x * kWarps + warp;  // b * N + n
  if (kp >= total) return;
  __nv_bfloat16* st = stage[warp];
  const int2 o = corner(__ldg(xy + kp), H, W);
  const float* src = img + (size_t)(kp / N) * H * W + (size_t)o.y * W + o.x + lane;
  float v[kPatch];
#pragma unroll
  for (int r = 0; r < kPatch; ++r) v[r] = __ldg(src + (size_t)r * W);
#pragma unroll
  for (int r = 0; r < kPatch; ++r) st[r * kStagePitch + lane] = __float2bfloat16_rn(quantize(v[r]));
  __syncwarp();
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)kp * kPatch * kPatch);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = lane + 32 * k;  // 16-byte piece i: row i / 4, columns 8 * (i % 4) ...
    dst[i] = *reinterpret_cast<const uint4*>(st + (i >> 2) * kStagePitch + 8 * (i & 3));
  }
}

}  // namespace

extern "C" int semslam_aligned_patches(const void* img, const void* xy, void* out, int B, int N, int H,
                                       int W, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const int total = B * N;
  aligned_patches_kernel<<<(total + kWarps - 1) / kWarps, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float2*)xy, (__nv_bfloat16*)out, total, N, H, W);
  return (int)cudaGetLastError();
}
