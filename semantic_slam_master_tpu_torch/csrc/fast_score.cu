// FAST-9 corner response, one pass over the frame.
//
// Replaces the TPU kernel semantic_slam_master_tpu/ops/pallas/fast_score.py
// (fast_score_pallas / _fast_kernel / _arc9_word).
//
// Computes, for every pixel of a (B, H, W) float32 frame in [0, 1], the
// 16 Bresenham-circle differences nb - centre (neighbours outside the
// frame read 0, as the JAX package's _circle_stack does), packs the
// brighter / darker polarity bits into two words, runs the arc-of-9 test
// d = w | w << 16; c3 = d & d >> 1 & d >> 2; c9 = c3 & c3 >> 3 & c3 >> 6,
// and writes the sum of the winning polarity's margins beyond the
// threshold (0 where neither polarity has an arc of 9). Margins are
// accumulated in circle order i = 0..15 in f32, the order of the plain
// PyTorch version, so the two agree bit for bit.
//
// Bound on the H100: memory. The work is ~100 f32 operations per pixel
// against 8 bytes moved (read once, write once), far below the card's
// operations-per-byte balance. The design therefore touches device memory
// once: a 32x8 block stages its (8+6) x (32+6) halo tile in shared memory
// with coalesced row loads, and every intermediate (the 16 differences,
// both words, both margin sums) stays in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kR = 3;
constexpr int kSmemW = kTileW + 2 * kR;
constexpr int kSmemH = kTileH + 2 * kR;

__constant__ int kCircleDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kCircleDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ bool arc9(uint32_t w) {
  uint32_t d = w | (w << 16);
  uint32_t c3 = d & (d >> 1) & (d >> 2);
  uint32_t c9 = c3 & (c3 >> 3) & (c3 >> 6);
  return (c9 & 0xFFFFu) != 0u;
}

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, int H, int W,
                                  float t) {
  __shared__ float tile[kSmemH][kSmemW];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const float* frame = img + (size_t)b * H * W;

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int k = tid; k < kSmemH * kSmemW; k += kTileW * kTileH) {
    const int sy = k / kSmemW;
    const int sx = k - sy * kSmemW;
    const int gy = y0 + sy - kR;
    const int gx = x0 + sx - kR;
    tile[sy][sx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? frame[(size_t)gy * W + gx]
                       : 0.0f;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;

  const int cy = threadIdx.y + kR;
  const int cx = threadIdx.x + kR;
  const float c = tile[cy][cx];
  uint32_t wb = 0u, wd = 0u;
  float bright = 0.0f, dark = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float diff = tile[cy + kCircleDy[i]][cx + kCircleDx[i]] - c;
    wb |= (diff > t ? 1u : 0u) << i;
    wd |= (diff < -t ? 1u : 0u) << i;
    bright += fmaxf(diff - t, 0.0f);
    dark += fmaxf(-diff - t, 0.0f);
  }
  const bool is_b = arc9(wb);
  const bool is_d = arc9(wd);
  const float score = (is_b ? bright : 0.0f) + (is_d ? dark : 0.0f);
  out[(size_t)b * H * W + (size_t)y * W + x] = (is_b || is_d) ? score : 0.0f;
}

}  // namespace

extern "C" int semslam_fast_score(const void* img, void* out, int B, int H,
                                  int W, float threshold, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  dim3 block(kTileW, kTileH, 1);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  fast_score_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)img, (float*)out, H, W, threshold);
  return (int)cudaGetLastError();
}
