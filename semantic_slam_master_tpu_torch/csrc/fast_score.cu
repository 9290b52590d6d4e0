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
// Bound on the H100: memory, 8 bytes a pixel (read once, written once),
// once the early test below has removed most of the arithmetic. The full
// 16-point chain is ~163 f32 compares, subtracts, max and adds, which
// issue at half the FMA rate; run on every pixel it would cost about twice
// the bytes' time. The design:
// - Any arc of 9 of the 16 points holds two circularly adjacent compass
//   points (0, 4, 8, 12) of its polarity. A pixel with no such pair, bright
//   or dark, scores exactly 0.0f, so only the pixels that pass this 4-point
//   test run the chain (fast_candidates_plain in the wrapper module).
// - A block of 8 warps stages a zero-padded (16 + 6) x (128 + 8) halo
//   tile of the frame in shared memory with 16-byte cp.async copies
//   (scalar loads on a ragged edge or a width that is not a multiple of
//   4), every copy in flight at once: ~1.5 reads per output, no division
//   per element, ~6.6 k blocks of 2,048 pixels per 16-frame chunk.
// - Each warp owns 2 tile rows, each lane 4 adjacent columns of them: the
//   4-point test reads the tile as float4s. The warp then compacts its
//   candidates into a list in shared memory, so the 16-point chain runs on
//   full warps of candidates; it reads the tile at compile-time offsets
//   from one base address. Results go through a shared output tile, so
//   every row is stored with 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 3;
constexpr int kTileW = 128;                // output columns per tile
constexpr int kPad = 4;                    // left halo, rounded up to a float4
constexpr int kPitch = kTileW + 2 * kPad;  // 136 floats per staged row
constexpr int kChunks = kPitch / 4;        // float4s per staged row
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 2;
constexpr int kTileH = kWarps * kRowsPerWarp;  // output rows per tile
constexpr int kRows = kTileH + 2 * kR;         // staged rows

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ bool arc9(uint32_t w) {
  uint32_t d = w | (w << 16);
  uint32_t c3 = d & (d >> 1) & (d >> 2);
  uint32_t c9 = c3 & (c3 >> 3) & (c3 >> 6);
  return (c9 & 0xFFFFu) != 0u;
}

// The FAST-9 response of the pixel whose centre is at p in the staged tile.
__device__ __forceinline__ float fast9(const float* p, float t) {
  constexpr int kOff[16] = {
      -3 * kPitch,     -3 * kPitch + 1, -2 * kPitch + 2, -kPitch + 3,
      3,               kPitch + 3,      2 * kPitch + 2,  3 * kPitch + 1,
      3 * kPitch,      3 * kPitch - 1,  2 * kPitch - 2,  kPitch - 3,
      -3,              -kPitch - 3,     -2 * kPitch - 2, -3 * kPitch - 1};
  const float c = p[0];
  uint32_t wb = 0u, wd = 0u;
  float bright = 0.0f, dark = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float diff = p[kOff[i]] - c;
    wb |= (diff > t ? 1u : 0u) << i;
    wd |= (diff < -t ? 1u : 0u) << i;
    bright += fmaxf(diff - t, 0.0f);
    dark += fmaxf(-diff - t, 0.0f);
  }
  const bool is_b = arc9(wb);
  const bool is_d = arc9(wd);
  const float score = (is_b ? bright : 0.0f) + (is_d ? dark : 0.0f);
  return (is_b || is_d) ? score : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
    fast_score_kernel(const float* __restrict__ img, float* __restrict__ out, int H, int W, float t,
                      bool vec) {
  __shared__ __align__(16) float tile[kRows * kPitch];
  __shared__ __align__(16) float res[kTileH * kTileW];
  __shared__ uint16_t cand_list[kWarps][kRowsPerWarp * kTileW];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const float* frame = img + (size_t)b * H * W;

  // Stage the halo tile: staged (row, col) is pixel (y0 - 3 + row, x0 - 4 + col), 0 outside.
  for (int k = threadIdx.x; k < kRows * kChunks; k += kThreads) {
    const int sr = k / kChunks;
    const int gy = y0 - kR + sr;
    const int gx = x0 - kPad + 4 * (k - sr * kChunks);
    float* dst = tile + 4 * k;
    if (gy < 0 || gy >= H || gx + 3 < 0 || gx >= W) {
      *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      continue;
    }
    const float* row = frame + (size_t)gy * W;
    if (vec && gx >= 0 && gx + 3 < W) {
      cp_async16(dst, row + gx);
    } else {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gx >= 0) v.x = row[gx];
      if (gx + 1 >= 0 && gx + 1 < W) v.y = row[gx + 1];
      if (gx + 2 >= 0 && gx + 2 < W) v.z = row[gx + 2];
      if (gx + 3 < W) v.w = row[gx + 3];
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = 4 * lane;  // this lane's first tile column
  const int x = x0 + col;
  const float4* t4 = reinterpret_cast<const float4*>(tile);

  // Candidates among this lane's 4 x kRowsPerWarp pixels: bit 4 * j + q.
  uint32_t cand = 0u;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp * kRowsPerWarp + j;
    reinterpret_cast<float4*>(res)[(r * kTileW + col) / 4] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (y0 + r >= H) continue;
    const float4 up = t4[r * kChunks + lane + 1];
    const float4 dn = t4[(r + 6) * kChunks + lane + 1];
    const float4 m0 = t4[(r + 3) * kChunks + lane];
    const float4 m1 = t4[(r + 3) * kChunks + lane + 1];
    const float4 m2 = t4[(r + 3) * kChunks + lane + 2];
    const float m[12] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w, m2.x, m2.y, m2.z, m2.w};
    const float u[4] = {up.x, up.y, up.z, up.w};
    const float d[4] = {dn.x, dn.y, dn.z, dn.w};
    uint32_t pass = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float c = m[4 + q];
      const float d0 = u[q] - c, d4 = m[7 + q] - c, d8 = d[q] - c, d12 = m[1 + q] - c;
      const bool bright = (d0 > t || d8 > t) && (d4 > t || d12 > t);
      const bool dark = (d0 < -t || d8 < -t) && (d4 < -t || d12 < -t);
      pass |= (bright || dark ? 1u : 0u) << q;
    }
    const int in_row = W - x;  // columns of this lane inside the frame
    const uint32_t inside = in_row >= 4 ? 0xFu : (in_row > 0 ? (1u << in_row) - 1u : 0u);
    cand |= (pass & inside) << (4 * j);
  }

  // Compact the warp's candidates into its list, then run the chain on them.
  const int n = __popc(cand);
  int incl = n;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, s);
    if (lane >= s) incl += v;
  }
  const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  int slot = incl - n;
  uint16_t* list = cand_list[warp];
  while (cand) {
    const int bit = __ffs(cand) - 1;
    cand &= cand - 1u;
    list[slot++] = (uint16_t)((bit >> 2) * kTileW + col + (bit & 3));
  }
  __syncwarp();
  for (int k = lane; k < total; k += 32) {
    const int e = list[k];
    const int r = warp * kRowsPerWarp + e / kTileW;
    const int c = e % kTileW;
    res[r * kTileW + c] = fast9(&tile[(r + kR) * kPitch + c + kPad], t);
  }
  __syncwarp();

  // Store this warp's rows.
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp * kRowsPerWarp + j;
    const int y = y0 + r;
    if (y >= H || x >= W) continue;
    const float4 v = reinterpret_cast<const float4*>(res)[(r * kTileW + col) / 4];
    float* dst = out + (size_t)b * H * W + (size_t)y * W + x;
    if (vec && x + 3 < W) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      dst[0] = v.x;
      if (x + 1 < W) dst[1] = v.y;
      if (x + 2 < W) dst[2] = v.z;
      if (x + 3 < W) dst[3] = v.w;
    }
  }
}

}  // namespace

extern "C" int semslam_fast_score(const void* img, void* out, int B, int H, int W,
                                  float threshold, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (B > 65535) return (int)cudaErrorInvalidValue;  // frames ride on gridDim.z
  // 16-byte copies and stores need 16-byte aligned rows.
  const bool vec = (W % 4 == 0) && ((reinterpret_cast<uintptr_t>(img) | reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  fast_score_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const float*)img, (float*)out, H, W, threshold,
                                                                 vec);
  return (int)cudaGetLastError();
}
