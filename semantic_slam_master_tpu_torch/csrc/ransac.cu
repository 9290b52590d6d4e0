// The RANSAC hypotheses of one tracked frame in one launch: the inverse-CDF
// draw of 3 correspondences a hypothesis, a Horn-Kabsch fit of each, the
// inlier masks and semantic supports of all of them, the best one (first
// index among equal supports) and its inlier mask, f32 throughout.
//
// Replaces no TPU kernel: it is the span slam.ransac of
// slam/pnp.py::ransac_pose, which the JAX package runs under jit and the
// port ran as about 350 eager PyTorch launches a tracked frame (the draw's
// searchsorted and gathers, 64 Kabsch fits through some 40 small ops each
// step, two inlier counts over 64 x N and 1 x N residuals, the supports and
// their argmax) and two host syncs: the read of the 0-dim argmax when
// indexing Ts with it, and lie.make_pose's blocking copy of its constant
// row inside kabsch. The plain version is
// ops/kernels/ransac.py::ransac_plain; the draw's cumulative sum stays a
// PyTorch call ahead of this kernel (see below).
//
// Bound on the H100: latency. The work is tiny -- H = 64 fits of 3 points
// (about 2,000 f32 operations each, one after another: five squarings of a
// 4x4, three Rayleigh steps through a 4x4 inverse) and 64 x N reprojections
// (N = 500-512 on the SLAM paths, ~40 operations each) -- and every stage
// waits on the one before: draws, fits, scores, argmax, the best mask. One
// block runs them all; nothing returns to the host.
//
// The SLAM loop amplifies a difference in the last bit of a keyframe's pose
// through its window bundle adjustment (to 1e-5-1e-4 m in 60 frames), so the
// kernel gives the plain version's bits, not only its values: each operation
// is rounded as the plain version's PyTorch calls round it on the card (no
// fused multiply-adds; a tensor over a tensor is a true division), and each
// torch.sum as ATen's Reduce.cuh takes it:
// - over a middle dimension (mm_small's sums over 2 or 4, the centroids' and
//   the cross-covariance's sums over the 3 points): one thread, in order;
// - over a last dimension of L < 128 elements (mv_small's sums over 3 and
//   4, the row norms, the sums over the 16 entries of a 4x4, the 2-vector
//   norm of a residual): one lane an element, lanes last_pow2(L), extra
//   elements to the lane's next accumulator, then a halving tree across the
//   lanes (v[t] += v[t + s], s = lanes / 2 .. 1); so a sum of three is
//   (x0 + x2) + x1 and a sum of four (x0 + x2) + (x1 + x3);
// - every reduction starts from 0 (0 + x is +0 for x = -0);
// - a norm's squares are rounded one by one (fma(x, x, 0));
// - the supports torch.sum(masks * w_sem, dim=-1), a row of N for each of
//   the H hypotheses: Reduce.cuh's configuration for an (H, N) f32 tensor
//   reduced over its last dimension, computed from H and N by the launcher
//   as setReduceConfig does (lanes, and loads of four from 128 elements with
//   the unaligned head of a row whose start is not 16-byte aligned), four
//   accumulators a lane added in order, then the halving tree. That order
//   holds while no row is split across warps (fewer than 256 values a lane,
//   N up to 8,160 at H >= 16); beyond, the kernel agrees to rounding;
// - torch.argmax: the first index of the largest value, a NaN first;
// - torch.searchsorted: the same binary search over the cumulative sums.
// The cumulative sum itself is torch.cumsum's, a scan whose order this
// kernel does not copy: the wrapper calls it ahead of the launch and passes
// its result. So the kernel gives the plain version's bits in Ts, inls,
// supports, best, mask and w: measured on the H100 with PyTorch 2.11 / CUDA
// 12.8 at the SLAM paths' 500 and 512 correspondences and at 3 to 3,000,
// with 64 hypotheses, and with loop closing's 128. Where a PyTorch update
// changes a reduction's order, it agrees to rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 512;  // Reduce.cuh's largest block width for f32

struct Camera {
  float fx, fy, cx, cy;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
// A reduction's first step: its accumulator starts from 0.
__device__ __forceinline__ float z(float a) { return __fadd_rn(0.0f, a); }
// torch.clamp(x, min=lo) with lo > 0: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// torch.sum over a last dimension of 3 and of 4 (two and four lanes, a
// halving tree), and over a middle dimension of 2, 3 and 4 (in order).
__device__ __forceinline__ float lsum3(float a, float b, float c) { return add(add(z(a), z(c)), z(b)); }
__device__ __forceinline__ float lsum4(float a, float b, float c, float d) {
  return add(add(z(a), z(c)), add(z(b), z(d)));
}
__device__ __forceinline__ float osum2(float a, float b) { return add(z(a), z(b)); }
__device__ __forceinline__ float osum3(float a, float b, float c) { return add(add(z(a), z(b)), z(c)); }
__device__ __forceinline__ float osum4(float a, float b, float c, float d) {
  return add(add(add(z(a), z(b)), z(c)), z(d));
}

// torch.sum over the 16 entries of a 4x4: 16 lanes, a halving tree.
__device__ __forceinline__ float sum16(const float (&v)[16]) {
  float s[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) s[t] = add(z(v[t]), z(v[t + 8]));
#pragma unroll
  for (int t = 0; t < 4; ++t) s[t] = add(s[t], s[t + 4]);
#pragma unroll
  for (int t = 0; t < 2; ++t) s[t] = add(s[t], s[t + 2]);
  return add(s[0], s[1]);
}

// lie.mm_small of two 4x4s: C[i][j] = sum over k of A[i][k] B[k][j], in order.
__device__ __forceinline__ void mm4(const float (&A)[16], const float (&B)[16], float (&C)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      C[4 * i + j] = osum4(mul(A[4 * i], B[j]), mul(A[4 * i + 1], B[4 + j]), mul(A[4 * i + 2], B[8 + j]),
                           mul(A[4 * i + 3], B[12 + j]));
}

// lie.mv_small of a 4x4 and a 4-vector: a last-dimension sum of four.
__device__ __forceinline__ void mv4(const float (&A)[16], const float (&x)[4], float (&y)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y[i] = lsum4(mul(A[4 * i], x[0]), mul(A[4 * i + 1], x[1]), mul(A[4 * i + 2], x[2]), mul(A[4 * i + 3], x[3]));
}

// A 2x2 (row-major a b / c d) by slam/pnp.py::_inv4x4_sym's inv2.
__device__ __forceinline__ void inv2(float a, float b, float c, float d, float (&out)[4]) {
  float det = sub(mul(a, d), mul(b, c));
  det = fabsf(det) > 1e-30f ? det : 1e-30f;
  out[0] = quo(d, det);
  out[1] = quo(-b, det);
  out[2] = quo(-c, det);
  out[3] = quo(a, det);
}

// lie.mm_small of two 2x2s.
__device__ __forceinline__ void mm2(const float (&A)[4], const float (&B)[4], float (&C)[4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) C[2 * i + j] = osum2(mul(A[2 * i], B[j]), mul(A[2 * i + 1], B[2 + j]));
}

__device__ __forceinline__ void transpose2(const float (&A)[4], float (&T)[4]) {
  T[0] = A[0];
  T[1] = A[2];
  T[2] = A[1];
  T[3] = A[3];
}

// slam/pnp.py::_inv4x4_sym: 2x2 block elimination.
__device__ void inv4x4_sym(const float (&A)[16], float (&out)[16]) {
  float P_inv[4], Q[4], Qt[4], S[4];
  inv2(A[0], A[1], A[4], A[5], P_inv);
  Q[0] = A[2];
  Q[1] = A[3];
  Q[2] = A[6];
  Q[3] = A[7];
  S[0] = A[10];
  S[1] = A[11];
  S[2] = A[14];
  S[3] = A[15];
  transpose2(Q, Qt);
  float QtPi[4], QtPiQ[4], Sc_inv[4], PiQ[4], PiQSi[4], PiQt[4], corr[4];
  mm2(Qt, P_inv, QtPi);
  mm2(QtPi, Q, QtPiQ);
  inv2(sub(S[0], QtPiQ[0]), sub(S[1], QtPiQ[1]), sub(S[2], QtPiQ[2]), sub(S[3], QtPiQ[3]), Sc_inv);
  mm2(P_inv, Q, PiQ);
  mm2(PiQ, Sc_inv, PiQSi);
  transpose2(PiQ, PiQt);
  mm2(PiQSi, PiQt, corr);
  // TL = P_inv + corr; TR = -(PiQ Sc_inv); BL = TR^T; BR = Sc_inv.
  out[0] = add(P_inv[0], corr[0]);
  out[1] = add(P_inv[1], corr[1]);
  out[4] = add(P_inv[2], corr[2]);
  out[5] = add(P_inv[3], corr[3]);
  out[2] = -PiQSi[0];
  out[3] = -PiQSi[1];
  out[6] = -PiQSi[2];
  out[7] = -PiQSi[3];
  out[8] = -PiQSi[0];
  out[9] = -PiQSi[2];
  out[12] = -PiQSi[1];
  out[13] = -PiQSi[3];
  out[10] = Sc_inv[0];
  out[11] = Sc_inv[1];
  out[14] = Sc_inv[2];
  out[15] = Sc_inv[3];
}

// torch.argmax over n values: the first index of the largest, a NaN first.
__device__ __forceinline__ bool beats(float v, int i, float best_v, int best_i) {
  if (isnan(best_v)) return isnan(v) && i < best_i;
  if (isnan(v)) return true;
  return v > best_v || (v == best_v && i < best_i);
}

// slam/pnp.py::kabsch(src, dst) with unit weights (3 points, rows of
// src[3][3] and dst[3][3]) into the row-major 4x4 T.
__device__ void kabsch3(const float (&src)[3][3], const float (&dst)[3][3], float* T) {
  // w = ones / clamp(sum(ones)) = 1/3; centroids over the points.
  const float w = quo(1.0f, lsum3(1.0f, 1.0f, 1.0f));
  float mu_s[3], mu_d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    mu_s[k] = osum3(mul(src[0][k], w), mul(src[1][k], w), mul(src[2][k], w));
    mu_d[k] = osum3(mul(dst[0][k], w), mul(dst[1][k], w), mul(dst[2][k], w));
  }
  float sw[3][3], dc[3][3];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sw[p][k] = mul(sub(src[p][k], mu_s[k]), w);
      dc[p][k] = sub(dst[p][k], mu_d[k]);
    }
  float S[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) S[i][j] = osum3(mul(sw[0][i], dc[0][j]), mul(sw[1][i], dc[1][j]), mul(sw[2][i], dc[2][j]));
  const float sxx = S[0][0], sxy = S[0][1], sxz = S[0][2];
  const float syx = S[1][0], syy = S[1][1], syz = S[1][2];
  const float szx = S[2][0], szy = S[2][1], szz = S[2][2];
  const float N[16] = {
      add(add(sxx, syy), szz), sub(syz, szy),           sub(szx, sxz),           sub(sxy, syx),
      sub(syz, szy),           sub(sub(sxx, syy), szz), add(sxy, syx),           add(szx, sxz),
      sub(szx, sxz),           add(sxy, syx),           sub(add(-sxx, syy), szz), add(syz, szy),
      sub(sxy, syx),           add(szx, sxz),           add(syz, szy),           add(sub(-sxx, syy), szz),
  };
  float sq[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) sq[e] = mul(N[e], N[e]);
  const float c = add(root(sum16(sq)), 1e-12f);
  float P[16], PP[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) P[e] = quo(add(N[e], mul(c, e % 5 == 0 ? 1.0f : 0.0f)), c);
  // power_iters = 24: max(5, (24 + 5) // 6) normalised squarings.
#pragma unroll 1
  for (int it = 0; it < 5; ++it) {
    mm4(P, P, PP);
#pragma unroll
    for (int e = 0; e < 16; ++e) sq[e] = mul(PP[e], PP[e]);
    const float nrm = add(root(sum16(sq)), 1e-30f);
#pragma unroll
    for (int e = 0; e < 16; ++e) P[e] = quo(PP[e], nrm);
  }
  // Q: P's rows normalised; the row of the largest Rayleigh quotient.
  float Q[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* r = P + 4 * i;
    const float rn = clamp_min(root(lsum4(mul(r[0], r[0]), mul(r[1], r[1]), mul(r[2], r[2]), mul(r[3], r[3]))), 1e-20f);
#pragma unroll
    for (int j = 0; j < 4; ++j) Q[4 * i + j] = quo(r[j], rn);
  }
  mm4(Q, N, PP);
  int bi = 0;
  float bv = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float mu = lsum4(mul(PP[4 * i], Q[4 * i]), mul(PP[4 * i + 1], Q[4 * i + 1]), mul(PP[4 * i + 2], Q[4 * i + 2]),
                           mul(PP[4 * i + 3], Q[4 * i + 3]));
    if (i == 0 || beats(mu, i, bv, bi)) {
      bv = mu;
      bi = i;
    }
  }
  float q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = Q[4 * bi + j];
  // Three Rayleigh-quotient steps.
  const float shift_c = mul(c, 1e-6f);
#pragma unroll 1
  for (int it = 0; it < 3; ++it) {
    float Nq[4], x[4];
    mv4(N, q, Nq);
    const float mu = lsum4(mul(q[0], Nq[0]), mul(q[1], Nq[1]), mul(q[2], Nq[2]), mul(q[3], Nq[3]));
    const float s = sub(mu, shift_c);
    float shifted[16], inv[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) shifted[e] = sub(N[e], mul(s, e % 5 == 0 ? 1.0f : 0.0f));
    inv4x4_sym(shifted, inv);
    mv4(inv, q, x);
    const float n = root(lsum4(mul(x[0], x[0]), mul(x[1], x[1]), mul(x[2], x[2]), mul(x[3], x[3])));
    if (n > 1e-18f) {
      const float nc = clamp_min(n, 1e-30f);
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = quo(x[j], nc);
    }
  }
  // lie.quat_to_matrix of (q1, q2, q3, q0): normalised (its norm's four
  // squares in two lanes' halving order), then the rotation.
  const float qn = clamp_min(root(lsum4(mul(q[1], q[1]), mul(q[2], q[2]), mul(q[3], q[3]), mul(q[0], q[0]))), 1e-8f);
  const float qx = quo(q[1], qn), qy = quo(q[2], qn), qz = quo(q[3], qn), qw = quo(q[0], qn);
  const float xx = mul(qx, qx), yy = mul(qy, qy), zz = mul(qz, qz);
  float R[3][3];
  R[0][0] = sub(1.0f, mul(2.0f, add(yy, zz)));
  R[0][1] = mul(2.0f, sub(mul(qx, qy), mul(qz, qw)));
  R[0][2] = mul(2.0f, add(mul(qx, qz), mul(qy, qw)));
  R[1][0] = mul(2.0f, add(mul(qx, qy), mul(qz, qw)));
  R[1][1] = sub(1.0f, mul(2.0f, add(xx, zz)));
  R[1][2] = mul(2.0f, sub(mul(qy, qz), mul(qx, qw)));
  R[2][0] = mul(2.0f, sub(mul(qx, qz), mul(qy, qw)));
  R[2][1] = mul(2.0f, add(mul(qy, qz), mul(qx, qw)));
  R[2][2] = sub(1.0f, mul(2.0f, add(xx, yy)));
  // t = mu_d - R mu_s; the pose [R t; 0 0 0 1] (lie.make_pose).
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T[4 * i] = R[i][0];
    T[4 * i + 1] = R[i][1];
    T[4 * i + 2] = R[i][2];
    T[4 * i + 3] = sub(mu_d[i], lsum3(mul(R[i][0], mu_s[0]), mul(R[i][1], mu_s[1]), mul(R[i][2], mu_s[2])));
  }
  T[12] = 0.0f;
  T[13] = 0.0f;
  T[14] = 0.0f;
  T[15] = 1.0f;
}

// slam/pnp.py::count_inliers' test of point i under the pose T (row-major,
// the first 12 entries): lie.transform_points, camera.project with its
// |z| < 1e-6 clamp, ||proj - obs|| < threshold, depth > 0.05, valid.
__device__ __forceinline__ bool is_inlier(const float (&T)[12], const float* __restrict__ pts,
                                          const float* __restrict__ obs, const bool* __restrict__ valid, int i,
                                          const Camera& cam, float threshold) {
  const float px = __ldg(pts + 3 * i), py = __ldg(pts + 3 * i + 1), pz = __ldg(pts + 3 * i + 2);
  const float x = add(lsum3(mul(px, T[0]), mul(py, T[1]), mul(pz, T[2])), T[3]);
  const float y = add(lsum3(mul(px, T[4]), mul(py, T[5]), mul(pz, T[6])), T[7]);
  const float zc = add(lsum3(mul(px, T[8]), mul(py, T[9]), mul(pz, T[10])), T[11]);
  const float zs = fabsf(zc) < 1e-6f ? 1e-6f : zc;
  const float rx = sub(add(quo(mul(cam.fx, x), zs), cam.cx), __ldg(obs + 2 * i));
  const float ry = sub(add(quo(mul(cam.fy, y), zs), cam.cy), __ldg(obs + 2 * i + 1));
  const float rn = root(add(mul(rx, rx), mul(ry, ry)));
  return (rn < threshold) & (zc > 0.05f) & valid[i];
}

// Lane t's partial sum of one row of the (H, N) tensor masks * w_sem, as
// Reduce.cuh's thread_reduce takes it (the head of this file); value(e)
// gives the row's element e, and is called once for each element the lane
// covers.
template <typename F>
__device__ __forceinline__ float lane_partial(int t, int lanes, int N, bool vec, int head, F&& value) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (!vec) {
    for (int e = t, k = 0; e < N; e += lanes, ++k) acc[k & 3] = add(acc[k & 3], value(e));
  } else {
    // head: the row's first element's offset from a 16-byte boundary.
    int end = N, base = 0;
    if (head > 0) {
      if (t >= head && t < 4) acc[0] = add(acc[0], value(t - head));
      end = N + head - 4;
      base = 4 - head;
    }
    for (int idx = t; 4 * idx + 3 < end; idx += lanes)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = add(acc[i], value(base + 4 * idx + i));
    const int tail = end - end % 4 + t;
    if (tail < end) acc[0] = add(acc[0], value(base + tail));
  }
  return add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
}

__global__ void __launch_bounds__(kThreads)
    ransac_kernel(const float* __restrict__ u, const float* __restrict__ p_cuml, const float* __restrict__ pts,
                  const float* __restrict__ pts_dst, const float* __restrict__ obs, const bool* __restrict__ valid,
                  const float* __restrict__ w_sem, const float* __restrict__ weights, float* Ts,
                  float* __restrict__ T_best, long long* __restrict__ inls, float* supports,
                  long long* __restrict__ best, bool* __restrict__ mask, float* __restrict__ w, int H, int N,
                  Camera cam, float threshold, int lanes, bool vec) {
  __shared__ float partial[kWarps][kMaxLanes];
  __shared__ int best_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. Draws and fits, a thread a hypothesis. The draw:
  // searchsorted(p_cuml, p_cuml[-1] * (1 - u)), the left side.
  const float total = p_cuml[N - 1];
  for (int h = tid; h < H; h += kThreads) {
    float src[3][3], dst[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float r = mul(total, sub(1.0f, u[3 * h + j]));
      int lo = 0, hi = N;
      while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (!(p_cuml[mid] >= r)) lo = mid + 1;
        else hi = mid;
      }
      const int i = lo < N ? lo : N - 1;  // u in [0, 1) never reaches N
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        src[j][k] = pts[3 * i + k];
        dst[j][k] = pts_dst[3 * i + k];
      }
    }
    kabsch3(src, dst, Ts + 16 * h);
  }
  __syncthreads();

  // 2. Scores, a warp a hypothesis: the inlier count, and the support in
  // torch.sum's order (lane partials, then the halving tree).
  float* v = partial[warp];
  for (int h = warp; h < H; h += kWarps) {
    float T[12];
#pragma unroll
    for (int e = 0; e < 12; ++e) T[e] = Ts[16 * h + e];
    int count = 0;
    auto value = [&](int e) {
      const bool m = is_inlier(T, pts, obs, valid, e, cam, threshold);
      count += m;
      return mul(m ? 1.0f : 0.0f, __ldg(w_sem + e));
    };
    const int head = (int)(((long long)h * N) % 4);
    for (int t = lane; t < lanes; t += 32) v[t] = lane_partial(t, lanes, N, vec, head, value);
    __syncwarp();
    for (int s = lanes / 2; s >= 1; s >>= 1) {
      for (int t = lane; t < s; t += 32) v[t] = add(v[t], v[t + s]);
      __syncwarp();
    }
    count = __reduce_add_sync(0xffffffffu, count);
    if (lane == 0) {
      supports[h] = v[0];
      inls[h] = count;
    }
    __syncwarp();
  }
  __syncthreads();

  // 3. The best hypothesis: torch.argmax(supports), by warp 0.
  if (warp == 0) {
    int bi = -1;
    float bv = 0.0f;
    for (int h = lane; h < H; h += 32) {
      const float s = supports[h];
      if (bi < 0 || beats(s, h, bv, bi)) {
        bv = s;
        bi = h;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (oi >= 0 && (bi < 0 || beats(ov, oi, bv, bi))) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      best_s = bi;
      *best = bi;
    }
  }
  __syncthreads();

  // 4. The best pose, its inlier mask (count_inliers recounted; the same
  // operations as its row above) and w = mask * weights.
  const int b = best_s;
  float T[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) T[e] = Ts[16 * b + e];
  if (tid < 16) T_best[tid] = Ts[16 * b + tid];
  for (int i = tid; i < N; i += kThreads) {
    const bool m = is_inlier(T, pts, obs, valid, i, cam, threshold);
    mask[i] = m;
    w[i] = weights == nullptr ? (m ? 1.0f : 0.0f) : mul(m ? 1.0f : 0.0f, __ldg(weights + i));
  }
}

int last_pow2(int n) {
  int p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}

// Reduce.cuh's setReduceConfig for torch.sum over the last dimension of a
// contiguous (H, N) f32 tensor: the block width (the lanes of a row) and
// whether the lanes load four elements at a time.
void reduce_lanes(int H, int N, int* lanes, int* vec) {
  constexpr int kMaxThreads = 512;
  *vec = N >= 128;
  const int dim0 = *vec ? N / 4 : N;
  const int d0 = dim0 < kMaxThreads ? last_pow2(dim0) : kMaxThreads;
  const int d1 = H < kMaxThreads ? last_pow2(H) : kMaxThreads;
  int bw = d0 < 32 ? d0 : 32;
  const int bh = d1 < kMaxThreads / bw ? d1 : kMaxThreads / bw;
  bw = d0 < kMaxThreads / bh ? d0 : kMaxThreads / bh;
  *lanes = bw;
}

}  // namespace

extern "C" int semslam_ransac(const void* u, const void* p_cuml, const void* pts, const void* pts_dst, const void* obs,
                              const void* valid, const void* w_sem, const void* weights, void* Ts, void* T_best,
                              void* inls, void* supports, void* best, void* mask, void* w, int H, int N, float fx,
                              float fy, float cx, float cy, float threshold, void* stream) {
  if (H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  int lanes, vec;
  reduce_lanes(H, N, &lanes, &vec);
  ransac_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)p_cuml, (const float*)pts, (const float*)pts_dst, (const float*)obs,
      (const bool*)valid, (const float*)w_sem, (const float*)weights, (float*)Ts, (float*)T_best, (long long*)inls,
      (float*)supports, (long long*)best, (bool*)mask, (float*)w, H, N, Camera{fx, fy, cx, cy}, threshold, lanes,
      vec != 0);
  return (int)cudaGetLastError();
}
