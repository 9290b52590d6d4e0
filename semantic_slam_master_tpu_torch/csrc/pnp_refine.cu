// Robust Gauss-Newton pose refinement of one RANSAC result, its rescoring,
// the refine-or-keep choice and the inlier rmse, in one launch, f32 with
// f32 sums.
//
// Replaces no TPU kernel: it is the span slam.refine of
// slam/pnp.py::ransac_pose, which the JAX package runs under jit and the
// port ran as about 1,500 eager PyTorch launches a tracked frame (10 damped
// Gauss-Newton steps of about 150 small ops, each with a blocking copy of
// lie.make_pose's constant row, a cuBLAS GEMM and GEMV, a cuSOLVER
// getrf/getrs, then the rescoring) plus two reads of the best hypothesis's
// support and inlier count on the host. The plain version is
// ops/kernels/pnp_refine.py::pnp_refine_plain.
//
// Bound on the H100: latency. Per step the work is about 42 sums over the
// 2N rows of the Jacobian (N = 500-512 on the SLAM paths): some 100 K f32
// operations and 60 B a point, far below what one SM does in a few
// microseconds. What costs is the chain of dependent steps: each step's
// pose depends on the last step's solve. One block of 256 threads runs the
// whole span; the pose lives in shared memory across all num_iters steps,
// so nothing returns to the host.
//
// The SLAM loop amplifies a difference in the last bit of a keyframe's
// pose through its window bundle adjustment (to 1e-5-1e-4 m in 60 frames),
// so the kernel gives the plain version's bits, not only its values: each
// step rounds every operation as the plain version's PyTorch and library
// calls on the H100 round it (measured there, PyTorch 2.11 / CUDA 12.8):
// - per point (each thread strides over the points): the point by T, the
//   residual with project's |z| < 1e-6 clamp, the z > 0.05 depth test, the
//   Huber weight times the given weight and the 2x6 Jacobian of
//   slam/pnp.py::_pose_jacobian, one rounded operation each (no fused
//   multiply-adds); a sum of three over the last dimension adds the first
//   and the third term, then the second, as PyTorch's reduction does; the
//   rows go to shared memory (to a global scratch buffer above 2048
//   points);
// - H = einsum("nij,nik->jk", J w, J), a cuBLASLt split-K SGEMM: the 2N
//   rows in (i, n) order cut into slices of L = 4 ceil(ceil(2N/36) / 4)
//   rows, each slice a chain of fused multiply-adds from 0, the slices
//   added in order; all 36 entries (the rounded products make H
//   asymmetric in its last bits);
// - g = einsum("nij,ni->j", J w, r), a cuBLAS dot product: rows in pairs,
//   the pair's two rounded products added, pair c on virtual thread
//   c mod 512 of 4 blocks of 128, each block summed by a halving tree
//   (v[t] += v[t + s], s = 64 .. 1), the 4 block sums added in order;
// - the solve (linalg.solve_ex: getrf, getrs), by one thread: LU with
//   partial pivoting (the first largest pivot), multipliers times the
//   pivot's reciprocal, fused multiply-add updates of the trailing rows
//   and of g, back substitution from the last column, divided by the
//   pivot; the step zeroed if any entry is not finite;
// - se3_exp(delta) with core/lie.py's small-angle branches (theta^2 <
//   1e-8; a tensor over a number is a product with its reciprocal), then
//   T <- exp(delta) T.
// Those orders are the plain path's for N = 500 and 512; at other N the
// split of the library's GEMM may differ and the kernel agrees with the
// plain version to rounding.
// After the last step, one pass counts the refined pose's inliers by
// slam/pnp.py::count_inliers' rule and writes mask_ref * w_sem, which the
// block sums in torch.sum's order over a contiguous 1-D f32 tensor
// (ATen/native/cuda/Reduce.cuh, measured on the card: one block of
// last_pow2 lanes, up to 512, of n or, from 128 elements, of n / 4 loads of
// four; four accumulators a lane, added in order; then a halving tree
// across the lanes). It keeps the refined pose when that sum is >=
// supports[best], read through the device index best, as the plain
// version does (a NaN keeps T_best there too); so an equal inlier set
// ties, or not, on the same bits. One thread reads inls[best]; one more
// pass writes the chosen mask and sums the squared residuals of the chosen
// pose over it, in the same order, for the rmse.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEntries = 36;       // H, row-major
constexpr int kMaxSlices = 36;     // the GEMM's split: at most 36 slices
constexpr int kDotThreads = 512;   // the dot product's 4 blocks of 128
constexpr int kDotBlock = 128;
constexpr int kRow = 16;           // floats a point: J (2x6), w, r (2), pad
constexpr int kSmemPoints = 2048;  // up to this N the rows live in shared memory
constexpr float kMaxFloat = 3.40282347e+38f;

struct Camera {
  float fx, fy, cx, cy;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ int last_pow2(int n) { return 1 << (31 - __clz(n)); }

// A sum of three over a tensor's last dimension, as PyTorch's reduction
// takes it on the card: the first and the third, then the second.
__device__ __forceinline__ float sum3(float a, float b, float c) { return add(add(a, c), b); }

// The point in the camera frame (lie.transform_points) and its residual
// proj(T p) - obs (camera.project).
struct Residual {
  float x, y, z, rx, ry;
};

__device__ __forceinline__ Residual residual(const float* T, const float* __restrict__ pts,
                                             const float* __restrict__ obs, int i, const Camera& cam) {
  const float px = __ldg(pts + 3 * i), py = __ldg(pts + 3 * i + 1), pz = __ldg(pts + 3 * i + 2);
  Residual q;
  q.x = add(sum3(mul(px, T[0]), mul(py, T[1]), mul(pz, T[2])), T[3]);
  q.y = add(sum3(mul(px, T[4]), mul(py, T[5]), mul(pz, T[6])), T[7]);
  q.z = add(sum3(mul(px, T[8]), mul(py, T[9]), mul(pz, T[10])), T[11]);
  const float zs = fabsf(q.z) < 1e-6f ? 1e-6f : q.z;
  q.rx = sub(add(quo(mul(cam.fx, q.x), zs), cam.cx), __ldg(obs + 2 * i));
  q.ry = sub(add(quo(mul(cam.fy, q.y), zs), cam.cy), __ldg(obs + 2 * i + 1));
  return q;
}

__device__ __forceinline__ float sq_norm(const Residual& q) { return add(mul(q.rx, q.rx), mul(q.ry, q.ry)); }

// count_inliers' rule: ||r|| < threshold, depth > 0.05, valid.
__device__ __forceinline__ bool is_inlier(const Residual& q, bool valid, float threshold) {
  return (sqrtf(sq_norm(q)) < threshold) & (q.z > 0.05f) & valid;
}

// Sum of v over the block (every thread gets it); scratch holds kWarps
// values and is free again on return.
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  V s = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// torch.sum(x) over n contiguous floats (n < 2^17; beyond, PyTorch splits
// the sum across blocks), in PyTorch's order on the card (see the head of
// this file); every thread gets it. v holds kDotThreads floats and is free
// again on return.
__device__ float torch_sum(const float* x, int n, float* v) {
  if (n == 0) return 0.0f;
  const bool vec = n >= 128;
  const int dim0 = vec ? n / 4 : n;
  const int lanes = dim0 < kDotThreads ? last_pow2(dim0) : kDotThreads;
  for (int t = threadIdx.x; t < lanes; t += kThreads) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (vec) {
      for (int idx = t; 4 * idx + 3 < n; idx += lanes)
        for (int i = 0; i < 4; ++i) acc[i] = add(acc[i], x[4 * idx + i]);
      const int tail = n - n % 4 + t;  // the last n % 4 elements, one a lane
      if (tail < n) acc[0] = add(acc[0], x[tail]);
    } else {
      for (int e = t, k = 0; e < n; e += lanes, ++k) acc[k & 3] = add(acc[k & 3], x[e]);
    }
    v[t] = add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
  }
  __syncthreads();
  for (int st = lanes / 2; st >= 1; st >>= 1) {
    for (int t = threadIdx.x; t < st; t += kThreads) v[t] = add(v[t], v[t + st]);
    __syncthreads();
  }
  const float s = v[0];
  __syncthreads();
  return s;
}

// One point's Jacobian rows (J0, J1), Gauss-Newton weight and residual
// into its scratch row.
__device__ __forceinline__ void point_rows(const Residual& q, float w_conf, float huber_delta, const Camera& cam,
                                           float* row) {
  // huber_weights(||r||, delta) * w_conf * depth_ok (NaN stays NaN, as in
  // torch.clamp; a number over a tensor is its reciprocal times the number).
  const float rn = sqrtf(sq_norm(q));
  const float huber = rn <= huber_delta ? 1.0f : mul(quo(1.0f, rn < 1e-8f ? 1e-8f : rn), huber_delta);
  // _pose_jacobian: J_proj (2x3) @ [I | -hat(p)] (3x6); its zero terms add
  // nothing.
  const float zs = fabsf(q.z) < 1e-6f ? 1e-6f : q.z;
  const float iz = quo(1.0f, zs);
  const float iz2 = mul(iz, iz);
  const float a = mul(cam.fx, iz), b = mul(mul(-cam.fx, q.x), iz2);
  const float c = mul(cam.fy, iz), d = mul(mul(-cam.fy, q.y), iz2);
  row[0] = a;
  row[1] = 0.0f;
  row[2] = b;
  row[3] = mul(b, q.y);
  row[4] = add(mul(a, q.z), mul(b, -q.x));
  row[5] = mul(a, -q.y);
  row[6] = 0.0f;
  row[7] = c;
  row[8] = d;
  row[9] = add(mul(c, -q.z), mul(d, q.y));
  row[10] = mul(d, -q.x);
  row[11] = mul(c, q.x);
  row[12] = mul(mul(huber, w_conf), q.z > 0.05f ? 1.0f : 0.0f);
  row[13] = q.rx;
  row[14] = q.ry;
}

// The scratch row of Jacobian row k of the (i, n)-ordered 2N rows.
__device__ __forceinline__ const float* jrow(const float* scratch, int k, int N, int* i) {
  *i = k >= N;
  return scratch + (size_t)(k - *i * N) * kRow;
}

// delta = -(H + damping I)^-1 g as linalg.solve_ex computes it (getrf,
// getrs); zero if any entry is not finite (slam/pnp.py::refine_pose).
__device__ void solve_step(const float* H, const float* g, float damping, float* delta) {
  float A[6][7];
  for (int j = 0; j < 6; ++j) {
    for (int l = 0; l < 6; ++l) A[j][l] = H[6 * j + l];
    A[j][j] = add(A[j][j], damping);
    A[j][6] = g[j];
  }
  // Every loop unrolled, so that A stays in registers.
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
#pragma unroll
    for (int i = k + 1; i < 6; ++i)
      if (i == p)
#pragma unroll
        for (int j = 0; j < 7; ++j) {
          const float s = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = s;
        }
    const float inv = quo(1.0f, A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = mul(A[i][k], inv);
      A[i][k] = l;
#pragma unroll
      for (int j = k + 1; j < 7; ++j) A[i][j] = __fmaf_rn(-l, A[k][j], A[i][j]);
    }
  }
  bool finite = true;
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    float s = A[k][6];
#pragma unroll
    for (int j = 5; j > k; --j) s = __fmaf_rn(-A[k][j], delta[j], s);
    delta[k] = quo(s, A[k][k]);
  }
  for (int k = 0; k < 6; ++k) {
    delta[k] = -delta[k];
    finite &= fabsf(delta[k]) <= kMaxFloat;  // false for inf and NaN
  }
  if (!finite)
    for (int k = 0; k < 6; ++k) delta[k] = 0.0f;
}

// 3x3 product as lie.mm_small sums it (over the middle index, in order).
__device__ __forceinline__ void mm3(const float A[3][3], const float B[3][3], float C[3][3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) C[i][j] = add(add(mul(A[i][0], B[0][j]), mul(A[i][1], B[1][j])), mul(A[i][2], B[2][j]));
}

// T <- se3_exp(delta) @ T (core/lie.py: so3_exp, _so3_left_jacobian,
// make_pose, mm_small), T a row-major 4x4.
__device__ void apply_step(const float* delta, float* T) {
  const float p0 = delta[3], p1 = delta[4], p2 = delta[5];
  const float theta_sq = sum3(mul(p0, p0), mul(p1, p1), mul(p2, p2));
  const bool small = theta_sq < 1e-8f;
  const float tss = small ? 1.0f : theta_sq;
  const float theta = sqrtf(tss);
  const float s = sinf(theta), co = cosf(theta);
  // A tensor over a number is, on the card, a product with its reciprocal.
  const float a = small ? sub(1.0f, mul(theta_sq, 1.0f / 6.0f)) : quo(s, theta);
  const float b = small ? sub(0.5f, mul(theta_sq, 1.0f / 24.0f)) : quo(sub(1.0f, co), tss);
  const float c = small ? sub(1.0f / 6.0f, mul(theta_sq, 1.0f / 120.0f)) : quo(sub(theta, s), mul(tss, theta));
  const float K[3][3] = {{0.0f, -p2, p1}, {p2, 0.0f, -p0}, {-p1, p0, 0.0f}};
  float KK[3][3];
  mm3(K, K, KK);
  float E[4][4];
  for (int i = 0; i < 3; ++i) {
    float V[3];
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      E[i][j] = add(add(eye, mul(a, K[i][j])), mul(b, KK[i][j]));
      V[j] = add(add(eye, mul(b, K[i][j])), mul(c, KK[i][j]));
    }
    E[i][3] = sum3(mul(V[0], delta[0]), mul(V[1], delta[1]), mul(V[2], delta[2]));
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
  float out[16];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = add(add(add(mul(E[i][0], T[j]), mul(E[i][1], T[4 + j])), mul(E[i][2], T[8 + j])),
                           mul(E[i][3], T[12 + j]));
  for (int k = 0; k < 16; ++k) T[k] = out[k];
}

__global__ void __launch_bounds__(kThreads)
    pnp_refine_kernel(const float* __restrict__ T_best, const float* __restrict__ pts,
                      const float* __restrict__ obs, const float* __restrict__ w_conf,
                      const float* __restrict__ w_sem, const bool* __restrict__ valid,
                      const bool* __restrict__ mask_best, const float* __restrict__ supports,
                      const long long* __restrict__ inls,
                      const long long* __restrict__ best, float* __restrict__ scratch, float* __restrict__ pose,
                      long long* __restrict__ num_inliers, bool* __restrict__ inlier_mask,
                      float* __restrict__ rmse, int N, int num_iters, Camera cam, float huber_delta,
                      float damping, float threshold) {
  __shared__ float T[16];
  __shared__ float H[kEntries];
  __shared__ float g[6];
  __shared__ float partial[kMaxSlices][kEntries];
  __shared__ float leaves[6][kDotThreads];
  __shared__ int iscratch[kWarps];
  __shared__ bool use_ref;
  extern __shared__ float smem_rows[];
  // The points' rows: in shared memory up to kSmemPoints points, else in
  // the global scratch buffer.
  float* rows = N <= kSmemPoints ? smem_rows : scratch;
  const int tid = threadIdx.x;
  const int K = 2 * N;
  const int slice = K > 0 ? 4 * ((((K + 35) / 36) + 3) / 4) : 4;
  const int slices = (K + slice - 1) / slice;
  if (tid < 16) T[tid] = T_best[tid];
  __syncthreads();

  for (int it = 0; it < num_iters; ++it) {
    for (int i = tid; i < N; i += kThreads)
      point_rows(residual(T, pts, obs, i, cam), __ldg(w_conf + i), huber_delta, cam, rows + (size_t)i * kRow);
    __syncthreads();
    // H: each (slice, entry) a chain of fused multiply-adds.
    for (int item = tid; item < slices * kEntries; item += kThreads) {
      const int sl = item / kEntries, e = item - sl * kEntries, j = e / 6, l = e - 6 * j;
      const int k1 = min(sl * slice + slice, K);
      float acc = 0.0f;
#pragma unroll 8
      for (int k = sl * slice; k < k1; ++k) {
        int i;
        const float* row = jrow(rows, k, N, &i);
        acc = __fmaf_rn(mul(row[6 * i + j], row[12]), row[6 * i + l], acc);
      }
      partial[sl][e] = acc;
    }
    // g: the dot product's leaves, a pair of rows each.
    for (int item = tid; item < 6 * kDotThreads; item += kThreads) {
      const int j = item / kDotThreads, t = item - j * kDotThreads;
      float acc = 0.0f;
      for (int c = t; c < N; c += kDotThreads) {
        int i0, i1;
        const float* r0 = jrow(rows, 2 * c, N, &i0);
        const float* r1 = jrow(rows, 2 * c + 1, N, &i1);
        acc = add(add(acc, mul(mul(r0[6 * i0 + j], r0[12]), r0[13 + i0])), mul(mul(r1[6 * i1 + j], r1[12]), r1[13 + i1]));
      }
      leaves[j][t] = acc;
    }
    __syncthreads();
    if (tid < kEntries) {
      float s = partial[0][tid];
      for (int sl = 1; sl < slices; ++sl) s = add(s, partial[sl][tid]);
      H[tid] = slices > 0 ? s : 0.0f;
    }
    // Each of the dot product's 4 x 6 blocks by its halving tree, one level
    // at a time.
    for (int st = kDotBlock / 2; st >= 1; st >>= 1) {
      for (int item = tid; item < 6 * (kDotThreads / kDotBlock) * st; item += kThreads) {
        const int tree = item / st, t = item - tree * st;
        float* v = &leaves[0][0] + tree * kDotBlock;
        v[t] = add(v[t], v[t + st]);
      }
      __syncthreads();
    }
    if (tid == 0) {
      for (int j = 0; j < 6; ++j) {
        float s = leaves[j][0];
        for (int blk = 1; blk < kDotThreads / kDotBlock; ++blk) s = add(s, leaves[j][blk * kDotBlock]);
        g[j] = s;
      }
      float delta[6];
      solve_step(H, g, damping, delta);
      apply_step(delta, T);
    }
    __syncthreads();
  }

  // Rescore the refined pose: its inlier count, and its semantic support
  // sum(mask_ref * w_sem) against the best hypothesis's. The rows are free
  // after the last step and hold the products.
  float* prod = rows;
  int count = 0;
  for (int i = tid; i < N; i += kThreads) {
    const bool m = is_inlier(residual(T, pts, obs, i, cam), valid[i], threshold);
    count += m;
    prod[i] = mul(m ? 1.0f : 0.0f, __ldg(w_sem + i));
  }
  count = block_sum(count, iscratch);
  const float sup_ref = torch_sum(prod, N, &leaves[0][0]);
  if (tid == 0) {
    use_ref = sup_ref >= supports[*best];
    *num_inliers = use_ref ? (long long)count : inls[*best];
  }
  __syncthreads();
  if (!use_ref && tid < 16) T[tid] = T_best[tid];
  __syncthreads();
  if (tid < 16) pose[tid] = T[tid];

  // The chosen mask, and the chosen pose's squared residuals over it,
  // summed in torch.sum's order.
  int chosen = 0;
  for (int i = tid; i < N; i += kThreads) {
    const Residual q = residual(T, pts, obs, i, cam);
    const bool m = use_ref ? is_inlier(q, valid[i], threshold) : mask_best[i];
    inlier_mask[i] = m;
    chosen += m;
    prod[i] = mul(sq_norm(q), m ? 1.0f : 0.0f);  // err2 * mask: NaN stays NaN
  }
  chosen = block_sum(chosen, iscratch);
  const float err = torch_sum(prod, N, &leaves[0][0]);
  if (tid == 0) *rmse = sqrtf(err / (float)(chosen > 1 ? chosen : 1));
}

}  // namespace

extern "C" int semslam_pnp_refine(const void* T_best, const void* pts, const void* obs, const void* w_conf,
                                  const void* w_sem, const void* valid, const void* mask_best, const void* supports,
                                  const void* inls, const void* best, void* scratch, void* pose, void* num_inliers,
                                  void* inlier_mask, void* rmse, int N, int num_iters, float fx, float fy, float cx,
                                  float cy, float huber_delta, float damping, float threshold, void* stream) {
  if (N > kSmemPoints && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = N <= kSmemPoints ? (size_t)N * kRow * sizeof(float) : 0;
  if (smem > 0) {
    // Shared memory beyond 48 KB is opt-in, per function and device: set
    // on every launch, for whichever device is current.
    const cudaError_t err =
        cudaFuncSetAttribute(pnp_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pnp_refine_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)T_best, (const float*)pts, (const float*)obs, (const float*)w_conf, (const float*)w_sem,
      (const bool*)valid, (const bool*)mask_best, (const float*)supports, (const long long*)inls,
      (const long long*)best, (float*)scratch, (float*)pose, (long long*)num_inliers, (bool*)inlier_mask,
      (float*)rmse, N, num_iters, Camera{fx, fy, cx, cy}, huber_delta, damping, threshold);
  return (int)cudaGetLastError();
}
