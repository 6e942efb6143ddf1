// Pose-only Levenberg-Marquardt: every iteration of every pose problem in
// one launch (Hopper).
//
// Replaces no Pallas kernel: gl_slam_tpu/slam/pose_ba.py:pose_only_ba is
// plain JAX, which XLA fuses into one program on the TPU. The port's plain
// version (slam/pose_ba._lm) is eager PyTorch: ~340 small kernels an
// iteration (the unrolled 6x6 Cholesky alone ~170 of them), 48 iterations
// a tracked frame, so the host's launch rate, not the card, paced the
// tracker. This kernel runs the same algorithm with the same arithmetic,
// all iterations of both phases, in one launch per call.
//
// What bounds it on this card: neither bytes nor operations. A problem
// reads its points once from device memory (25 bytes a point, then L1/L2)
// and does ~200 float operations a point and iteration; at the tracker's
// shapes (192 problems x 2048 points x 38 iterations) that is ~3 GFLOP,
// ~50 us at the card's f32 rate. The iterations of one problem are a
// serial chain: per iteration two block-wide reductions (the 27 normal-
// equation sums, then the trial cost) and one thread's 6x6 solve and
// exponential map. The design keeps that chain short:
//   * One CTA of 256 threads per problem (a problem is a (stream, start)
//     pose; the starts of a stream read the same point rows, through L2).
//     Threads stride over the points with the ragged end masked, so any N
//     runs; a problem's pose lives in shared memory.
//   * Each thread sums its points' Cauchy-weighted H (21 upper terms) and
//     g (6) in registers; warp shuffles then one shared-memory pass give
//     the 27 sums in a fixed order (the result is the same in every run).
//   * Thread 0 damps H, solves by the unrolled Cholesky of
//     ops/smallmat.cholesky_solve (same 1e-12 clamp, same 1e-9 diagonal)
//     and forms exp_so3 with geometry/se3's Taylor switch, while the other
//     threads wait at the barrier: ~1 us, against ~2 us for the sums.
//   * The trial cost is a second reduction; no Jacobian is formed for it.
//   * Accept/reject, the stall count (relative improvement 1e-5) and the
//     lambda update and clamp [1e-9, 1e6] are computed by every thread from
//     the same shared values, so control flow stays uniform. A problem
//     whose stall count reaches 2 leaves the loop: the JAX version's early
//     stop, which gives what the plain version's frozen-lane select gives.
//   * The coarse phase (scale x mult) starts its own cost, lambda and
//     stall, as the plain version's two _lm calls do; the final cost is at
//     the fine scale.
// float32 throughout, IEEE division and square root, accurate log1pf,
// sinf, cosf (no fast-math); sums run in another order than PyTorch's,
// which the tests bound.
//
// Layout: K (k_rows, 3, 3) with k_rows 1 (shared) or B; R0 (P, 3, 3),
// t0 (P, 3); pts (B, N, 3), uv (B, N, 2), mask (B, N) bytes 0/1, pw
// (B, N) or null; problem p reads point row p / per. Outputs R (P, 3, 3),
// t (P, 3), cost (P), used (P) int32 (mask count), live (P) int32 or null
// (iterations run, both phases).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;            // H upper triangle (21) + g (6)
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* K;
  const float* R0;
  const float* t0;
  const float* pts;
  const float* uv;
  const uint8_t* mask;
  const float* pw;
  float* R;
  float* t;
  float* cost;
  int* used;
  int* live;
  int k_rows, per, N;
  int iters[2];          // coarse, fine
  float c2[2];           // Cauchy scale squared of each phase
  float rho_behind[2];   // cost of a point behind the camera
  float lam0;
};

struct Shared {
  float red[kWarps][kSums];
  float sum[kSums];
  float R[9], t[3];      // the problem's pose
  float Rn[9], tn[3];    // the trial pose
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sums v[0..M) over the block into s.sum[0..M); every thread may read them
// after the call.
template <int M>
__device__ __forceinline__ void block_sum(float (&v)[M], Shared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < M; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < M; ++k) s.red[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < M) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += s.red[w][threadIdx.x];
    s.sum[threadIdx.x] = a;
  }
  __syncthreads();
}

struct Cam {
  float fx, fy, cx, cy;
};

// Camera point, residual and behind flag of point i at pose (R, t), as
// slam/pose_ba._residuals_jacobian computes them.
struct Proj {
  float x, y, z, iz, ru, rv;
  bool behind;
};

__device__ __forceinline__ Proj project(const Cam& k, const float* R,
                                        const float* t, const float* p,
                                        const float* q) {
  Proj o;
  o.x = p[0] * R[0] + p[1] * R[1] + p[2] * R[2] + t[0];
  o.y = p[0] * R[3] + p[1] * R[4] + p[2] * R[5] + t[1];
  o.z = p[0] * R[6] + p[1] * R[7] + p[2] * R[8] + t[2];
  const float z = fmaxf(o.z, 1e-6f);
  o.iz = 1.0f / z;
  o.ru = k.fx * o.x * o.iz + k.cx - q[0];
  o.rv = k.fy * o.y * o.iz + k.cy - q[1];
  o.behind = o.z <= 1e-6f;
  return o;
}

__device__ __forceinline__ float point_weight(const Args& a, size_t i) {
  float m = a.mask[i] ? 1.0f : 0.0f;
  if (a.pw != nullptr) m = m * a.pw[i];
  return m;
}

// Robust cost of the problem at pose (R, t) in shared memory: the block's
// sum of maskf * rho, returned to every thread.
__device__ float cost_at(const Args& a, const Cam& k, size_t row,
                         const float* R, const float* t, float c2, float rb,
                         Shared& s) {
  float v[1] = {0.0f};
  for (int n = threadIdx.x; n < a.N; n += kThreads) {
    const size_t i = row + n;
    const Proj o = project(k, R, t, a.pts + 3 * i, a.uv + 2 * i);
    float rho = c2 * log1pf((o.ru * o.ru + o.rv * o.rv) / c2);
    if (o.behind) rho = rb;
    v[0] += point_weight(a, i) * rho;
  }
  block_sum<1>(v, s);
  return s.sum[0];
}

// H += w J^T J and g += w J^T r over the thread's points, H's upper
// triangle row by row in h[0..21), g in h[21..27).
__device__ __forceinline__ void normal_terms(const Args& a, const Cam& k,
                                             size_t row, const float* R,
                                             const float* t, float c2,
                                             float (&h)[kSums]) {
#pragma unroll
  for (int j = 0; j < kSums; ++j) h[j] = 0.0f;
  for (int n = threadIdx.x; n < a.N; n += kThreads) {
    const size_t i = row + n;
    const Proj o = project(k, R, t, a.pts + 3 * i, a.uv + 2 * i);
    float w = 1.0f / (1.0f + (o.ru * o.ru + o.rv * o.rv) / c2) *
              point_weight(a, i);
    if (o.behind) w = 0.0f;
    // J = J_pc [-hat(pc), I], J_pc = [[fx/z, 0, -fx x/z^2],
    //                                  [0, fy/z, -fy y/z^2]]
    const float iz2 = o.iz * o.iz;
    const float fa = k.fx * o.iz, fc = -k.fx * o.x * iz2;
    const float fb = k.fy * o.iz, fd = -k.fy * o.y * iz2;
    const float ju[6] = {fc * o.y, fa * o.z - fc * o.x, -fa * o.y,
                         fa, 0.0f, fc};
    const float jv[6] = {-fb * o.z + fd * o.y, -fd * o.x, fb * o.x,
                         0.0f, fb, fd};
    float wu[6], wv[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      wu[j] = ju[j] * w;
      wv[j] = jv[j] * w;
    }
    int m = 0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
#pragma unroll
      for (int l = j; l < 6; ++l) h[m++] += wu[j] * ju[l] + wv[j] * jv[l];
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) h[21 + j] += wu[j] * o.ru + wv[j] * o.rv;
  }
}

__device__ __forceinline__ int upper(int j, int l) {   // j <= l
  return j * 6 - j * (j - 1) / 2 + (l - j);
}

// One thread: damp H, solve (H + lam diag(H) + 1e-9 I) x = g by the
// unrolled Cholesky, dx = -x, and the trial pose exp(dx[:3]) (R, t) +
// (0, dx[3:]) into s.Rn, s.tn.
__device__ void solve_step(Shared& s, float lam) {
  float A[6][6], L[6][6], y[6], x[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int l = j; l < 6; ++l) A[j][l] = A[l][j] = s.sum[upper(j, l)];
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) A[j][j] = A[j][j] + lam * A[j][j] + 1e-9f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = A[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) d = d - L[j][q] * L[j][q];
    L[j][j] = sqrtf(fmaxf(d, 1e-12f));
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float e = A[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) e = e - L[i][q] * L[j][q];
      L[i][j] = e / L[j][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float e = s.sum[21 + i];
#pragma unroll
    for (int q = 0; q < i; ++q) e = e - L[i][q] * y[q];
    y[i] = e / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float e = y[i];
#pragma unroll
    for (int q = i + 1; q < 6; ++q) e = e - L[q][i] * x[q];
    x[i] = e / L[i][i];
  }
  // exp_so3 of w = -x[:3] (geometry/se3.exp_so3: eps 1e-8, Taylor below
  // theta^2 1e-8)
  const float w0 = -x[0], w1 = -x[1], w2 = -x[2];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(th2 + 1e-8f);
  float ca, cb;
  if (th2 < 1e-8f) {
    ca = 1.0f - th2 / 6.0f;
    cb = 0.5f - th2 / 24.0f;
  } else {
    ca = sinf(th) / th;
    cb = (1.0f - cosf(th)) / (th2 + 1e-8f);
  }
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float dR[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float ww = W[i][0] * W[0][j] + W[i][1] * W[1][j] +
                       W[i][2] * W[2][j];
      dR[i][j] = ((i == j ? 1.0f : 0.0f) + ca * W[i][j]) + cb * ww;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      s.Rn[3 * i + j] = dR[i][0] * s.R[j] + dR[i][1] * s.R[3 + j] +
                        dR[i][2] * s.R[6 + j];
    s.tn[i] = (dR[i][0] * s.t[0] + dR[i][1] * s.t[1] + dR[i][2] * s.t[2]) -
              x[3 + i];
  }
}

__global__ void __launch_bounds__(kThreads) pose_lm_kernel(Args a) {
  __shared__ Shared s;
  const int p = blockIdx.x;
  const int b = p / a.per;
  const size_t row = (size_t)b * a.N;
  const float* Kp = a.K + 9 * (a.k_rows == 1 ? 0 : b);
  const Cam k{Kp[0], Kp[4], Kp[2], Kp[5]};
  if (threadIdx.x < 9) s.R[threadIdx.x] = a.R0[9 * (size_t)p + threadIdx.x];
  if (threadIdx.x < 3) s.t[threadIdx.x] = a.t0[3 * (size_t)p + threadIdx.x];
  float cnt[1] = {0.0f};          // exact in float below 2^24 points
  for (int n = threadIdx.x; n < a.N; n += kThreads)
    cnt[0] += a.mask[row + n] ? 1.0f : 0.0f;
  block_sum<1>(cnt, s);           // its barrier also publishes s.R, s.t
  const int used = (int)s.sum[0];

  int live = 0;
  float cost = 0.0f;
  for (int ph = 0; ph < 2; ++ph) {
    if (ph == 0 && a.iters[0] <= 0) continue;
    const float c2 = a.c2[ph], rb = a.rho_behind[ph];
    cost = cost_at(a, k, row, s.R, s.t, c2, rb, s);
    float lam = a.lam0;
    int stall = 0;
    for (int it = 0; it < a.iters[ph] && stall < 2; ++it) {
      ++live;
      float h[kSums];
      normal_terms(a, k, row, s.R, s.t, c2, h);
      block_sum<kSums>(h, s);
      if (threadIdx.x == 0) solve_step(s, lam);
      __syncthreads();
      const float new_cost = cost_at(a, k, row, s.Rn, s.tn, c2, rb, s);
      const bool accept = new_cost < cost;
      const bool improved = accept && (cost - new_cost > 1e-5f * cost);
      stall = improved ? 0 : stall + 1;
      if (accept) {
        cost = new_cost;
        if (threadIdx.x < 9) s.R[threadIdx.x] = s.Rn[threadIdx.x];
        if (threadIdx.x < 3) s.t[threadIdx.x] = s.tn[threadIdx.x];
      }
      lam = fminf(fmaxf(accept ? lam * 0.1f : lam * 10.0f, 1e-9f), 1e6f);
      __syncthreads();
    }
  }
  if (threadIdx.x < 9) a.R[9 * (size_t)p + threadIdx.x] = s.R[threadIdx.x];
  if (threadIdx.x < 3) a.t[3 * (size_t)p + threadIdx.x] = s.t[threadIdx.x];
  if (threadIdx.x == 0) {
    a.cost[p] = cost;
    a.used[p] = used;
    if (a.live != nullptr) a.live[p] = live;
  }
}

}  // namespace

// P problems, `per` of them on each of the B = P / per point rows of N
// points. Returns a cudaError_t (0: launched).
extern "C" int gl_pose_lm(const void* K, int k_rows, const void* R0,
                          const void* t0, const void* pts, const void* uv,
                          const void* mask, const void* pw, int P, int per,
                          int N, int coarse_iters, float coarse_c2,
                          float coarse_rho_behind, int fine_iters,
                          float fine_c2, float fine_rho_behind, float lam0,
                          void* R, void* t, void* cost, void* used,
                          void* live, void* stream) {
  if (P <= 0 || per <= 0 || P % per != 0 || N < 0 || k_rows <= 0 ||
      coarse_iters < 0 || fine_iters < 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.K = static_cast<const float*>(K);
  a.R0 = static_cast<const float*>(R0);
  a.t0 = static_cast<const float*>(t0);
  a.pts = static_cast<const float*>(pts);
  a.uv = static_cast<const float*>(uv);
  a.mask = static_cast<const uint8_t*>(mask);
  a.pw = static_cast<const float*>(pw);
  a.R = static_cast<float*>(R);
  a.t = static_cast<float*>(t);
  a.cost = static_cast<float*>(cost);
  a.used = static_cast<int*>(used);
  a.live = static_cast<int*>(live);
  a.k_rows = k_rows;
  a.per = per;
  a.N = N;
  a.iters[0] = coarse_iters;
  a.iters[1] = fine_iters;
  a.c2[0] = coarse_c2;
  a.c2[1] = fine_c2;
  a.rho_behind[0] = coarse_rho_behind;
  a.rho_behind[1] = fine_rho_behind;
  a.lam0 = lam0;
  pose_lm_kernel<<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
