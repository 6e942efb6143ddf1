// Fused dual-softmax assignment reductions for the matcher (Hopper).
//
// Replaces the Pallas kernel gl_slam_tpu/ops/assignment.py:_fused_reductions
// (_assign_kernel). With sim = f0 . f1^T * scale, lse_r / lse_c the row and
// column logsumexp of sim (masked pairs at -1e9), c0 = log_sigmoid(z0) and
// c1 = log_sigmoid(z1), the matcher needs only
//   nn0[i] = argmax_j (2 sim[i,j] + c1[j] - lse_c[j])   (v0 = that max)
//   nn1[j] = argmax_i (2 sim[i,j] + c0[i] - lse_r[i])   (v1 = that max)
// so the (N, M) score matrix never exists in device memory.
//
// The TPU kernel is grid-free: one program walks the row tiles in order and
// carries the online column reductions in a fori_loop. Blocks on the H100 run
// in no order, so the carry becomes separate stages (four launches):
//   A  row tiles:  row lse over all columns + per-tile column (max, sumexp);
//   B  columns:    combine the column partials into lse_c and
//                  cc1 = m1 ? c1 - lse_c : -1e9;
//   C  row tiles:  row max/argmax of 2 sim + cc1 and per-tile column
//                  (best, index) of 2 sim + (m0 ? c0 - lse_r : -1e9);
//   D  columns:    walk the tiles in order keeping a strictly larger best,
//                  starting from (-1e9, 0), exactly the TPU carry.
// Ties go to the smallest index everywhere.
//
// What bounds it: at the prologue shape (8 pairs, N = M = 2048, Df = 256)
// the two passes are ~17 GFLOP of bf16 products against ~17 MB of inputs,
// so the products bound it; at the re-observation shape (1 pair, 1024 x
// 2048) it is ~2 GFLOP and bound by latency. The products run as bf16
// mma.sync.m16n8k16 with f32 accumulation; each block keeps its 64 rows of
// f0 in registers and streams f1 through shared memory in 64-column tiles.
//
// Layouts: f0 (B, N, DF), f1 (B, M, DF) bf16; c0, m0 (B, N); c1, m1 (B, M)
// (masks uint8); partials (B, ceil(N/64), M); all contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // 64 rows of f0 per block
constexpr int kCols = 64;           // columns of f1 per shared tile
constexpr float kMasked = -1e9f;

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (value, index) pair order: larger value first, then smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Shared body of passes A and C: this warp's 16 rows x 64 columns of the
// logits dot(f0, f1) * mul_scale, masked pairs at -1e9 and out-of-range
// rows/columns at -inf. Row r of the accumulator: g (e < 2) or g + 8.
template <int DF>
struct Tile {
  uint32_t fa[DF / 16][4];  // f0 fragments (A operand)
  float s[kCols / 8][4];

  __device__ void load_rows(const __nv_bfloat16* f0b, int row0, int N, int g,
                            int t) {
    const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
    for (int kk = 0; kk < DF / 16; ++kk) {
      const int c = kk * 16 + t * 2;
      fa[kk][0] = ra < N ? *reinterpret_cast<const uint32_t*>(f0b + (size_t)ra * DF + c) : 0u;
      fa[kk][1] = rb < N ? *reinterpret_cast<const uint32_t*>(f0b + (size_t)rb * DF + c) : 0u;
      fa[kk][2] = ra < N ? *reinterpret_cast<const uint32_t*>(f0b + (size_t)ra * DF + c + 8) : 0u;
      fa[kk][3] = rb < N ? *reinterpret_cast<const uint32_t*>(f0b + (size_t)rb * DF + c + 8) : 0u;
    }
  }

  __device__ void compute(const __nv_bfloat16* f1_s, int stride, float mul,
                          const int8_t* col_state, const int8_t* row_state,
                          int g, int t) {
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* frow = f1_s + (nt * 8 + g) * stride + t * 2;
#pragma unroll
      for (int kk = 0; kk < DF / 16; ++kk) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(frow + kk * 16);
        b[1] = *reinterpret_cast<const uint32_t*>(frow + kk * 16 + 8);
        mma_bf16_16816(s[nt], fa[kk], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cs = col_state[nt * 8 + t * 2 + (e & 1)];
        const int rs = row_state[e >> 1];
        float x = s[nt][e] * mul;
        if (cs < 0 || rs < 0) x = -INFINITY;
        else if (cs == 0 || rs == 0) x = kMasked;
        s[nt][e] = x;
      }
    }
  }
};

template <int DF>
__device__ void load_cols(const __nv_bfloat16* f1b, const uint8_t* m1b,
                          int j0, int M, __nv_bfloat16* f1_s,
                          int8_t* col_state) {
  constexpr int S = DF + 8;
  constexpr int kVec = DF / 8;
  for (int idx = threadIdx.x; idx < kCols * kVec; idx += kWarps * 32) {
    const int r = idx / kVec, c = (idx % kVec) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (j0 + r < M)
      x = *reinterpret_cast<const uint4*>(f1b + (size_t)(j0 + r) * DF + c);
    *reinterpret_cast<uint4*>(f1_s + r * S + c) = x;
  }
  for (int r = threadIdx.x; r < kCols; r += kWarps * 32)
    col_state[r] = (j0 + r < M) ? (m1b[j0 + r] ? 1 : 0) : -1;
}

// Pass A: row lse; per-tile column max and sum of exp(l - max).
template <int DF>
__global__ void __launch_bounds__(kWarps * 32)
pass_lse(const __nv_bfloat16* __restrict__ f0, const __nv_bfloat16* __restrict__ f1,
         const uint8_t* __restrict__ m0, const uint8_t* __restrict__ m1,
         float* __restrict__ lse_r, float* __restrict__ part_max,
         float* __restrict__ part_sum, int N, int M, float scale) {
  __shared__ __align__(16) __nv_bfloat16 f1_s[kCols * (DF + 8)];
  __shared__ int8_t col_state[kCols];
  __shared__ float red[kWarps][kCols];

  const int b = blockIdx.y, rt = blockIdx.x, RT = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = rt * kRows + warp * 16;
  const __nv_bfloat16* f0b = f0 + (size_t)b * N * DF;
  const __nv_bfloat16* f1b = f1 + (size_t)b * M * DF;
  const uint8_t* m0b = m0 + (size_t)b * N;
  const uint8_t* m1b = m1 + (size_t)b * M;

  Tile<DF> tile;
  tile.load_rows(f0b, row0, N, g, t);
  int8_t row_state[2];
  _Pragma("unroll") for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    row_state[h] = r < N ? (m0b[r] ? 1 : 0) : -1;
  }
  float rm[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f};

  for (int j0 = 0; j0 < M; j0 += kCols) {
    __syncthreads();
    load_cols<DF>(f1b, m1b, j0, M, f1_s, col_state);
    __syncthreads();
    tile.compute(f1_s, DF + 8, scale, col_state, row_state, g, t);

    // Row running max/sum (this thread's columns; quad-combined at the end).
    _Pragma("unroll") for (int h = 0; h < 2; ++h) {
      float mt = -INFINITY;
      _Pragma("unroll") for (int nt = 0; nt < kCols / 8; ++nt)
        mt = fmaxf(mt, fmaxf(tile.s[nt][2 * h], tile.s[nt][2 * h + 1]));
      const float mn = fmaxf(rm[h], mt);
      if (mn > -INFINITY) {
        float acc = rs[h] * expf(rm[h] - mn);
        _Pragma("unroll") for (int nt = 0; nt < kCols / 8; ++nt)
          acc += expf(tile.s[nt][2 * h] - mn) + expf(tile.s[nt][2 * h + 1] - mn);
        rs[h] = acc;
        rm[h] = mn;
      }
    }

    // Column max over the block's 64 rows: rows g, g+8 in-thread, then the
    // 8 row groups of the warp (lane bits 2..4), then the 4 warps.
    float cmax[kCols / 8][2];
    _Pragma("unroll") for (int nt = 0; nt < kCols / 8; ++nt)
      _Pragma("unroll") for (int e = 0; e < 2; ++e) {
        float x = fmaxf(tile.s[nt][e], tile.s[nt][e + 2]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 16));
        cmax[nt][e] = x;
      }
    if (g == 0)
      _Pragma("unroll") for (int nt = 0; nt < kCols / 8; ++nt)
        _Pragma("unroll") for (int e = 0; e < 2; ++e) red[warp][nt * 8 + t * 2 + e] = cmax[nt][e];
    __syncthreads();
    _Pragma("unroll") for (int nt = 0; nt < kCols / 8; ++nt)
      _Pragma("unroll") for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + t * 2 + e;
        cmax[nt][e] = fmaxf(fmaxf(red[0][c], red[1][c]), fmaxf(red[2][c], red[3][c]));
      }
    __syncthreads();
    // Column sum of exp(l - tile column max); -inf entries (rows past N)
    // give 0, and the tile max is finite for every in-range column.
    float csum[kCols / 8][2];
    _Pragma("unroll") for (int nt = 0; nt < kCols / 8; ++nt)
      _Pragma("unroll") for (int e = 0; e < 2; ++e) {
        const float cm = cmax[nt][e];
        float x = 0.f;
        if (cm > -INFINITY)
          x = expf(tile.s[nt][e] - cm) + expf(tile.s[nt][e + 2] - cm);
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        csum[nt][e] = x;
      }
    if (g == 0)
      _Pragma("unroll") for (int nt = 0; nt < kCols / 8; ++nt)
        _Pragma("unroll") for (int e = 0; e < 2; ++e) red[warp][nt * 8 + t * 2 + e] = csum[nt][e];
    __syncthreads();
    if (warp == 0 && g == 0)
      _Pragma("unroll") for (int nt = 0; nt < kCols / 8; ++nt)
        _Pragma("unroll") for (int e = 0; e < 2; ++e) {
          const int c = nt * 8 + t * 2 + e;
          if (j0 + c < M) {
            const size_t o = ((size_t)b * RT + rt) * M + j0 + c;
            part_max[o] = cmax[nt][e];
            part_sum[o] = red[0][c] + red[1][c] + red[2][c] + red[3][c];
          }
        }
  }

  _Pragma("unroll") for (int h = 0; h < 2; ++h) {
    float m = rm[h];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float s = rm[h] > -INFINITY ? rs[h] * expf(rm[h] - m) : 0.f;
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const int r = row0 + g + 8 * h;
    if (t == 0 && r < N) lse_r[(size_t)b * N + r] = m + logf(s);
  }
}

// Pass B: lse_c and the pass-2 column term cc1.
__global__ void combine_lse(const float* __restrict__ part_max,
                            const float* __restrict__ part_sum,
                            const float* __restrict__ c1,
                            const uint8_t* __restrict__ m1,
                            float* __restrict__ lse_c, float* __restrict__ cc1,
                            int B, int RT, int M) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * M) return;
  const int b = idx / M, j = idx % M;
  const float* pm = part_max + (size_t)b * RT * M + j;
  const float* ps = part_sum + (size_t)b * RT * M + j;
  float m = -INFINITY;
  for (int r = 0; r < RT; ++r) m = fmaxf(m, pm[(size_t)r * M]);
  float s = 0.f;
  for (int r = 0; r < RT; ++r) s += ps[(size_t)r * M] * expf(pm[(size_t)r * M] - m);
  const float l = m + logf(fmaxf(s, 1e-30f));
  lse_c[idx] = l;
  cc1[idx] = m1[idx] ? c1[idx] - l : kMasked;
}

// Pass C: row argmax of 2 sim + cc1; per-tile column argmax of 2 sim + r0.
template <int DF>
__global__ void __launch_bounds__(kWarps * 32)
pass_argmax(const __nv_bfloat16* __restrict__ f0, const __nv_bfloat16* __restrict__ f1,
            const uint8_t* __restrict__ m0, const uint8_t* __restrict__ m1,
            const float* __restrict__ c0, const float* __restrict__ lse_r,
            const float* __restrict__ cc1, int* __restrict__ nn0,
            float* __restrict__ v0, float* __restrict__ part_best,
            int* __restrict__ part_idx, int N, int M, float scale2) {
  __shared__ __align__(16) __nv_bfloat16 f1_s[kCols * (DF + 8)];
  __shared__ int8_t col_state[kCols];
  __shared__ float cc1_s[kCols];
  __shared__ float red_v[kWarps][kCols];
  __shared__ int red_i[kWarps][kCols];

  const int b = blockIdx.y, rt = blockIdx.x, RT = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = rt * kRows + warp * 16;
  const __nv_bfloat16* f0b = f0 + (size_t)b * N * DF;
  const __nv_bfloat16* f1b = f1 + (size_t)b * M * DF;
  const uint8_t* m0b = m0 + (size_t)b * N;
  const uint8_t* m1b = m1 + (size_t)b * M;

  Tile<DF> tile;
  tile.load_rows(f0b, row0, N, g, t);
  int8_t row_state[2];
  float r0[2];
  _Pragma("unroll") for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    row_state[h] = r < N ? (m0b[r] ? 1 : 0) : -1;
    r0[h] = row_state[h] > 0 ? c0[(size_t)b * N + r] - lse_r[(size_t)b * N + r]
                             : kMasked;
  }
  float rb[2] = {-INFINITY, -INFINITY};
  int ri[2] = {0x7fffffff, 0x7fffffff};

  for (int j0 = 0; j0 < M; j0 += kCols) {
    __syncthreads();
    load_cols<DF>(f1b, m1b, j0, M, f1_s, col_state);
    for (int r = threadIdx.x; r < kCols; r += kWarps * 32)
      cc1_s[r] = j0 + r < M ? cc1[(size_t)b * M + j0 + r] : 0.f;
    __syncthreads();
    tile.compute(f1_s, DF + 8, scale2, col_state, row_state, g, t);

    // Row argmax over this thread's columns, in increasing column order.
    _Pragma("unroll") for (int nt = 0; nt < kCols / 8; ++nt)
      _Pragma("unroll") for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + t * 2 + (e & 1);
        const float x = tile.s[nt][e] + cc1_s[c];
        if (x > rb[e >> 1]) { rb[e >> 1] = x; ri[e >> 1] = j0 + c; }
      }

    // Column best over the block's rows (smaller row index on ties).
    float bv[kCols / 8][2];
    int bi[kCols / 8][2];
    _Pragma("unroll") for (int nt = 0; nt < kCols / 8; ++nt)
      _Pragma("unroll") for (int e = 0; e < 2; ++e) {
        const float xa = tile.s[nt][e] + r0[0];
        const float xb = tile.s[nt][e + 2] + r0[1];
        float v = xa;
        int i = row0 + g;
        if (xb > xa) { v = xb; i = row0 + g + 8; }
        _Pragma("unroll") for (int sh = 4; sh <= 16; sh <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, v, sh);
          const int oi = __shfl_xor_sync(0xffffffffu, i, sh);
          if (better(ov, oi, v, i)) { v = ov; i = oi; }
        }
        bv[nt][e] = v;
        bi[nt][e] = i;
      }
    if (g == 0)
      _Pragma("unroll") for (int nt = 0; nt < kCols / 8; ++nt)
        _Pragma("unroll") for (int e = 0; e < 2; ++e) {
          red_v[warp][nt * 8 + t * 2 + e] = bv[nt][e];
          red_i[warp][nt * 8 + t * 2 + e] = bi[nt][e];
        }
    __syncthreads();
    if (warp == 0 && g == 0)
      _Pragma("unroll") for (int nt = 0; nt < kCols / 8; ++nt)
        _Pragma("unroll") for (int e = 0; e < 2; ++e) {
          const int c = nt * 8 + t * 2 + e;
          if (j0 + c >= M) continue;
          float v = red_v[0][c];
          int i = red_i[0][c];
          _Pragma("unroll") for (int w = 1; w < kWarps; ++w)
            if (better(red_v[w][c], red_i[w][c], v, i)) { v = red_v[w][c]; i = red_i[w][c]; }
          const size_t o = ((size_t)b * RT + rt) * M + j0 + c;
          part_best[o] = v;
          part_idx[o] = i;
        }
  }

  _Pragma("unroll") for (int h = 0; h < 2; ++h) {
    float v = rb[h];
    int i = ri[h];
    _Pragma("unroll") for (int sh = 1; sh <= 2; sh <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, sh);
      const int oi = __shfl_xor_sync(0xffffffffu, i, sh);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    const int r = row0 + g + 8 * h;
    if (t == 0 && r < N) {
      v0[(size_t)b * N + r] = v;
      nn0[(size_t)b * N + r] = i;
    }
  }
}

// Pass D: the TPU kernel's column carry, tile by tile in row order.
__global__ void combine_argmax(const float* __restrict__ part_best,
                               const int* __restrict__ part_idx,
                               int* __restrict__ nn1, float* __restrict__ v1,
                               int B, int RT, int M) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * M) return;
  const int b = idx / M, j = idx % M;
  float best = kMasked - 1.0f;  // == -1e9 in f32, as in the TPU kernel
  int bi = 0;
  for (int r = 0; r < RT; ++r) {
    const size_t o = ((size_t)b * RT + r) * M + j;
    if (part_best[o] > best) { best = part_best[o]; bi = part_idx[o]; }
  }
  v1[idx] = best;
  nn1[idx] = bi;
}

template <int DF>
cudaError_t launch(const void* f0, const void* f1, const void* c0,
                   const void* c1, const void* m0, const void* m1, void* nn0,
                   void* v0, void* lse_r, void* nn1, void* v1, void* lse_c,
                   void* part_a, void* part_b, void* part_i, void* cc1, int B,
                   int N, int M, float scale, cudaStream_t stream,
                   int* launched) {
  const int RT = (N + kRows - 1) / kRows;
  const dim3 rows(RT, B);
  const int cols = (B * M + 255) / 256;
  const auto* bf0 = static_cast<const __nv_bfloat16*>(f0);
  const auto* bf1 = static_cast<const __nv_bfloat16*>(f1);
  const auto* um0 = static_cast<const uint8_t*>(m0);
  const auto* um1 = static_cast<const uint8_t*>(m1);
  pass_lse<DF><<<rows, kWarps * 32, 0, stream>>>(
      bf0, bf1, um0, um1, static_cast<float*>(lse_r),
      static_cast<float*>(part_a), static_cast<float*>(part_b), N, M, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  combine_lse<<<cols, 256, 0, stream>>>(
      static_cast<const float*>(part_a), static_cast<const float*>(part_b),
      static_cast<const float*>(c1), um1, static_cast<float*>(lse_c),
      static_cast<float*>(cc1), B, RT, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  // part_a is free again once combine_lse has run (same stream): it holds
  // the pass-C column bests.
  pass_argmax<DF><<<rows, kWarps * 32, 0, stream>>>(
      bf0, bf1, um0, um1, static_cast<const float*>(c0),
      static_cast<const float*>(lse_r), static_cast<const float*>(cc1),
      static_cast<int*>(nn0), static_cast<float*>(v0),
      static_cast<float*>(part_a), static_cast<int*>(part_i), N, M,
      2.0f * scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  combine_argmax<<<cols, 256, 0, stream>>>(
      static_cast<const float*>(part_a), static_cast<const int*>(part_i),
      static_cast<int*>(nn1), static_cast<float*>(v1), B, RT, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  return cudaSuccess;
}

}  // namespace

extern "C" int gl_assignment_fwd(const void* f0, const void* f1,
                                 const void* c0, const void* c1,
                                 const void* m0, const void* m1, void* nn0,
                                 void* v0, void* lse_r, void* nn1, void* v1,
                                 void* lse_c, void* part_a, void* part_b,
                                 void* part_i, void* cc1, int B, int N, int M,
                                 int Df, float scale, void* stream,
                                 int* launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  switch (Df) {
#define GL_CASE(D)                                                         \
  case D:                                                                  \
    return (int)launch<D>(f0, f1, c0, c1, m0, m1, nn0, v0, lse_r, nn1, v1, \
                          lse_c, part_a, part_b, part_i, cc1, B, N, M,     \
                          scale, s, launched);
    GL_CASE(64)
    GL_CASE(128)
    GL_CASE(256)
#undef GL_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
