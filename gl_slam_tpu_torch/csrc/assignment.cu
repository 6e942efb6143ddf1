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
// carries the column reductions in a fori_loop. Here two launches of one
// kernel, assign_pass, do the two passes; the argmax objectives need every
// row's and column's lse, hence the second launch.
//   pass 1 (ARGMAX = false): lse_r and lse_c;
//   pass 2 (ARGMAX = true):  nn0/v0 and nn1/v1, starting each column from
//                            the TPU carry (-1e9, 0), which only a strictly
//                            larger value replaces.
//
// What bounds it: at the prologue shape (8 pairs, N = M = 2048, Df = 256)
// the two passes compute f0 f1^T twice, ~34 GFLOP of bf16 products against
// ~17 MB of inputs: the products bound it (35 us at the peak rate); per
// logit pass 1 adds two exponentials (row and column sums) and both passes
// a reduction over rows and one over columns. At the re-observation shape
// (1 pair, 1024 x 2048; 48 of the 52 calls per 26 frames) and the
// bootstrap's (1 x 2048 x 2048) there are only 8 and 16 row tiles, so a CTA
// per row tile leaves most of the 132 SMs idle, and a call is as long as
// its two launches' fill and drain. The design, in the order the time is
// lost:
//
// 1. Column splits. ops/assignment.assign_plan picks S: where fewer than
//    128 CTAs of 128 rows would run, the columns of each pair are cut into
//    S contiguous ranges of whole 64-column tiles (CTA s takes tiles
//    [s T / S, (s + 1) T / S) of T = ceil(M / 64)); the grid is
//    (S, ceil(N / 128), B).
// 2. Combines inside the launch, in a fixed order. Each CTA writes its
//    row partials (one per row and split) and its column partials (one per
//    column and row tile) to device memory, fences, and takes a ticket
//    (atomicAdd) on its row tile and on its column strip. The CTA that
//    draws the last ticket of a row tile combines the row partials over the
//    splits in split order; the last of a column strip combines the column
//    partials over the row tiles in row order (the TPU's carry). It resets
//    the counter to 0, so no memset launch is needed and a captured graph
//    stays valid. Which CTA is last depends on timing; the order of the
//    sums does not, so two calls give the same bits (no float atomics).
// 3. Two launches, overlapped. Pass 2 is a programmatic dependent launch:
//    its CTAs start on the SMs that pass 1 frees and load their f0 rows,
//    then wait (griddepcontrol.wait) for pass 1 before they read lse_r /
//    lse_c or touch the scratch and the tickets.
// 4. Asynchronous copies. One producer warp loads the CTA's 128 rows of f0
//    once and the f1 tiles of its split through a 3-stage ring (full/empty
//    mbarriers) with TMA (3-d tensor maps over (Df, rows, B), encoded on
//    the host per call, 128-byte swizzle in 64-column chunks; rows past N
//    and M arrive as zeros). With each tile it stages the tile's column
//    fills and, in pass 2, the column terms c1 - lse_c in shared memory.
// 5. wgmma. Two consumer warpgroups own 64 rows each and compute their
//    64 x 64 logits tile with wgmma m64n64k16 (f0 and f1 from shared
//    memory, K-major) into f32 registers; the next tile's product is issued
//    before this tile's reductions run (two accumulators). Row reductions
//    stay in registers (online max and sum of exp, or best and index) and
//    meet across the four threads of a row at the end. For the column
//    reductions each warp writes its 16 x 64 tile to its own shared-memory
//    rows and each lane reduces two columns over them (no shuffles); the
//    eight warps' partials meet once per tile behind one barrier.
// Sizes: 128-row CTAs of 2 consumer warpgroups + 1 producer warp (288
// threads); 64 KB of f0, a 96 KB ring and 36 KB of column scratch at
// Df = 256 (207 KB); one CTA per SM.
//
// Numerics follow the reference: logits = (f0 . f1) * scale in f32 (bf16
// products, f32 sums in the tensor cores' order); masks act as
// min(logit, row fill, column fill) with fills +inf (valid), -1e9 (masked)
// and -inf (past N or M), which is the reference's -1e9 for masked pairs
// while logits lie above -1e9; max and argmax are exact; sums of
// exp(l - max) use ex2.approx on (l - max) log2 e, lse = max + logf(sum),
// the column sum clamped at 1e-30; ties go to the smallest index
// everywhere.
//
// Layouts: f0 (B, N, DF), f1 (B, M, DF) bf16, 16-byte aligned; c0, m0
// (B, N); c1, m1 (B, M) (masks uint8); part_r (B, S, N) and part_c
// (B, ceil(N / 128), M) float2 scratch; tickets int32, B (RT + S) of them,
// zero before the first call; all contiguous.

#include "hopper.cuh"

namespace {

constexpr int kRowTile = 128;                 // f0 rows per CTA
constexpr int kColTile = 64;                  // f1 rows (columns) per stage
constexpr int kStages = 3;
constexpr int kConsumers = 256;               // two warpgroups of 64 rows
constexpr int kWarps = kConsumers / 32;       // 16 rows each
constexpr int kThreads = kConsumers + 32;     // + the producer warp
constexpr int kChunk = 64;                    // bf16 columns per swizzle chunk
constexpr float kMasked = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kScrStride = kColTile + 8;        // floats per scratch row
constexpr int kTail = 16;   // partials in flight per thread in the combines

template <int DF>
struct Geo {
  static constexpr int CHUNKS = DF / kChunk;
  static constexpr int F0_CHUNK = kRowTile * 128;       // bytes
  static constexpr int F1_CHUNK = kColTile * 128;
  static constexpr int F0_BYTES = kRowTile * DF * 2;
  static constexpr int F1_BYTES = kColTile * DF * 2;
  static constexpr int OFF_RING = F0_BYTES;
  // float2 red[2][kWarps][kColTile]: per-warp column partials, two buffers
  static constexpr int OFF_RED = OFF_RING + kStages * F1_BYTES;
  // per stage: float fill[kColTile], term[kColTile] of the tile's columns
  static constexpr int COL_BYTES = kColTile * 8;
  static constexpr int OFF_COL = OFF_RED + 2 * kWarps * kColTile * 8;
  // per warp: its 16 rows x 64 columns of column objectives
  static constexpr int OFF_SCR = OFF_COL + kStages * COL_BYTES;
  static constexpr int OFF_BARS = OFF_SCR + kWarps * 16 * kScrStride * 4;
  static constexpr int OFF_FLAG = OFF_BARS + 8 * (2 * kStages + 1);
  static constexpr int END = OFF_FLAG + 16;
  static constexpr int SMEM = END + 1024;               // + alignment
};

// The mask of a row or column as a bound on its logits: +inf valid, -1e9
// masked, -inf past the end. min(l, row fill, column fill) is the logit of
// a valid pair, -1e9 for a masked pair and -inf past N or M (logits are
// taken to lie above -1e9).
__device__ __forceinline__ float fill_of(bool inside, bool valid) {
  return !inside ? -INFINITY : valid ? INFINITY : kMasked;
}

// (value, index) order: larger value first, then smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// exp(x - m) for m the max over x's set; 0 for x = -inf.
__device__ __forceinline__ float exp_rel(float x, float m) {
  return ex2((x - m) * kLog2e);
}

// The K (max, sum of exp) partials p[0], p[stride], ... combined in order,
// read kTail at a time.
__device__ float2 combine_lse(const float2* p, size_t stride, int K) {
  float m = -INFINITY, sum = 0.f;
  for (int k0 = 0; k0 < K; k0 += kTail) {
    float2 q[kTail];
#pragma unroll
    for (int u = 0; u < kTail; ++u)
      q[u] = k0 + u < K ? __ldcg(p + (k0 + u) * stride)
                        : make_float2(-INFINITY, 0.f);
    float mc = m;
#pragma unroll
    for (int u = 0; u < kTail; ++u) mc = fmaxf(mc, q[u].x);
    float sc = m > -INFINITY ? sum * exp_rel(m, mc) : 0.f;
#pragma unroll
    for (int u = 0; u < kTail; ++u)
      if (q[u].x > -INFINITY) sc += q[u].y * exp_rel(q[u].x, mc);
    m = mc;
    sum = sc;
  }
  return make_float2(m, sum);
}

// The K (value, index bits) partials in order from (v, i), read kTail at
// a time: a strictly larger value replaces the best.
__device__ float2 combine_best(const float2* p, size_t stride, int K, float v,
                               int i) {
  for (int k0 = 0; k0 < K; k0 += kTail) {
    float2 q[kTail];
#pragma unroll
    for (int u = 0; u < kTail; ++u)
      q[u] = k0 + u < K ? __ldcg(p + (k0 + u) * stride)
                        : make_float2(-INFINITY, 0.f);
#pragma unroll
    for (int u = 0; u < kTail; ++u)
      if (q[u].x > v) {
        v = q[u].x;
        i = __float_as_int(q[u].y);
      }
  }
  return make_float2(v, __int_as_float(i));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

template <int DF, bool ARGMAX>
__global__ void __launch_bounds__(kThreads, 1)
assign_pass(const __grid_constant__ CUtensorMap tm_f0,
            const __grid_constant__ CUtensorMap tm_f1,
            const uint8_t* __restrict__ m0, const uint8_t* __restrict__ m1,
            const float* __restrict__ c0, const float* __restrict__ c1,
            float* __restrict__ lse_r, float* __restrict__ lse_c,
            int* __restrict__ nn0, float* __restrict__ v0,
            int* __restrict__ nn1, float* __restrict__ v1,
            float2* __restrict__ part_r, float2* __restrict__ part_c,
            int* __restrict__ tickets, int N, int M, float scale) {
  using G = Geo<DF>;
  extern __shared__ uint8_t smem_raw[];
  // Swizzled tiles need 1024-byte alignment.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_f0 = smem_u32(smem);
  const uint32_t s_bars = s_f0 + G::OFF_BARS;
  auto full = [&](int s) { return s_bars + 8 * s; };
  auto empty = [&](int s) { return s_bars + 8 * (kStages + s); };
  const uint32_t f0bar = s_bars + 8 * 2 * kStages;
  auto f1_tile = [&](int s) { return s_f0 + G::OFF_RING + s * G::F1_BYTES; };
  auto col_fill = [&](int s) {
    return reinterpret_cast<float*>(smem + G::OFF_COL + s * G::COL_BYTES);
  };
  auto col_term = [&](int s) { return col_fill(s) + kColTile; };
  float2* red = reinterpret_cast<float2*>(smem + G::OFF_RED);
  int* flag = reinterpret_cast<int*>(smem + G::OFF_FLAG);

  const int split = blockIdx.x, splits = gridDim.x;
  const int rt = blockIdx.y, RT = gridDim.y;
  const int b = blockIdx.z, B = gridDim.z;
  const int row0 = rt * kRowTile;
  const int n_tiles = (M + kColTile - 1) / kColTile;
  const int t_begin = split * n_tiles / splits;
  const int t_count = (split + 1) * n_tiles / splits - t_begin;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint8_t* m0b = m0 + (size_t)b * N;
  const uint8_t* m1b = m1 + (size_t)b * M;
  const float mul = ARGMAX ? 2.0f * scale : scale;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 33);   // the TMA's expect_tx + 32 producer lanes
      mbar_init(empty(s), kConsumers);
    }
    mbar_init(f0bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // Programmatic dependent launch: pass 2 may start on the SMs that pass 1
  // frees and load its f0 rows (written before pass 1 began); it waits for
  // pass 1 to finish before it reads lse_r / lse_c or touches the scratch
  // and the tickets. Both instructions are no-ops in a plain launch.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (warp == kWarps) {
    // Producer: f0's rows once, then f1 tiles with their column fills
    // (and, in pass 2, the column terms c1 - lse_c) through the ring.
    if (lane == 0) {
      mbar_expect_tx(f0bar, G::F0_BYTES);
      for (int c = 0; c < G::CHUNKS; ++c)
        tma_load(s_f0 + c * G::F0_CHUNK, &tm_f0, f0bar, c * kChunk, row0, b);
    }
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const float* c1b = c1 + (size_t)b * M;
    const float* lcb = lse_c + (size_t)b * M;
    for (int it = 0; it < t_count; ++it) {
      const int s = it % kStages;
      const int j0 = (t_begin + it) * kColTile;
      // The tile's column data, read before its slot is free.
      float fill[kColTile / 32], term[kColTile / 32];
#pragma unroll
      for (int u = 0; u < kColTile / 32; ++u) {
        const int j = j0 + lane + 32 * u;
        const bool valid = j < M && m1b[j];
        fill[u] = fill_of(j < M, valid);
        term[u] = 0.f;
        if (ARGMAX && j < M) term[u] = valid ? c1b[j] - lcb[j] : kMasked;
      }
      mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_expect_tx(full(s), G::F1_BYTES);
        for (int c = 0; c < G::CHUNKS; ++c)
          tma_load(f1_tile(s) + c * G::F1_CHUNK, &tm_f1, full(s), c * kChunk,
                   j0, b);
      }
#pragma unroll
      for (int u = 0; u < kColTile / 32; ++u) {
        col_fill(s)[lane + 32 * u] = fill[u];
        col_term(s)[lane + 32 * u] = term[u];
      }
      mbar_arrive(full(s));
    }
    return;
  }

  // Consumers. Warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile; in
  // the accumulator warp w % 4 of the group holds rows 16 (w % 4) + g and
  // + 8 (g = lane / 4), thread t = lane % 4 columns 8 n + 2 t and + 1 of
  // each 8-column block n: element 4 n + e is (row half e >> 1, column
  // 8 n + 2 t + (e & 1)).
  const int wg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int wrow0 = row0 + warp * 16;    // the warp's first row
  const int rows[2] = {wrow0 + g, wrow0 + g + 8};
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float rfill[2];
  float rterm[2];          // pass 2: c0 - lse_r of the row (-1e9 masked)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rows[h];
    const bool valid = r < N && m0b[r];
    rfill[h] = fill_of(r < N, valid);
    rterm[h] = 0.f;
    if (ARGMAX && r < N)
      rterm[h] = valid ? c0[(size_t)b * N + r] - lse_r[(size_t)b * N + r]
                       : kMasked;
  }
  // Row carries: pass 1 (running max, this thread's sum of exp), pass 2
  // (best, index).
  float r_a[2] = {-INFINITY, -INFINITY};
  float r_s[2] = {0.f, 0.f};
  int r_i[2] = {0x7fffffff, 0x7fffffff};
  float* scr = reinterpret_cast<float*>(smem + G::OFF_SCR) +
               warp * 16 * kScrStride;

  const uint32_t s_f0w = s_f0 + wg * 64 * 128;   // this group's rows
  auto issue = [&](int s, float* acc) {
#pragma unroll
    for (int kk = 0; kk < DF / 16; ++kk) {
      const uint32_t off = (kk * 16 % kChunk) * 2;
      const int chunk = kk * 16 / kChunk;
      wgmma_ss_m64n64k16(
          acc, make_desc(s_f0w + chunk * G::F0_CHUNK + off, 16, 1024, 1),
          make_desc(f1_tile(s) + chunk * G::F1_CHUNK + off, 16, 1024, 1),
          kk > 0);
    }
  };

  // The reductions of tile `it` (its products in acc).
  auto process = [&](int it, float* acc) {
    const int s = it % kStages;
    const int j0 = (t_begin + it) * kColTile;
    float cf[kColTile / 8][2], ct[kColTile / 8][2];
#pragma unroll
    for (int n = 0; n < kColTile / 8; ++n) {
      const int c = 8 * n + 2 * t;
      const float2 fl = *reinterpret_cast<const float2*>(col_fill(s) + c);
      cf[n][0] = fl.x;
      cf[n][1] = fl.y;
      if (ARGMAX) {
        const float2 tm = *reinterpret_cast<const float2*>(col_term(s) + c);
        ct[n][0] = tm.x;
        ct[n][1] = tm.y;
      }
    }
    mbar_arrive(empty(s));   // the tile and its column data are read
    // The logits go to their own registers: an accumulator written by
    // other instructions makes ptxas serialize the products (C7515).
    float x[32];
#pragma unroll
    for (int n = 0; n < kColTile / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[4 * n + e] = fminf(fminf(acc[4 * n + e] * mul, cf[n][e & 1]),
                             rfill[e >> 1]);
    if (!ARGMAX) {
      // Row: online max and sum of exp over this thread's columns.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mt = -INFINITY;
#pragma unroll
        for (int n = 0; n < kColTile / 8; ++n)
          mt = fmaxf(mt, fmaxf(x[4 * n + 2 * h], x[4 * n + 2 * h + 1]));
        const float mn = fmaxf(r_a[h], mt);
        if (mn > -INFINITY) {
          float sum = r_a[h] > -INFINITY ? r_s[h] * exp_rel(r_a[h], mn) : 0.f;
#pragma unroll
          for (int n = 0; n < kColTile / 8; ++n)
            sum += exp_rel(x[4 * n + 2 * h], mn) +
                   exp_rel(x[4 * n + 2 * h + 1], mn);
          r_s[h] = sum;
          r_a[h] = mn;
        }
      }
    } else {
      // Row: best of 2 sim + (c1 - lse_c), columns in increasing order.
#pragma unroll
      for (int n = 0; n < kColTile / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = x[4 * n + e] + ct[n][e & 1];
          if (y > r_a[e >> 1]) {
            r_a[e >> 1] = y;
            r_i[e >> 1] = j0 + 8 * n + 2 * t + (e & 1);
          }
        }
    }
    // Column: the warp's 16 x 64 column objectives (the logits, in pass 2
    // plus c0 - lse_r) go through its scratch rows; lane l then reduces
    // columns 2 l and 2 l + 1 over the 16 rows in row order.
    __syncwarp();   // the warp is done reading the last tile's scratch
#pragma unroll
    for (int n = 0; n < kColTile / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(scr + (g + 8 * h) * kScrStride + 8 * n +
                                   2 * t) =
            make_float2(x[4 * n + 2 * h] + rterm[h],
                        x[4 * n + 2 * h + 1] + rterm[h]);
    __syncwarp();
    float2 col[16];
#pragma unroll
    for (int r = 0; r < 16; ++r)
      col[r] = *reinterpret_cast<const float2*>(scr + r * kScrStride +
                                                2 * lane);
    float4 part;
    if (!ARGMAX) {
      float ma = col[0].x, mb = col[0].y;
#pragma unroll
      for (int r = 1; r < 16; ++r) {
        ma = fmaxf(ma, col[r].x);
        mb = fmaxf(mb, col[r].y);
      }
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        sa += exp_rel(col[r].x, ma);
        sb += exp_rel(col[r].y, mb);
      }
      // a warp whose 16 rows all lie past N holds -inf everywhere
      part = make_float4(ma, ma > -INFINITY ? sa : 0.f, mb,
                         mb > -INFINITY ? sb : 0.f);
    } else {
      // rows in order: a strictly larger value wins
      float va = col[0].x, vb = col[0].y;
      int ia = 0, ib = 0;
#pragma unroll
      for (int r = 1; r < 16; ++r) {
        if (col[r].x > va) { va = col[r].x; ia = r; }
        if (col[r].y > vb) { vb = col[r].y; ib = r; }
      }
      part = make_float4(va, __int_as_float(wrow0 + ia), vb,
                         __int_as_float(wrow0 + ib));
    }
    float2* red_w = red + ((it & 1) * kWarps + warp) * kColTile;
    *reinterpret_cast<float4*>(red_w + 2 * lane) = part;
    // The tile's column partial over the CTA's 128 rows, warps in row
    // order. The two red buffers alternate, so one barrier per tile does.
    consumer_sync();
    if (threadIdx.x < kColTile && j0 + threadIdx.x < M) {
      const float2* cp = red + (it & 1) * kWarps * kColTile + threadIdx.x;
      float2 p = cp[0];
      if (!ARGMAX) {
        float m = p.x;
#pragma unroll
        for (int w = 1; w < kWarps; ++w) m = fmaxf(m, cp[w * kColTile].x);
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float2 q = cp[w * kColTile];
          if (q.x > -INFINITY) sum += q.y * exp_rel(q.x, m);
        }
        p = make_float2(m, sum);
      } else {
        // warps in row order: a strictly larger value wins
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
          const float2 q = cp[w * kColTile];
          if (q.x > p.x) p = q;
        }
      }
      part_c[((size_t)b * RT + rt) * M + j0 + threadIdx.x] = p;
    }
  };

  float acc_a[32], acc_b[32];
  mbar_wait(f0bar, 0);
  mbar_wait(full(0), 0);
  __syncwarp();  // the products are warp-aligned
  wgmma_fence();
  issue(0, acc_a);
  wgmma_commit();
  // Tile it: the product of tile it + 1 is issued before the reductions of
  // tile it run. The last tile, with no product to issue, is peeled off so
  // that every step issues the same products.
  auto step = [&](int it, float* cur, float* nxt, bool last) {
    if (!last) {
      const int sn = (it + 1) % kStages;
      mbar_wait(full(sn), ((it + 1) / kStages) & 1);
      __syncwarp();
      wgmma_fence();
      issue(sn, nxt);
      wgmma_commit();
      wgmma_wait<1>();   // tile it is in; tile it + 1 may still run
    } else {
      wgmma_wait<0>();
    }
    fence_regs<32>(cur);
    process(it, cur);
  };
  for (int it = 0; it + 1 < t_count; ++it) {
    if (it & 1)
      step(it, acc_b, acc_a, false);
    else
      step(it, acc_a, acc_b, false);
  }
  if ((t_count - 1) & 1)
    step(t_count - 1, acc_b, acc_a, true);
  else
    step(t_count - 1, acc_a, acc_b, true);

  // This split's row results: the four threads of a row meet.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float2 p;
    if (!ARGMAX) {
      float m = r_a[h];
      m = fmaxf(m, __shfl_xor_sync(~0u, m, 1));
      m = fmaxf(m, __shfl_xor_sync(~0u, m, 2));
      float sum = r_a[h] > -INFINITY ? r_s[h] * exp_rel(r_a[h], m) : 0.f;
      sum += __shfl_xor_sync(~0u, sum, 1);
      sum += __shfl_xor_sync(~0u, sum, 2);
      p = make_float2(m, sum);
    } else {
      float v = r_a[h];
      int i = r_i[h];
#pragma unroll
      for (int sh = 1; sh <= 2; sh <<= 1) {
        const float ov = __shfl_xor_sync(~0u, v, sh);
        const int oi = __shfl_xor_sync(~0u, i, sh);
        if (better(ov, oi, v, i)) { v = ov; i = oi; }
      }
      p = make_float2(v, __int_as_float(i));
    }
    const int r = rows[h];
    if (t == 0 && r < N) {
      const size_t o = (size_t)b * N + r;
      if (splits > 1) {
        part_r[((size_t)b * splits + split) * N + r] = p;
      } else if (!ARGMAX) {
        lse_r[o] = p.x + logf(p.y);
      } else {
        v0[o] = p.x;
        nn0[o] = __float_as_int(p.y);
      }
    }
  }

  // Tickets: the last CTA of a row tile (over the splits) and of a column
  // strip (over the row tiles) combines the partials in a fixed order.
  __threadfence();
  consumer_sync();
  int* tick_r = tickets + (size_t)b * RT + rt;
  int* tick_c = tickets + (size_t)B * RT + (size_t)b * splits + split;
  if (threadIdx.x == 0) {
    int last = 0;
    if (splits > 1 && atomicAdd(tick_r, 1) == splits - 1) {
      *tick_r = 0;
      last |= 1;
    }
    if (atomicAdd(tick_c, 1) == RT - 1) {
      *tick_c = 0;
      last |= 2;
    }
    *flag = last;
  }
  consumer_sync();
  const int last = *flag;
  if (last == 0) return;
  __threadfence();

  // A CTA last for both runs the row combine on threads 0-127 and the
  // column combine on 128-255.
  if ((last & 1) && threadIdx.x < kRowTile && row0 + threadIdx.x < N) {
    const int r = row0 + threadIdx.x;
    const float2* pr = part_r + (size_t)b * splits * N + r;
    const size_t o = (size_t)b * N + r;
    if (!ARGMAX) {
      const float2 p = combine_lse(pr, N, splits);
      lse_r[o] = p.x + logf(p.y);
    } else {
      // splits hold increasing columns: a strictly larger value wins
      const float2 p = combine_best(pr, N, splits, -INFINITY, 0x7fffffff);
      v0[o] = p.x;
      nn0[o] = __float_as_int(p.y);
    }
  }
  const int c_first = (last & 1) ? kRowTile : 0;
  if ((last & 2) && (int)threadIdx.x >= c_first) {
    const int j_end = min((t_begin + t_count) * kColTile, M);
    for (int j = t_begin * kColTile + threadIdx.x - c_first; j < j_end;
         j += kConsumers - c_first) {
      const float2* pc = part_c + (size_t)b * RT * M + j;
      const size_t o = (size_t)b * M + j;
      if (!ARGMAX) {
        const float2 p = combine_lse(pc, M, RT);
        lse_c[o] = p.x + logf(fmaxf(p.y, 1e-30f));
      } else {
        // the TPU's carry: start at (-1e9, 0) (kMasked - 1 == -1e9 in
        // f32), row tiles in order, a strictly larger value wins
        const float2 p = combine_best(pc, M, RT, kMasked - 1.0f, 0);
        v1[o] = p.x;
        nn1[o] = __float_as_int(p.y);
      }
    }
  }
}

template <int DF, bool ARGMAX>
cudaError_t launch_pass(const CUtensorMap& tm_f0, const CUtensorMap& tm_f1,
                        const void* m0, const void* m1, const void* c0,
                        const void* c1, void* nn0, void* v0, void* lse_r,
                        void* nn1, void* v1, void* lse_c, void* part_r,
                        void* part_c, void* tickets, int B, int N, int M,
                        float scale, int splits, cudaStream_t stream) {
  using G = Geo<DF>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        assign_pass<DF, ARGMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + kRowTile - 1) / kRowTile, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  // pass 2 overlaps its start with pass 1's end (griddepcontrol above)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = ARGMAX ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, assign_pass<DF, ARGMAX>, tm_f0, tm_f1,
      static_cast<const uint8_t*>(m0),
      static_cast<const uint8_t*>(m1), static_cast<const float*>(c0),
      static_cast<const float*>(c1), static_cast<float*>(lse_r),
      static_cast<float*>(lse_c), static_cast<int*>(nn0),
      static_cast<float*>(v0), static_cast<int*>(nn1),
      static_cast<float*>(v1), static_cast<float2*>(part_r),
      static_cast<float2*>(part_c), static_cast<int*>(tickets), N, M, scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int DF>
cudaError_t launch(const void* f0, const void* f1, const void* c0,
                   const void* c1, const void* m0, const void* m1, void* nn0,
                   void* v0, void* lse_r, void* nn1, void* v1, void* lse_c,
                   void* part_r, void* part_c, void* tickets, int B, int N,
                   int M, float scale, int splits, cudaStream_t stream,
                   int* launched) {
  CUtensorMap tm_f0, tm_f1;
  if (!make_map_bf16(&tm_f0, f0, DF, N, B, kChunk, kRowTile,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_bf16(&tm_f1, f1, DF, M, B, kChunk, kColTile,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_pass<DF, false>(
      tm_f0, tm_f1, m0, m1, c0, c1, nn0, v0, lse_r, nn1, v1, lse_c, part_r,
      part_c, tickets, B, N, M, scale, splits, stream);
  if (err != cudaSuccess) return err;
  ++*launched;
  err = launch_pass<DF, true>(tm_f0, tm_f1, m0, m1, c0, c1, nn0, v0, lse_r,
                              nn1, v1, lse_c, part_r, part_c, tickets, B, N,
                              M, scale, splits, stream);
  if (err != cudaSuccess) return err;
  ++*launched;
  return cudaSuccess;
}

}  // namespace

// splits (1 <= splits <= ceil(M / 64)) comes from ops/assignment.assign_plan.
extern "C" int gl_assignment_fwd(const void* f0, const void* f1,
                                 const void* c0, const void* c1,
                                 const void* m0, const void* m1, void* nn0,
                                 void* v0, void* lse_r, void* nn1, void* v1,
                                 void* lse_c, void* part_r, void* part_c,
                                 void* tickets, int B, int N, int M, int Df,
                                 float scale, int splits, void* stream,
                                 int* launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  if (B <= 0 || N <= 0 || M <= 0 || B > 65535 ||
      (N + kRowTile - 1) / kRowTile > 65535 || splits < 1 ||
      splits > (M + kColTile - 1) / kColTile)
    return (int)cudaErrorInvalidValue;
  switch (Df) {
#define GL_CASE(D)                                                          \
  case D:                                                                   \
    return (int)launch<D>(f0, f1, c0, c1, m0, m1, nn0, v0, lse_r, nn1, v1,  \
                          lse_c, part_r, part_c, tickets, B, N, M, scale,   \
                          splits, s, launched);
    GL_CASE(64)
    GL_CASE(128)
    GL_CASE(256)
#undef GL_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
