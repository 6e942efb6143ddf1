// Fused masked multi-head attention for the LightGlue matcher (Hopper).
//
// Replaces the Pallas kernel gl_slam_tpu/ops/attention.py:attention_pallas
// (_attn_kernel). That kernel keeps one head's whole K and V resident in
// VMEM and computes one (query tile x all keys) logits tile at once. On the
// H100 a block has at most 227 KB of shared memory, and one head's K and V at
// Nk = 2048, dh = 128 in bf16 take 512 KB each, so K and V stream through
// shared memory in key tiles and the softmax runs online (running row max
// and sum in f32).
//
// What bounds it: the prologue calls (8 pairs x 2 sets x 2 heads, Nq = Nk =
// 2048, dh = 128) do ~69 GFLOP against ~25 MB of traffic: bound by
// tensor-core operations (>= 70 us at 989 TFLOP/s bf16). The re-observation
// calls (1 set x 2 heads, 1024/2048 queries and keys) do 1-4 GFLOP each,
// but give only 16-32 query tiles, so a CTA per tile leaves most of the
// 132 SMs idle. The design, in the order the time is lost:
//
// 1. Key split. ops/attention.split_plan picks S in {1, 2, 4, 8}: where
//    fewer than 64 CTAs of 128 query rows would run, the grid is
//    (S, ceil(Nq/128), BH) in clusters of S CTAs over one query tile, S the
//    least that gives 64 CTAs (measured fastest on the H100, ahead of 128).
//    CTA s walks key tiles [s T / S, (s + 1) T / S) of the T = ceil(Nk/64)
//    and keeps its partial (m, l, O) in shared memory. After a cluster
//    barrier CTA s combines rows [s 128/S, (s + 1) 128/S) of all S
//    partials, read over distributed shared memory in rank order
//    (deterministic), and stores them. One launch per call; S = 1 is the
//    same path with a cluster of one.
// 2. Asynchronous copies. One thread of a producer warpgroup (which hands
//    its registers to the consumers with setmaxnreg) issues TMA copies (3-d
//    tensor maps over (dh, N, BH), encoded on the host per call) of the Q
//    tile once and of K and V tiles into a 3-stage ring with full/empty
//    mbarriers; TMA zero-fills rows past Nq and Nk. Tiles land in the
//    128-byte swizzle (64-byte for dh = 32) in column chunks of 64 (32) bf16.
//    A K/V tile serves 128 query rows, which halves the L2 reads of 64-row
//    tiles (the prologue re-reads each head's K and V 16 times). Unsplit
//    calls take 96-key tiles: the S product then reads its Q operand from
//    shared memory once per 96 keys instead of once per 64.
// 3. wgmma. Two consumer warpgroups own 64 query rows each. S = Q K^T is
//    wgmma m64n{64,96}k16 with Q and K from shared memory, both K-major.
//    O += P V is wgmma m64n{dh}k16 with P from registers (the f32 S
//    accumulator, masked, exponentiated and packed to bf16: its layout is
//    the register-A layout) and V from shared memory as stored, [key][d],
//    read N-major through wgmma's transpose flag. The groups take turns on
//    the tensor cores (named barriers): one issues P V of its tile with S
//    of its next tile while the other runs its softmax; a group's softmax
//    of the next tile starts as soon as its S is in, while its P V runs.
// Sizes: Q tile 128; key tile 64 (split) or 96; 3 stages; 2 consumer
// warpgroups + 1 producer warpgroup (384 threads, 240/24 registers);
// 135 KB (64) or 183 KB (96) of shared memory at dh = 128, one CTA per SM.
//
// Numerics follow the reference: logits = (q.k) * scale in f32, masked keys
// are -1e9 (not -inf, so a row whose keys are all masked averages v), keys
// past Nk are -inf, the softmax sum is clamped at >= 1e-20, p is rounded to
// bf16 before the product with v (relative to its split's running max), the
// output is f32. A split's all-masked keys give m = -1e9 and weigh
// exp(-1e9 - M) = 0 in the combine unless every key of the set is masked;
// a split with no key below Nk (which split_plan never makes) weighs 0.
//
// Layouts: q (BH, Nq, DH), k/v (BH, Nk, DH) bf16 contiguous, 16-byte
// aligned; mask (B, Nk) uint8 with B = BH / H; out (BH, Nq, DH) f32.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumerWGs = 2;                // 64 query rows each
constexpr int kQTile = 64 * kConsumerWGs;       // query rows per CTA
constexpr int kStages = 3;                      // K/V ring
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreads = kConsumers + 128;      // + the producer warpgroup
constexpr int kMaxSplits = 8;
// Logits run in base-2 units (scaled by log2 e), so p = 2^(x - m). The
// masked sentinel stays -1e9: exp(-1e9 - m) and 2^(-1e9 - m) are both 0
// against any unmasked logit, and both 1 when every key is masked.
constexpr float kMasked = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory geometry for head dim DH and key tile KT.
template <int DH, int KT>
struct Geo {
  static constexpr int CC = DH < 64 ? DH : 64;  // bf16 columns per chunk
  static constexpr int SWB = CC * 2;            // bytes per chunk row
  static constexpr int CHUNKS = DH / CC;
  static constexpr uint64_t LAYOUT = SWB == 128 ? 1 : 2;   // wgmma swizzle
  static constexpr CUtensorMapSwizzle TMA_SWIZZLE =
      SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr int Q_BYTES = kQTile * DH * 2;
  static constexpr int KV_BYTES = KT * DH * 2;         // K or V tile
  static constexpr int Q_CHUNK = kQTile * SWB;
  static constexpr int KV_CHUNK = KT * SWB;
  static constexpr int OFF_RING = Q_BYTES;                 // K0 V0 K1 V1 ..
  static constexpr int OFF_BARS = OFF_RING + kStages * 2 * KV_BYTES;
  static constexpr int OFF_ML = OFF_BARS + 64;             // m[], l[]
  static constexpr int OFF_W = OFF_ML + 2 * kQTile * 4;    // w[][8], inv[]
  static constexpr int END = OFF_W + kQTile * (kMaxSplits + 1) * 4;
  static constexpr int SMEM = END + 1024;                  // + alignment
  static constexpr int PART_STRIDE = DH + 4;               // f32 partial O
  static_assert(kQTile * PART_STRIDE * 4 <= kStages * 2 * KV_BYTES,
                "the partial O reuses the ring");
};

// d[48] (+)= A (64 x 16) B (16 x 96), both from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_m64n96k16(float* d, uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[16] += A (64 x 16, registers) B (16 x 32, shared memory, N-major).
__device__ __forceinline__ void wgmma_rs_m64n32k16(float* d, const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "n"(1));
}

// d[32] += A (64 x 16, registers) B (16 x 64, shared memory, N-major).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "n"(1));
}

// d[64] += A (64 x 16, registers) B (16 x 128, shared memory, N-major).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float* d, const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "n"(1));
}


template <int KT>
__device__ __forceinline__ void wgmma_s(float* d, uint64_t da, uint64_t db,
                                        int accumulate) {
  if constexpr (KT == 64) wgmma_ss_m64n64k16(d, da, db, accumulate);
  else wgmma_ss_m64n96k16(d, da, db, accumulate);
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (DH == 32) wgmma_rs_m64n32k16(o, a, db);
  else if constexpr (DH == 64) wgmma_rs_m64n64k16(o, a, db);
  else wgmma_rs_m64n128k16(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH, int KT>
__global__ void __launch_bounds__(kThreads, 1)
attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int H, int Nq, int Nk, float scale) {
  using G = Geo<DH, KT>;
  extern __shared__ uint8_t smem_raw[];
  // Swizzled tiles need 1024-byte alignment.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_ring = s_q + G::OFF_RING;
  const uint32_t s_bars = s_q + G::OFF_BARS;
  // bars: full[kStages], empty[kStages], q
  auto full = [&](int s) { return s_bars + 8 * s; };
  auto empty = [&](int s) { return s_bars + 8 * (kStages + s); };
  const uint32_t qbar = s_bars + 8 * 2 * kStages;
  auto k_tile = [&](int s) { return s_ring + 2 * s * G::KV_BYTES; };
  auto v_tile = [&](int s) { return k_tile(s) + G::KV_BYTES; };
  float* part = reinterpret_cast<float*>(smem + G::OFF_RING);
  float* part_m = reinterpret_cast<float*>(smem + G::OFF_ML);
  float* part_l = part_m + kQTile;
  float* wts = reinterpret_cast<float*>(smem + G::OFF_W);
  float* inv = wts + kQTile * kMaxSplits;

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = gridDim.x, rank = blockIdx.x;
  const int q0 = blockIdx.y * kQTile, bh = blockIdx.z;
  const int n_tiles = (Nk + KT - 1) / KT;
  const int t_begin = rank * n_tiles / splits;
  const int t_count = (rank + 1) * n_tiles / splits - t_begin;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // Producer: the Q tile once, then K and V tiles through the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(qbar, G::Q_BYTES);
      for (int c = 0; c < G::CHUNKS; ++c)
        tma_load(s_q + c * G::Q_CHUNK, &tm_q, qbar, c * G::CC, q0, bh);
      for (int it = 0; it < t_count; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * G::KV_BYTES);
        const int j0 = (t_begin + it) * KT;
        for (int c = 0; c < G::CHUNKS; ++c) {
          tma_load(k_tile(s) + c * G::KV_CHUNK, &tm_k, full(s), c * G::CC,
                   j0, bh);
          tma_load(v_tile(s) + c * G::KV_CHUNK, &tm_v, full(s), c * G::CC,
                   j0, bh);
        }
      }
    }
    __syncwarp();
    cluster.sync();  // the partials are written
    cluster.sync();  // and combined
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // Consumer warpgroup wg owns query rows 64 wg .. 64 wg + 63. In the
    // accumulators warp w of the group holds rows 16 w + g and 16 w + g + 8
    // (g = lane / 4), and thread t = lane % 4 columns 8 n + 2 t and
    // 8 n + 2 t + 1 of each 8-column block n.
    const int wg = warp / 4;
    const int g = lane / 4, t = lane % 4;
    const float scale2 = scale * kLog2e;
    const uint8_t* mrow = mask + (size_t)(bh / H) * Nk;
    const uint32_t s_qw = s_q + wg * 64 * G::SWB;  // this group's Q rows
    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
    // Mask bytes of the next tile, loaded a tile ahead.
    constexpr int kWords = KT / 32;
    uint8_t mk[kWords];
    auto load_mask = [&](int j0) {
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        mk[w] = j0 + 32 * w + lane < Nk ? mrow[j0 + 32 * w + lane] : 0;
    };
    float sacc[KT / 2];  // S of the tile in flight, then its P (f32)
    // P of a tile, bf16 in the register-A layout: two buffers, since the
    // softmax of the next tile runs while P V of this one reads its P.
    uint32_t pa0[KT / 4], pa1[KT / 4];
    float corr[2];            // rescaling of O and l for the tile's max
    bool rescale;             // some row of the warp has a new max

    auto issue_s = [&](int s) {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk * 16 % G::CC) * 2;
        const int chunk = kk * 16 / G::CC;
        wgmma_s<KT>(
            sacc,
            make_desc(s_qw + chunk * G::Q_CHUNK + off, 16, 8 * G::SWB,
                      G::LAYOUT),
            make_desc(k_tile(s) + chunk * G::KV_CHUNK + off, 16, 8 * G::SWB,
                      G::LAYOUT),
            kk > 0);
      }
    };
    auto issue_pv = [&](int s, const uint32_t* pa) {
#pragma unroll
      for (int ks = 0; ks < KT / 16; ++ks)
        wgmma_pv<DH>(o, pa + 4 * ks,
                     make_desc(v_tile(s) + ks * 16 * G::SWB, G::KV_CHUNK,
                               8 * G::SWB, G::LAYOUT));
    };
    // Scale and mask S of tile `it`, update the running max and sum, and
    // leave its weights in pa and the rescaling of O in corr.
    auto softmax = [&](int it, uint32_t* pa) {
      const int j0 = (t_begin + it) * KT;
      // Bits of the tile's keys, valid (unmasked) and below Nk; each word
      // is then shifted so that the key of element (n, e) is bit
      // 8 (n % 4) + (e & 1) of word n / 4.
      uint32_t valid[kWords], inside[kWords];
      bool plain = true;  // every key valid and below Nk (warp-uniform)
      const int n_in = Nk - j0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const int n_w = n_in - 32 * w;
        valid[w] = __ballot_sync(~0u, mk[w]);
        inside[w] = n_w >= 32 ? ~0u : n_w <= 0 ? 0u : (1u << n_w) - 1u;
        plain = plain && (valid[w] & inside[w]) == ~0u;
        valid[w] >>= 2 * t;
        inside[w] >>= 2 * t;
      }
      if (it + 1 < t_count) load_mask(j0 + KT);
      float m_tile[2] = {-INFINITY, -INFINITY};
      if (plain) {
        // The row max of the raw products; scale2 > 0 keeps it the max.
#pragma unroll
        for (int i = 0; i < KT / 2; ++i)
          m_tile[(i >> 1) & 1] = fmaxf(m_tile[(i >> 1) & 1], sacc[i]);
        m_tile[0] *= scale2;
        m_tile[1] *= scale2;
      } else {
#pragma unroll
        for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t bit = 1u << (8 * (n % 4) + (e & 1));
            float x = sacc[4 * n + e] * scale2;
            x = (inside[n / 4] & bit) ? ((valid[n / 4] & bit) ? x : kMasked)
                                      : -INFINITY;
            sacc[4 * n + e] = x;
            m_tile[e >> 1] = fmaxf(m_tile[e >> 1], x);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_tile[h] = fmaxf(m_tile[h], __shfl_xor_sync(~0u, m_tile[h], 1));
        m_tile[h] = fmaxf(m_tile[h], __shfl_xor_sync(~0u, m_tile[h], 2));
        const float m_new = fmaxf(m_run[h], m_tile[h]);  // finite: >= -1e9
        corr[h] = ex2(m_run[h] - m_new);
        m_run[h] = m_new;
        l_run[h] *= corr[h];
      }
      // corr = 1 leaves O as it is: skip the multiplications.
      rescale = __any_sync(~0u, corr[0] != 1.f || corr[1] != 1.f);
      // p = 2^(x - m), x = s scale2 (fused on the plain path).
      const float sc = plain ? scale2 : 1.f;
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) {
        const float p = ex2(fmaf(sacc[i], sc, -m_run[(i >> 1) & 1]));
        sacc[i] = p;
        l_run[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int i = 0; i < KT / 4; ++i)
        pa[i] = pack_bf16(sacc[2 * i], sacc[2 * i + 1]);
    };
    // The two groups take turns on the tensor cores (named barriers 2 and
    // 3): one issues its products while the other runs its softmax. Turn
    // k of a group issues S of its first tile (k = 0), or P V of tile k - 1
    // with S of tile k; group 0 takes turn 0 first.
    auto turn_begin = [&](int k) {
      if (wg == 1)
        asm volatile("bar.sync 3, %0;\n" :: "n"(kConsumers) : "memory");
      else if (k > 0)
        asm volatile("bar.sync 2, %0;\n" :: "n"(kConsumers) : "memory");
    };
    auto turn_end = [&](int k) {
      if (wg == 0)
        asm volatile("bar.arrive 3, %0;\n" :: "n"(kConsumers) : "memory");
      else if (k < t_count)
        asm volatile("bar.arrive 2, %0;\n" :: "n"(kConsumers) : "memory");
    };

    load_mask(t_begin * KT);
    mbar_wait(qbar, 0);
    mbar_wait(full(0), 0);
    __syncwarp();  // the products are warp-aligned
    turn_begin(0);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    turn_end(0);
    wgmma_wait<0>();
    fence_regs<KT / 2>(sacc);
    softmax(0, pa0);

    // Tile it: S of tile it + 1 and P V of tile it go out together; the
    // softmax of tile it + 1 runs as soon as its S is in, while P V runs.
    // The last tile, with no S to issue, is peeled off, so that every step
    // issues the same products (else ptxas serializes them).
    auto step = [&](int it, uint32_t* pa, uint32_t* pa_next, bool last) {
      const int s = it % kStages, s_next = (it + 1) % kStages;
      if (!last) {
        mbar_wait(full(s_next), ((it + 1) / kStages) & 1);
        __syncwarp();
      }
      if (rescale) {
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      }
      turn_begin(it + 1);
      wgmma_fence();
      if (!last) {
        issue_s(s_next);
        wgmma_commit();
      }
      issue_pv(s, pa);  // O += P V, V as stored ([key][d])
      wgmma_commit();
      turn_end(it + 1);
      if (!last) {
        wgmma_wait<1>();  // S is in; P V may still run
        fence_regs<KT / 2>(sacc);
        softmax(it + 1, pa_next);
      }
      wgmma_wait<0>();
      fence_regs<DH / 2>(o);
      fence_regs<KT / 4>(pa);
      mbar_arrive(empty(s));
    };
    for (int it = 0; it + 1 < t_count; ++it) {
      if (it & 1)
        step(it, pa1, pa0, false);
      else
        step(it, pa0, pa1, false);
    }
    if ((t_count - 1) & 1)
      step(t_count - 1, pa1, pa0, true);
    else
      step(t_count - 1, pa0, pa1, true);

    // The partial (m, l, O) of this split into shared memory. The ring is
    // free once both groups are past their last tile: every copy into it
    // has landed and been read.
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
    const int ra = wg * 64 + (warp % 4) * 16 + g, rb = ra + 8;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int c = n * 8 + t * 2;
      *reinterpret_cast<float2*>(part + ra * G::PART_STRIDE + c) =
          make_float2(o[4 * n], o[4 * n + 1]);
      *reinterpret_cast<float2*>(part + rb * G::PART_STRIDE + c) =
          make_float2(o[4 * n + 2], o[4 * n + 3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(~0u, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(~0u, l_run[h], 2);
    }
    if (t == 0) {
      part_m[ra] = m_run[0];
      part_m[rb] = m_run[1];
      part_l[ra] = l_run[0];
      part_l[rb] = l_run[1];
    }

    // Combine: CTA `rank` finishes rows [r0, r0 + rows) of the query tile
    // from the S partials of its cluster, in rank order.
    cluster.sync();
    const int rows = kQTile / splits, r0 = rank * rows;
    if (threadIdx.x < rows) {
      const int r = r0 + threadIdx.x;
      float M = -INFINITY;
      for (int s = 0; s < splits; ++s)
        M = fmaxf(M, cluster.map_shared_rank(part_m, s)[r]);
      float L = 0.f;
      for (int s = 0; s < splits; ++s) {
        const float m = cluster.map_shared_rank(part_m, s)[r];
        const float w = m == -INFINITY ? 0.f : ex2(m - M);
        wts[threadIdx.x * kMaxSplits + s] = w;
        L += w * cluster.map_shared_rank(part_l, s)[r];
      }
      inv[threadIdx.x] = 1.f / fmaxf(L, 1e-20f);
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
    float* oh = out + ((size_t)bh * Nq + q0) * DH;
    for (int i = threadIdx.x; i < rows * (DH / 4); i += kConsumers) {
      const int rl = i / (DH / 4), c = (i % (DH / 4)) * 4, r = r0 + rl;
      if (q0 + r >= Nq) continue;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < splits; ++s) {
        const float w = wts[rl * kMaxSplits + s];
        const float4 p = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, s) + r * G::PART_STRIDE + c);
        acc.x += w * p.x;
        acc.y += w * p.y;
        acc.z += w * p.z;
        acc.w += w * p.w;
      }
      const float f = inv[rl];
      *reinterpret_cast<float4*>(oh + (size_t)r * DH + c) =
          make_float4(acc.x * f, acc.y * f, acc.z * f, acc.w * f);
    }
    cluster.sync();  // no CTA leaves while its partial may still be read
  }
}

// Tensor map over (DH, rows, BH) bf16 with boxes of (one chunk, box_rows, 1).
template <int DH>
bool make_map(CUtensorMap* map, const void* base, int rows, int BH,
              int box_rows) {
  using G = Geo<DH, 64>;  // the chunk width and swizzle, whatever the tile
  return make_map_bf16(map, base, DH, rows, BH, G::CC, box_rows,
                       G::TMA_SWIZZLE);
}

template <int DH, int KT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int BH, int H, int Nq, int Nk,
                   float scale, int splits, cudaStream_t stream) {
  using G = Geo<DH, KT>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        attention_kernel<DH, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map<DH>(&tm_q, q, Nq, BH, kQTile) ||
      !make_map<DH>(&tm_k, k, Nk, BH, KT) ||
      !make_map<DH>(&tm_v, v, Nk, BH, KT))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (Nq + kQTile - 1) / kQTile, BH);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = G::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, attention_kernel<DH, KT>, tm_q, tm_k, tm_v,
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), H, Nq, Nk,
      scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int KT>
cudaError_t launch_dh(const void* q, const void* k, const void* v,
                      const void* mask, void* out, int BH, int H, int Nq,
                      int Nk, int dh, float scale, int splits,
                      cudaStream_t s) {
  switch (dh) {
    case 32: return launch<32, KT>(q, k, v, mask, out, BH, H, Nq, Nk, scale, splits, s);
    case 64: return launch<64, KT>(q, k, v, mask, out, BH, H, Nq, Nk, scale, splits, s);
    case 128: return launch<128, KT>(q, k, v, mask, out, BH, H, Nq, Nk, scale, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// key_tile (64 or 96) and splits (1, 2, 4 or 8, at most one per key tile)
// come from ops/attention.split_plan.
extern "C" int gl_attention_fwd(const void* q, const void* k, const void* v,
                                const void* mask, void* out, int BH, int H,
                                int Nq, int Nk, int dh, float scale,
                                int key_tile, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || Nq <= 0 || Nk <= 0 || H <= 0 || BH % H != 0 ||
      (key_tile != 64 && key_tile != 96) ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      splits > (Nk + key_tile - 1) / key_tile)
    return (int)cudaErrorInvalidValue;
  if (key_tile == 64)
    return (int)launch_dh<64>(q, k, v, mask, out, BH, H, Nq, Nk, dh, scale, splits, s);
  return (int)launch_dh<96>(q, k, v, mask, out, BH, H, Nq, Nk, dh, scale, splits, s);
}
