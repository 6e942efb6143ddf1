// Fused masked multi-head attention for the LightGlue matcher (Hopper).
//
// Replaces the Pallas kernel gl_slam_tpu/ops/attention.py:attention_pallas
// (_attn_kernel). That kernel keeps one head's whole K and V resident in
// VMEM and computes one (query tile x all keys) logits tile at once. On the
// H100 a block has at most 227 KB of shared memory, and one head's K and V at
// Nk = 2048, dh = 128 in bf16 take 512 KB each, so this is a flash-style
// kernel instead: K/V are streamed through shared memory in 64-key tiles and
// the softmax is computed online (running row max and sum in f32).
//
// What bounds it: the prologue calls (8 pairs x 2 sets x 2 heads, Nq = Nk =
// 2048, dh = 128) do ~69 GFLOP against ~25 MB of traffic, i.e. they are
// bound by tensor-core operations (>= 70 us at 989 TFLOP/s bf16). The
// re-observation calls (1 set x 2 heads, 1024/2048 queries) are ~1 GFLOP
// each and sit near launch latency. The design therefore feeds the tensor
// cores: q.k^T and p.v run as bf16 mma.sync.m16n8k16 with f32 accumulation,
// the logits never leave registers, and P is converted from the accumulator
// layout straight into the A-operand layout of the second product. wgmma,
// TMA and warp specialisation are later work.
//
// Numerics follow the reference: logits = (q.k) * scale in f32, masked keys
// are -1e9 (not -inf, so a row whose keys are all masked averages v), the
// softmax sum is clamped at >= 1e-20, p is rounded to bf16 before the product
// with v, the output is f32. Keys past Nk (ragged last tile) are excluded
// with -inf and zero-filled K/V rows.
//
// Layouts: q (BH, Nq, DH), k/v (BH, Nk, DH) bf16 contiguous; mask (B, Nk)
// uint8 with B = BH / H; out (BH, Nq, DH) f32. One block per (64-query tile,
// batch*head); 4 warps, 16 query rows each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerWarp = 16;
constexpr int kWarps = 4;
constexpr int kQTile = kRowsPerWarp * kWarps;  // 64 queries per block
constexpr int kKTile = 64;                     // keys per shared-memory tile
constexpr float kMasked = -1e9f;

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int H, int Nq, int Nk, float scale) {
  // Row strides padded by 8 bf16 so the fragment reads below hit 32
  // distinct banks (row stride in 32-bit words = 4 mod 32).
  constexpr int KS = DH + 8;      // K tile: [key][d]
  constexpr int VS = kKTile + 8;  // V tile, transposed: [d][key]
  __shared__ __align__(16) __nv_bfloat16 k_s[kKTile * KS];
  __shared__ __align__(16) __nv_bfloat16 vt_s[DH * VS];
  __shared__ int8_t key_state[kKTile];  // 1 valid, 0 masked, -1 past Nk

  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const int row0 = blockIdx.x * kQTile + warp * kRowsPerWarp;
  const __nv_bfloat16* qh = q + (size_t)bh * Nq * DH;
  const __nv_bfloat16* kh = k + (size_t)bh * Nk * DH;
  const __nv_bfloat16* vh = v + (size_t)bh * Nk * DH;
  const uint8_t* mrow = mask + (size_t)(bh / H) * Nk;

  // Q fragments (A operand, rows row0+g and row0+g+8), kept in registers.
  uint32_t qa[DH / 16][4];
  {
    const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int c = kk * 16 + t * 2;
      qa[kk][0] = ra < Nq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)ra * DH + c) : 0u;
      qa[kk][1] = rb < Nq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)rb * DH + c) : 0u;
      qa[kk][2] = ra < Nq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)ra * DH + c + 8) : 0u;
      qa[kk][3] = rb < Nq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)rb * DH + c + 8) : 0u;
    }
  }

  float o[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g+8
  float l_run[2] = {0.f, 0.f};              // this thread's share of the sum

  for (int j0 = 0; j0 < Nk; j0 += kKTile) {
    __syncthreads();  // previous tile fully consumed
    // Cooperative load: 16-byte vectors, K as is, V transposed.
    constexpr int kVecPerRow = DH / 8;
    for (int idx = threadIdx.x; idx < kKTile * kVecPerRow; idx += kWarps * 32) {
      const int r = idx / kVecPerRow;
      const int c = (idx % kVecPerRow) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (j0 + r < Nk) {
        kv = *reinterpret_cast<const uint4*>(kh + (size_t)(j0 + r) * DH + c);
        vv = *reinterpret_cast<const uint4*>(vh + (size_t)(j0 + r) * DH + c);
      }
      *reinterpret_cast<uint4*>(&k_s[r * KS + c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[(c + e) * VS + r] = ve[e];
    }
    for (int r = threadIdx.x; r < kKTile; r += kWarps * 32)
      key_state[r] = (j0 + r < Nk) ? (mrow[j0 + r] ? 1 : 0) : -1;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float s[kKTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKTile / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = &k_s[(nt * 8 + g) * KS + t * 2];
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        b[1] = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16_16816(s[nt], qa[kk], b);
      }
    }

    // Scale, mask, tile row max.
    float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kKTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int st = key_state[nt * 8 + t * 2 + (e & 1)];
        float x = s[nt][e] * scale;
        x = st > 0 ? x : (st == 0 ? kMasked : -INFINITY);
        s[nt][e] = x;
        m_tile[e >> 1] = fmaxf(m_tile[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_tile[h] = fmaxf(m_tile[h], __shfl_xor_sync(0xffffffffu, m_tile[h], 1));
      m_tile[h] = fmaxf(m_tile[h], __shfl_xor_sync(0xffffffffu, m_tile[h], 2));
      const float m_new = fmaxf(m_run[h], m_tile[h]);  // finite: >= -1e9
      corr[h] = __expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= corr[h];
    }
#pragma unroll
    for (int nt = 0; nt < kKTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m_run[e >> 1]);
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P V: the accumulator layout of two adjacent n-tiles is the A
    // layout of one k16 step.
#pragma unroll
    for (int ks = 0; ks < kKTile / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        const __nv_bfloat16* vrow = &vt_s[(dt * 8 + g) * VS + ks * 16 + t * 2];
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(vrow);
        b[1] = *reinterpret_cast<const uint32_t*>(vrow + 8);
        mma_bf16_16816(o[dt], pa, b);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = 1.f / fmaxf(l, 1e-20f);
  }
  float* oh = out + (size_t)bh * Nq * DH;
  const int ra = row0 + g, rb = row0 + g + 8;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    const int c = dt * 8 + t * 2;
    if (ra < Nq)
      *reinterpret_cast<float2*>(oh + (size_t)ra * DH + c) =
          make_float2(o[dt][0] * inv[0], o[dt][1] * inv[0]);
    if (rb < Nq)
      *reinterpret_cast<float2*>(oh + (size_t)rb * DH + c) =
          make_float2(o[dt][2] * inv[1], o[dt][3] * inv[1]);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, void* out, int BH, int H, int Nq, int Nk,
                   float scale, cudaStream_t stream) {
  dim3 grid((Nq + kQTile - 1) / kQTile, BH);
  attention_kernel<DH><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), H, Nq, Nk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gl_attention_fwd(const void* q, const void* k, const void* v,
                                const void* mask, void* out, int BH, int H,
                                int Nq, int Nk, int dh, float scale,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return (int)launch<32>(q, k, v, mask, out, BH, H, Nq, Nk, scale, s);
    case 64: return (int)launch<64>(q, k, v, mask, out, BH, H, Nq, Nk, scale, s);
    case 128: return (int)launch<128>(q, k, v, mask, out, BH, H, Nq, Nk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
