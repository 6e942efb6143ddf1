// Keypoint non-maximum suppression of a detector heatmap (Hopper).
//
// Replaces the Pallas kernel gl_slam_tpu/ops/nms.py:_nms_pallas (_nms_kernel,
// _window_max) and fuses the tie-break that the reference runs after it
// (_suppress_with_tiebreak), so one launch turns `heat` into the suppressed
// map. A pixel p survives iff
//   (a) heat[p] >= max of heat over its (2r+1)^2 window (it "is a maximum"),
//   (b) no other maximum q of that window has a smaller linear index
//       y * W + x than p: none in the r rows above (any column of the
//       window) and none to its left in its own row.
// Pixels outside the image count as -inf (never a maximum), as in the plain
// PyTorch version; the Pallas kernel pads with 0.0, which gives the same
// result on the non-negative heatmaps the detector produces. max is exact,
// so the output equals the plain version's bit for bit. NaN is not handled.
//
// What bounds it: bytes. One read and one write of the map (30 MB at
// 8 x 376 x 1248, ~9 us at 3.35 TB/s) against ~35 register operations per
// pixel. The design streams rows through registers:
//   * Each warp owns a strip of 128 columns (4 adjacent columns per lane,
//     one 16-byte load per lane and row where rows are 16-byte aligned)
//     and a segment of rows, and walks down it. The strip's outer
//     H4 = roundup(2r, 4) columns on each side are halo: the warp writes
//     the middle 128 - 2 H4.
//   * The radius is a template parameter: every loop below is unrolled and
//     no index is divided by a runtime width.
//   * Vertical window max: S[i] = max of the last 2r+1-i rows, updated with
//     2r fmaxf per new row; S[0] is the window max of the row r behind the
//     newest. A ring of r+1 raw rows keeps that centre row.
//   * Horizontal window max: the 2r neighbouring columns come from the
//     neighbouring lanes by shuffles; suffix/prefix maxima share work
//     between the lane's 4 columns.
//   * Tie-break on bit masks: each lane's 4 is-maximum flags form a nibble;
//     the neighbouring lanes' nibbles (shuffled) give a word w from which
//     shifts and ORs (by doubling: log2 r steps) read "a maximum earlier in
//     this row within r" and the row's flags dilated by +-r. A ring of the
//     last r dilated nibbles (4 bits a row, in one integer) answers "a
//     maximum in the r rows above within +-r columns". Output row y is
//     decided as soon as heat row y + r has arrived.
//   * Loads run 4-8 rows ahead of the row being processed (a register
//     queue), so bytes stay in flight while the warp computes; loads are
//     clamped into the image and their values masked, and stores are
//     predicated, so the unrolled rows have no branch and overlap.
//   * Rows are split into segments, each re-reading 3r rows (flags need
//     heat r rows below, the tie test needs flags r rows above). The
//     segment length minimises a cost model of waves of CTAs and warps per
//     SM (plan_cost), fitted on the card.
//
// Layout: heat, out (B, H, W) f32 contiguous. 1-D grid of 4-warp CTAs over
// (image, row segment, column strip), strip fastest.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int kMaxRadius = 16;
constexpr int kWarpsPerCta = 4;
constexpr int kThreads = 32 * kWarpsPerCta;
constexpr int kStripCols = 128;      // 32 lanes x 4 columns
constexpr unsigned kFull = 0xffffffffu;

template <int R>
struct Geo {
  static constexpr int kHalo = (2 * R + 3) / 4 * 4;   // H4
  static constexpr int kOut = kStripCols - 2 * kHalo;   // columns written
  static constexpr int kNb = (R + 3) / 4;               // lanes each side
  // Rows loaded ahead: a multiple of the raw ring's R + 1 rows (so that the
  // unrolled loop renames the ring instead of moving it), at least 4.
  static constexpr int kPrefetch =
      R + 1 <= 8 ? (4 + R) / (R + 1) * (R + 1) : 4;
  // Bit words: nibbles of 2 kNb + 1 lanes; r nibbles of dilated rows.
  using Word = typename std::conditional<(4 * (2 * kNb + 1) <= 32), uint32_t,
                                         uint64_t>::type;
  using Hist = typename std::conditional<(4 * R <= 32), uint32_t,
                                         uint64_t>::type;
};

int out_cols(int r) { return kStripCols - 2 * ((2 * r + 3) / 4 * 4); }

struct Plan {
  int n_strips, seg_rows, n_seg;
  long long warps, ctas;
};

// The cost model of a plan, in units of one warp-row on an SM that is
// running 4 warps: CTAs go to the SMs in waves of `resident` CTAs each; an
// SM running w warps takes ~max(w, 7) / 4 units a row (it issues for its
// warps in turn; at few warps each row's dependency chain sets the time).
// Fitted to the segment-length sweeps of scripts/bench_nms_torch.py at
// r = 4 (8 and 2 maps of 376 x 1248) on an H100 SXM.
double plan_cost(long long ctas, int rows, int sms, int resident) {
  long long per_sm = (ctas + sms - 1) / sms;
  double cost = 0.0;
  while (per_sm > 0) {
    const long long w = per_sm < resident ? per_sm : resident;
    const double warps = (double)(w * kWarpsPerCta);
    cost += rows * (warps > 7.0 ? warps : 7.0);
    per_sm -= w;
  }
  return cost;
}

Plan plan_for(int B, int H, int seg_rows, int n_strips) {
  Plan p;
  p.n_strips = n_strips;
  p.seg_rows = seg_rows > H ? H : seg_rows;
  p.n_seg = (H + p.seg_rows - 1) / p.seg_rows;
  p.warps = (long long)B * p.n_seg * n_strips;
  p.ctas = (p.warps + kWarpsPerCta - 1) / kWarpsPerCta;
  return p;
}

// seg_rows <= 0: the segment length of least modelled cost, no shorter
// than 3r rows or 12 (each segment re-reads 3r rows).
Plan make_plan(int B, int H, int W, int r, int seg_rows, int sms,
               int resident) {
  const int n_strips = (W + out_cols(r) - 1) / out_cols(r);
  if (seg_rows > 0) return plan_for(B, H, seg_rows, n_strips);
  const int least = 3 * r > 12 ? 3 * r : 12;
  Plan best = plan_for(B, H, H, n_strips);
  double best_cost = plan_cost(best.ctas, H + 3 * r, sms, resident);
  for (int n = 2; (H + n - 1) / n >= least; ++n) {
    const int seg = (H + n - 1) / n;
    const Plan p = plan_for(B, H, seg, n_strips);
    const double c = plan_cost(p.ctas, seg + 3 * r, sms, resident);
    if (c < best_cost) {
      best = p;
      best_cost = c;
    }
  }
  return best;
}

// Bit b of the result: OR of bits b, b + U, ..., b + (N - 1) U of w.
template <int N, int U, typename T>
__device__ __forceinline__ T or_run(T w) {
  if constexpr (N <= 0) {
    return 0;
  } else {
    constexpr int P = N >= 32 ? 32 : N >= 16 ? 16 : N >= 8 ? 8 : N >= 4 ? 4
                    : N >= 2 ? 2 : 1;                   // P <= N < 2P
    T a = w;
#pragma unroll
    for (int s = 1; s < P; s <<= 1) a |= a >> (s * U);   // covers P units
    if constexpr (P == N) return a;
    else return a | (a >> ((N - P) * U));
  }
}

// v of the lane D lanes away. Lanes at the warp's edges get their own
// value from shfl_up/down: those columns are halo, and nothing the warp
// writes depends on them.
template <int D, typename T>
__device__ __forceinline__ T shfl_lane(T v) {
  if constexpr (D == 0) return v;
  else if constexpr (D < 0) return __shfl_up_sync(kFull, v, -D);
  else return __shfl_down_sync(kFull, v, D);
}

// Column O of the strip relative to the lane's first (O may be negative).
template <int O>
__device__ __forceinline__ float ext_at(const float (&v)[4]) {
  constexpr int e = ((O % 4) + 4) % 4;
  return shfl_lane<(O - e) / 4>(v[e]);
}

template <int R, int... Os>
__device__ __forceinline__ void gather_ext(const float (&v)[4],
                                           float (&ext)[4 + 2 * R],
                                           std::integer_sequence<int, Os...>) {
  ((ext[Os] = ext_at<Os - R>(v)), ...);
}

template <int R, int... Is>
__device__ __forceinline__ typename Geo<R>::Word gather_word(
    uint32_t f, std::integer_sequence<int, Is...>) {
  using Word = typename Geo<R>::Word;
  constexpr int nb = Geo<R>::kNb;
  Word w = (Word)f << (4 * nb);
  ((w |= (Word)shfl_lane<-(Is + 1)>(f) << (4 * (nb - Is - 1)) |
         (Word)shfl_lane<Is + 1>(f) << (4 * (nb + Is + 1))), ...);
  return w;
}

template <int R, bool VEC>
__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ heat, float* __restrict__ out, int H,
           int W, int n_strips, int seg_rows, int n_seg, int warps) {
  using G = Geo<R>;
  using Word = typename G::Word;
  using Hist = typename G::Hist;
  constexpr int PF = G::kPrefetch;
  const int warp = blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (warp >= warps) return;                   // whole warps only
  const int lane = threadIdx.x & 31;
  const int strip = warp % n_strips;
  const int rest = warp / n_strips;
  const int seg = rest % n_seg;
  const int b = rest / n_seg;

  const int x = strip * G::kOut - G::kHalo + 4 * lane;   // first column
  const int y0 = seg * seg_rows;
  const int y1 = min(y0 + seg_rows, H);
  const int t_begin = y0 - 2 * R, t_end = y1 + R;
  const int row_hi = min(H, t_end) - 1;        // last row worth loading
  const size_t img = (size_t)b * H * W;
  const float* src = heat + img;
  float* dst = out + img;

  uint32_t col_mask = 0;                       // the lane's columns inside
  int xc[4];                                   // load columns, clamped
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    col_mask |= (x + j >= 0 && x + j < W) ? 1u << j : 0u;
    xc[j] = min(max(x + j, 0), W - 1);
  }
  const bool out_lane = 4 * lane >= G::kHalo &&
                        4 * lane < G::kHalo + G::kOut;

  // Row t of the lane's columns; rows and columns outside the image read
  // as -inf. Every load is in bounds (clamped), so the body has no branch.
  auto load = [&](int t, float (&v)[4]) {
    const int off = min(max(t, 0), row_hi) * W;
    const bool row_in = (unsigned)t < (unsigned)H;
    if constexpr (VEC) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(
          src + off + min(max(x, 0), W - 4)));
      const bool in = row_in && (col_mask & 1u);
      v[0] = in ? f.x : -CUDART_INF_F;
      v[1] = in ? f.y : -CUDART_INF_F;
      v[2] = in ? f.z : -CUDART_INF_F;
      v[3] = in ? f.w : -CUDART_INF_F;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float f = __ldg(src + off + xc[j]);
        v[j] = row_in && (col_mask >> j & 1u) ? f : -CUDART_INF_F;
      }
    }
  };

  // S[i][j]: max over the last 2R+1-i rows; raw[i][j]: row t-R+i.
  float S[2 * R + 1][4], raw[R + 1][4];
#pragma unroll
  for (int i = 0; i <= 2 * R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) S[i][j] = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i <= R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) raw[i][j] = -CUDART_INF_F;
  Hist hist = 0;   // dilated flags of the last R rows, newest in bits 0-3

  auto step = [&](int t, const float (&in)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < 2 * R; ++i) S[i][j] = fmaxf(S[i + 1][j], in[j]);
      S[2 * R][j] = in[j];
#pragma unroll
      for (int i = 0; i < R; ++i) raw[i][j] = raw[i + 1][j];
      raw[R][j] = in[j];
    }
    // The row decided now. While the window fills (t < y0) its flags are
    // wrong, but they leave `hist` before output row y0 reads it, and
    // those rows are not written: the body has no branch, so the rows of
    // the unrolled loop below can overlap.
    const int y = t - R;

    // Vertical maxima of the strip's columns -R .. 3+R around the lane's.
    float ext[4 + 2 * R];                        // ext[o + R], o in [-R, 3+R]
    gather_ext<R>(S[0], ext, std::make_integer_sequence<int, 4 + 2 * R>());
    float hm[4];
    if constexpr (R <= 2) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float m = ext[j];
#pragma unroll
        for (int d = 1; d <= 2 * R; ++d) m = fmaxf(m, ext[j + d]);
        hm[j] = m;
      }
    } else {
      // window [j-R, j+R] = [j-R, -1] u [0, j+R] for R >= 3;
      // sl[m + R]: max of ext over [m, -1] (sl[R]: empty, -inf);
      // pr[m]: max of ext over [0, m].
      float sl[R + 1], pr[4 + R];
      sl[R] = -CUDART_INF_F;
#pragma unroll
      for (int m = -1; m >= -R; --m)
        sl[m + R] = m == -1 ? ext[R - 1] : fmaxf(ext[m + R], sl[m + R + 1]);
      pr[0] = ext[R];
#pragma unroll
      for (int m = 1; m < 4 + R; ++m) pr[m] = fmaxf(pr[m - 1], ext[m + R]);
#pragma unroll
      for (int j = 0; j < 4; ++j) hm[j] = fmaxf(sl[j], pr[j + R]);
    }

    uint32_t f = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) f |= raw[0][j] >= hm[j] ? 1u << j : 0u;
    f &= (unsigned)y < (unsigned)H ? col_mask : 0u;

    // w: nibbles of lanes -kNb .. +kNb; bit b is column x - 4 kNb + b.
    const Word w =
        gather_word<R>(f, std::make_integer_sequence<int, G::kNb>());
    // Flags dilated by +-R, and "a flag within R to the left".
    const uint32_t dil = (uint32_t)(or_run<2 * R + 1, 1>(w) >>
                                    (4 * G::kNb - R));
    const uint32_t left = (uint32_t)(or_run<R, 1>(w) >> (4 * G::kNb - R));
    const uint32_t above = (uint32_t)or_run<R, 4>(hist);
    const uint32_t keep = f & ~(left | above);
    if constexpr (R > 0) {
      hist = (Hist)((hist << 4) | (Hist)(dil & 0xfu));
      if constexpr (4 * R < 8 * (int)sizeof(Hist))
        hist &= (Hist)(((Hist)1 << (4 * R)) - 1);
    }

    const bool write = out_lane && y >= y0 && y < y1;
    float o4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o4[j] = (keep >> j) & 1u ? raw[0][j] : 0.f;
    float* p = dst + (size_t)y * W + x;
    if constexpr (VEC) {
      if (write && (col_mask & 1u))
        *reinterpret_cast<float4*>(p) = make_float4(o4[0], o4[1], o4[2],
                                                    o4[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (write && (col_mask >> j & 1u)) p[j] = o4[j];
    }
  };

  // Whole groups of PF rows; rows past t_end are not written.
  float q[PF][4];
#pragma unroll
  for (int p = 0; p < PF; ++p) load(t_begin + p, q[p]);
  for (int t = t_begin; t < t_end; t += PF) {
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      float v[4] = {q[p][0], q[p][1], q[p][2], q[p][3]};
      load(t + p + PF, q[p]);
      step(t + p, v);
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    return 132;
  return n;
}

template <int R>
struct Kernel {
  // CTAs of the kernel an SM holds at once (registers decide).
  static int resident() {
    static const int n = [] {
      int a = 0, b = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, nms_kernel<R, true>,
                                                    kThreads, 0);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, nms_kernel<R, false>,
                                                    kThreads, 0);
      const int m = a < b ? a : b;
      return m > 0 ? m : 1;
    }();
    return n;
  }

  static Plan plan(int B, int H, int W, int seg_rows) {
    return make_plan(B, H, W, R, seg_rows, sm_count(), resident());
  }

  static int launch(const float* heat, float* out, int B, int H, int W,
                    int seg_rows, cudaStream_t stream) {
    const Plan p = plan(B, H, W, seg_rows);
    // row offsets within one image are int
    if (p.ctas > 0x7fffffffLL || (long long)H * W > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    // 16-byte loads and stores where every row starts on a 16-byte boundary
    const bool vec = W % 4 == 0 &&
                     ((uintptr_t)heat | (uintptr_t)out) % 16 == 0;
    if (vec)
      nms_kernel<R, true><<<(unsigned)p.ctas, kThreads, 0, stream>>>(
          heat, out, H, W, p.n_strips, p.seg_rows, p.n_seg, (int)p.warps);
    else
      nms_kernel<R, false><<<(unsigned)p.ctas, kThreads, 0, stream>>>(
          heat, out, H, W, p.n_strips, p.seg_rows, p.n_seg, (int)p.warps);
    return (int)cudaGetLastError();
  }
};

struct Entry {
  Plan (*plan)(int, int, int, int);
  int (*launch)(const float*, float*, int, int, int, int, cudaStream_t);
};

template <int... Rs>
const Entry& entry(int r, std::integer_sequence<int, Rs...>) {
  static const Entry table[] = {{Kernel<Rs>::plan, Kernel<Rs>::launch}...};
  return table[r];
}

const Entry& entry(int r) {
  return entry(r, std::make_integer_sequence<int, kMaxRadius + 1>());
}

}  // namespace

// The plan: strips, row segments and CTAs for a map and radius; seg_rows
// <= 0 asks for the default. Writes {n_strips, columns written per strip,
// seg_rows, n_seg, ctas}.
extern "C" int gl_nms_plan(int B, int H, int W, int radius, int seg_rows,
                           int* plan) {
  if (radius < 0 || radius > kMaxRadius || B <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = entry(radius).plan(B, H, W, seg_rows);
  plan[0] = p.n_strips;
  plan[1] = out_cols(radius);
  plan[2] = p.seg_rows;
  plan[3] = p.n_seg;
  plan[4] = (int)p.ctas;
  return 0;
}

// As gl_nms_fwd, with the row segment length given (<= 0: the default).
extern "C" int gl_nms_fwd_seg(const void* heat, void* out, int B, int H,
                              int W, int radius, int seg_rows, void* stream) {
  if (radius < 0 || radius > kMaxRadius || B <= 0 || B > 65535 || H <= 0 ||
      W <= 0)
    return (int)cudaErrorInvalidValue;
  return entry(radius).launch(static_cast<const float*>(heat),
                              static_cast<float*>(out), B, H, W, seg_rows,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int gl_nms_fwd(const void* heat, void* out, int B, int H, int W,
                          int radius, void* stream) {
  return gl_nms_fwd_seg(heat, out, B, H, W, radius, 0, stream);
}
