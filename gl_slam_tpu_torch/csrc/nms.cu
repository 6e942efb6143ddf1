// Keypoint non-maximum suppression of a detector heatmap (Hopper).
//
// Replaces the Pallas kernel gl_slam_tpu/ops/nms.py:_nms_pallas (_nms_kernel,
// _window_max) and fuses the tie-break that the reference runs after it
// (_suppress_with_tiebreak). That kernel holds one whole image in VMEM
// (376 x 1248 f32 = 1.9 MB) and takes the separable (2r+1)^2 window max with
// shifted maxima; its tie-break stayed outside only because a second int32
// pass overflowed VMEM. On the H100 a block has at most 227 KB of shared
// memory, so the image is tiled instead: each block owns a 32 x 64 tile of
// output pixels, loads it with a halo of 2r into shared memory and does
// everything there, so one launch turns `heat` into the suppressed map.
//
// A pixel p survives iff
//   (a) heat[p] >= max of heat over its (2r+1)^2 window (it "is a maximum"),
//   (b) no other maximum q of that window has a smaller linear index
//       y * W + x than p, i.e. none in the r rows above (any column of the
//       window) and none to its left in its own row.
// (b) needs (a) at every pixel within r of the tile, and (a) there needs
// heat within 2r of the tile: hence the halo of 2r for heat and of r for the
// is-maximum flags. Both steps are separable: a row pass then a column pass.
//
// Pixels outside the image count as -inf (never a maximum), as in the plain
// PyTorch version; the Pallas kernel pads with 0.0, which gives the same
// result on the non-negative heatmaps the detector produces. max is exact,
// so the output equals the plain version's bit for bit. NaN is not handled.
//
// What bounds it: bytes. One read and one write of the map (30 MB at
// 8 x 376 x 1248, ~9 us at 3.35 TB/s) against ~40 shared-memory reads and
// compares per pixel. The halo makes a block read (32+4r)(64+4r) pixels for
// 32 x 64 outputs (1.9x at r = 4); neighbouring blocks find them in L2.
//
// Layout: heat, out (B, H, W) f32 contiguous. Grid (ceil(W/64), ceil(H/32),
// B), 256 threads.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kThreads = 256;
constexpr int kMaxRadius = 16;

// Shared-memory layout for radius r (all sizes in elements):
//   s_heat (kTileH + 4r) x (kTileW + 4r) f32   heat, halo 2r
//   s_row  (kTileH + 4r) x (kTileW + 2r) f32   row-window max, halo (2r, r)
//   s_flag (kTileH + 2r) x (kTileW + 2r) u8    is-maximum, halo r
//   s_any  (kTileH + 2r) x  kTileW       u8    any flag in the row window
size_t smem_bytes(int r) {
  const size_t hh = kTileH + 4 * r, hw = kTileW + 4 * r;
  const size_t rw = kTileW + 2 * r, fh = kTileH + 2 * r;
  return 4 * (hh * hw + hh * rw) + fh * rw + fh * kTileW;
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ heat, float* __restrict__ out, int H,
           int W, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hh = kTileH + 4 * r, hw = kTileW + 4 * r;
  const int rw = kTileW + 2 * r, fh = kTileH + 2 * r;
  float* s_heat = reinterpret_cast<float*>(smem);
  float* s_row = s_heat + hh * hw;
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_row + hh * rw);
  uint8_t* s_any = s_flag + fh * rw;

  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const size_t img = (size_t)blockIdx.z * H * W;
  const float* src = heat + img;

  // 1. heat with a halo of 2r; s_heat(rr, cc) is pixel (y0-2r+rr, x0-2r+cc).
  for (int i = threadIdx.x; i < hh * hw; i += kThreads) {
    const int rr = i / hw, cc = i - rr * hw;
    const int y = y0 - 2 * r + rr, x = x0 - 2 * r + cc;
    s_heat[i] = (y >= 0 && y < H && x >= 0 && x < W)
                    ? src[(size_t)y * W + x] : -CUDART_INF_F;
  }
  __syncthreads();

  // 2. row pass: s_row(rr, c) = max of heat over columns x-r..x+r at pixel
  //    (y0-2r+rr, x = x0-r+c).
  for (int i = threadIdx.x; i < hh * rw; i += kThreads) {
    const int rr = i / rw, c = i - rr * rw;
    const float* p = s_heat + rr * hw + c;
    float m = p[0];
    for (int d = 1; d <= 2 * r; ++d) m = fmaxf(m, p[d]);
    s_row[i] = m;
  }
  __syncthreads();

  // 3. column pass and the is-maximum flag at pixel (y0-r+fr, x0-r+c).
  for (int i = threadIdx.x; i < fh * rw; i += kThreads) {
    const int fr = i / rw, c = i - fr * rw;
    const int y = y0 - r + fr, x = x0 - r + c;
    const float* p = s_row + fr * rw + c;
    float m = p[0];
    for (int d = 1; d <= 2 * r; ++d) m = fmaxf(m, p[d * rw]);
    const bool inside = y >= 0 && y < H && x >= 0 && x < W;
    s_flag[i] = inside && s_heat[(fr + r) * hw + c + r] >= m;
  }
  __syncthreads();

  // 4. s_any(fr, j): a maximum in row y0-r+fr within columns x-r..x+r of
  //    x = x0+j.
  for (int i = threadIdx.x; i < fh * kTileW; i += kThreads) {
    const int fr = i / kTileW, j = i - fr * kTileW;
    const uint8_t* p = s_flag + fr * rw + j;
    uint8_t any = 0;
    for (int d = 0; d <= 2 * r; ++d) any |= p[d];
    s_any[i] = any;
  }
  __syncthreads();

  // 5. a maximum survives unless another one precedes it in its window.
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int ti = i / kTileW, j = i - ti * kTileW;
    const int y = y0 + ti, x = x0 + j;
    if (y >= H || x >= W) continue;
    const int fr = ti + r;
    const uint8_t* f = s_flag + fr * rw + j + r;
    uint8_t earlier = 0;
    for (int d = 1; d <= r; ++d) {
      earlier |= s_any[(fr - d) * kTileW + j];
      earlier |= f[-d];
    }
    const bool keep = f[0] && !earlier;
    out[img + (size_t)y * W + x] =
        keep ? s_heat[(fr + r) * hw + j + 2 * r] : 0.f;
  }
}

}  // namespace

extern "C" int gl_nms_fwd(const void* heat, void* out, int B, int H, int W,
                          int radius, void* stream) {
  if (radius < 0 || radius > kMaxRadius || B <= 0 || B > 65535 || H <= 0 ||
      W <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(radius);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  nms_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(heat), static_cast<float*>(out), H, W, radius);
  return (int)cudaGetLastError();
}
