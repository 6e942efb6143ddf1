// Native frame loader: libpng grayscale decode + threaded prefetch ring.
//
// The port's copy of the JAX package's loader: a pool of decoder threads
// keeps a bounded ring of decoded float32 frames ahead of the tracker, so
// image decode runs off the hot loop, and frames come out in path order.
//
// Admission: a decoded frame waits for room in the ring (`depth` frames
// ready or parked, plus one per worker) -- except the in-order frame
// `next_emit`, which is always admitted. Without that exception the ring
// can fill with later, out-of-order frames while the worker holding
// `next_emit` waits for room; the consumer then waits for `next_emit`,
// which can never be parked, and nothing moves again.
//
// C ABI (ctypes-friendly), no C++ types across the boundary. Link with
// -lpng -lz.

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// Decode an 8/16-bit PNG to float32 grayscale [0,1] into out (h*w), with
// top-left crop/zero-pad to the requested (h, w).
bool decode_png_gray(const char* path, float* out, int out_h, int out_w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  // Normalize everything to 8-bit gray.
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (depth == 16) png_set_strip_16(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_PALETTE ||
      color == PNG_COLOR_TYPE_RGB_ALPHA)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  std::vector<uint8_t> row(png_get_rowbytes(png, info));
  const float inv = 1.0f / 255.0f;
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    if ((int)y >= out_h) continue;
    float* dst = out + (size_t)y * out_w;
    png_uint_32 copy_w = w < (png_uint_32)out_w ? w : (png_uint_32)out_w;
    for (png_uint_32 x = 0; x < copy_w; ++x) dst[x] = row[x] * inv;
    for (int x = copy_w; x < out_w; ++x) dst[x] = 0.0f;
  }
  for (int y = h; y < out_h; ++y)
    std::memset(out + (size_t)y * out_w, 0, sizeof(float) * out_w);

  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return true;
}

struct Slot {
  std::vector<float> data;
  long index = -1;
  bool ok = false;
};

struct Loader {
  std::vector<std::string> paths;
  int h = 0, w = 0;
  size_t next_decode = 0;           // next path index to hand to a worker
  std::queue<Slot> ready;           // decoded frames in order? (see note)
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  size_t depth = 4;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  // In-order delivery: frames must come out in path order, so workers park
  // out-of-order results here until their turn.
  std::vector<Slot> parked;
  size_t next_emit = 0;

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (stop || next_decode >= paths.size()) return;
        idx = next_decode++;
      }
      Slot s;
      s.data.resize((size_t)h * w);
      s.index = (long)idx;
      s.ok = decode_png_gray(paths[idx].c_str(), s.data.data(), h, w);
      {
        std::unique_lock<std::mutex> lk(mu);
        // The in-order frame always passes: it is the one the consumer
        // waits for, and it drains the parked frames behind it.
        cv_space.wait(lk, [&] {
          return stop || (size_t)s.index == next_emit ||
                 ready.size() + parked.size() < depth + workers.size();
        });
        if (stop) return;
        parked.push_back(std::move(s));
        // Drain any parked frames that are now in order.
        bool moved = true;
        while (moved) {
          moved = false;
          for (size_t i = 0; i < parked.size(); ++i) {
            if ((size_t)parked[i].index == next_emit) {
              ready.push(std::move(parked[i]));
              parked.erase(parked.begin() + i);
              ++next_emit;
              moved = true;
              break;
            }
          }
        }
        cv_ready.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

int glslam_decode_png(const char* path, float* out, int h, int w) {
  return decode_png_gray(path, out, h, w) ? 0 : -1;
}

void* glslam_loader_create(const char** paths, long n, int h, int w,
                           int depth, int num_threads) {
  Loader* L = new Loader();
  L->paths.assign(paths, paths + n);
  L->h = h;
  L->w = w;
  L->depth = depth > 0 ? (size_t)depth : 4;
  int nt = num_threads > 0 ? num_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Blocks until the next in-order frame is decoded; copies it into out.
// Returns the frame index, or -1 when the sequence is exhausted, -2 on a
// decode failure for that frame.
long glslam_loader_next(void* handle, float* out) {
  Loader* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_ready.wait(lk, [&] {
    return !L->ready.empty() || (L->next_emit >= L->paths.size());
  });
  if (L->ready.empty()) return -1;
  Slot s = std::move(L->ready.front());
  L->ready.pop();
  L->cv_space.notify_all();
  if (!s.ok) return -2;
  std::memcpy(out, s.data.data(), sizeof(float) * (size_t)L->h * L->w);
  return s.index;
}

void glslam_loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->stop = true;
    L->cv_space.notify_all();
    L->cv_ready.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
