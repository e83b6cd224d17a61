// Native clip loader: multithreaded JPEG decode + modality-stack assembly.
//
// The reference feeds training through torch DataLoader workers doing 180
// cv2.imread calls + 20 pad/cubic-resizes per 20-frame clip in Python
// (reference dataset/chalearn_dataset.py:103-118, train.py:157). This library is
// the TPU-native host-side replacement: a pthread worker pool that, per frame,
// decodes the 9 JPEG modality files (BGR, U, V, F0..F4, D), concatenates them
// into a 21-channel stack, pads to square and bicubic-resizes (OpenCV
// INTER_CUBIC kernel, A = -0.75, replicate-clamped) into the caller's uint8
// buffer. Missing files produce constant-127 frames, matching
// chalearn_dataset.py:115-116.
//
// C API (ctypes-friendly):
//   void* vcl_create(int num_threads);
//   void  vcl_destroy(void* h);
//   long  vcl_submit_clip(void* h, const char** paths, int t, int size,
//                         unsigned char* out);   // returns ticket
//   int   vcl_wait(void* h, long ticket);        // 0 = ok
//
// paths: t*9 strings, frame-major, order [rgb, U, V, F0, F1, F2, F3, F4, D];
// empty string = missing frame. out: t*size*size*21 bytes, channel-interleaved.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kNumFiles = 9;     // rgb + U + V + F0..F4 + D
constexpr int kChannels = 21;    // 3+1+1+5*3+1
constexpr uint8_t kMissingFill = 127;

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // interleaved
};

bool DecodeJpeg(const std::string& path, Image* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->c = cinfo.output_components;
  out->data.resize(size_t(out->h) * out->w * out->c);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * out->c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  // libjpeg yields RGB; the pipeline convention (cv2) is BGR.
  if (out->c == 3) {
    uint8_t* p = out->data.data();
    for (size_t i = 0; i < out->data.size(); i += 3) std::swap(p[i], p[i + 2]);
  }
  return true;
}

// OpenCV INTER_CUBIC kernel (A = -0.75).
inline float CubicWeight(float x) {
  constexpr float A = -0.75f;
  x = std::fabs(x);
  if (x <= 1.f) return ((A + 2.f) * x - (A + 3.f)) * x * x + 1.f;
  if (x < 2.f) return ((A * x - 5.f * A) * x + 8.f * A) * x - 4.f * A;
  return 0.f;
}

// Separable bicubic resize of an interleaved uint8 image (replicate border,
// src coords (dst+0.5)*scale-0.5 — cv2's mapping), float accumulate, saturate.
void ResizeCubic(const uint8_t* src, int sh, int sw, int c, uint8_t* dst, int dh,
                 int dw) {
  std::vector<float> tmp(size_t(dh) * sw * c);  // vertical pass first
  float sy = float(sh) / dh;
  std::vector<int> idx(4);
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = int(std::floor(fy));
    float t = fy - y0;
    float wts[4];
    for (int k = 0; k < 4; ++k) {
      wts[k] = CubicWeight(t - (k - 1));
      idx[k] = std::min(std::max(y0 + k - 1, 0), sh - 1);
    }
    float* out_row = tmp.data() + size_t(y) * sw * c;
    std::memset(out_row, 0, sizeof(float) * sw * c);
    for (int k = 0; k < 4; ++k) {
      const uint8_t* in_row = src + size_t(idx[k]) * sw * c;
      float wk = wts[k];
      for (int i = 0; i < sw * c; ++i) out_row[i] += wk * in_row[i];
    }
  }
  float sx = float(sw) / dw;
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    int x0 = int(std::floor(fx));
    float t = fx - x0;
    float wts[4];
    int ix[4];
    for (int k = 0; k < 4; ++k) {
      wts[k] = CubicWeight(t - (k - 1));
      ix[k] = std::min(std::max(x0 + k - 1, 0), sw - 1);
    }
    for (int y = 0; y < dh; ++y) {
      const float* in_row = tmp.data() + size_t(y) * sw * c;
      uint8_t* out_px = dst + (size_t(y) * dw + x) * c;
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.f;
        for (int k = 0; k < 4; ++k) acc += wts[k] * in_row[ix[k] * c + ch];
        out_px[ch] = uint8_t(std::min(std::max(acc + 0.5f, 0.f), 255.f));
      }
    }
  }
}

// Build one frame: decode 9 files, stack 21 channels, pad-to-square centered
// (chalearn_dataset.py:60-71), resize to size x size.
bool BuildFrame(const char* const* paths, int size, uint8_t* out) {
  Image imgs[kNumFiles];
  if (!paths[0] || !paths[0][0] || !DecodeJpeg(paths[0], &imgs[0])) {
    std::memset(out, kMissingFill, size_t(size) * size * kChannels);
    return true;
  }
  int h = imgs[0].h, w = imgs[0].w;
  for (int i = 1; i < kNumFiles; ++i) {
    if (!paths[i] || !paths[i][0] || !DecodeJpeg(paths[i], &imgs[i]) ||
        imgs[i].h != h || imgs[i].w != w) {
      std::memset(out, kMissingFill, size_t(size) * size * kChannels);
      return true;
    }
  }
  // Channel plan per file: rgb=3, U=1, V=1, F0..F4=3 each, D=1.
  const int plan[kNumFiles] = {3, 1, 1, 3, 3, 3, 3, 3, 1};
  int m = std::max(h, w);
  int ny = (m - h) / 2, nx = (m - w) / 2;
  std::vector<uint8_t> square(size_t(m) * m * kChannels, 0);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      uint8_t* dst = square.data() + ((size_t(y + ny) * m) + (x + nx)) * kChannels;
      int ch = 0;
      for (int i = 0; i < kNumFiles; ++i) {
        const Image& im = imgs[i];
        const uint8_t* px = im.data.data() + (size_t(y) * w + x) * im.c;
        for (int k = 0; k < plan[i]; ++k)
          dst[ch++] = px[im.c == 1 ? 0 : std::min(k, im.c - 1)];
      }
    }
  }
  ResizeCubic(square.data(), m, m, kChannels, out, size, size);
  return true;
}

struct Job {
  std::vector<std::string> paths;  // t*9
  int t = 0, size = 0;
  uint8_t* out = nullptr;
  long ticket = 0;
};

class Loader {
 public:
  explicit Loader(int num_threads) {
    for (int i = 0; i < std::max(num_threads, 1); ++i)
      workers_.emplace_back([this] { Work(); });
  }

  ~Loader() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  long Submit(Job job) {
    std::unique_lock<std::mutex> lk(mu_);
    job.ticket = next_ticket_++;
    long ticket = job.ticket;
    queue_.push_back(std::move(job));
    cv_.notify_one();
    return ticket;
  }

  int Wait(long ticket) {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [&] { return done_.count(ticket) > 0; });
    int status = done_[ticket];
    done_.erase(ticket);
    return status;
  }

 private:
  void Work() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [&] { return stop_ || !queue_.empty(); });
        if (stop_ && queue_.empty()) return;
        job = std::move(queue_.front());
        queue_.pop_front();
      }
      int status = 0;
      size_t frame_bytes = size_t(job.size) * job.size * kChannels;
      for (int f = 0; f < job.t; ++f) {
        const char* frame_paths[kNumFiles];
        for (int i = 0; i < kNumFiles; ++i)
          frame_paths[i] = job.paths[size_t(f) * kNumFiles + i].c_str();
        if (!BuildFrame(frame_paths, job.size, job.out + frame_bytes * f))
          status = 1;
      }
      {
        std::unique_lock<std::mutex> lk(mu_);
        done_[job.ticket] = status;
      }
      done_cv_.notify_all();
    }
  }

  std::vector<std::thread> workers_;
  std::deque<Job> queue_;
  std::map<long, int> done_;
  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  bool stop_ = false;
  long next_ticket_ = 1;
};

}  // namespace

extern "C" {

void* vcl_create(int num_threads) { return new Loader(num_threads); }

void vcl_destroy(void* h) { delete static_cast<Loader*>(h); }

long vcl_submit_clip(void* h, const char** paths, int t, int size,
                     unsigned char* out) {
  Job job;
  job.t = t;
  job.size = size;
  job.out = out;
  job.paths.reserve(size_t(t) * kNumFiles);
  for (int i = 0; i < t * kNumFiles; ++i)
    job.paths.emplace_back(paths[i] ? paths[i] : "");
  return static_cast<Loader*>(h)->Submit(std::move(job));
}

int vcl_wait(void* h, long ticket) { return static_cast<Loader*>(h)->Wait(ticket); }

}  // extern "C"
