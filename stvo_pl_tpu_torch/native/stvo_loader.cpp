// Native host-side stereo image loader of stvo_pl_tpu_torch.
//
// Replaces the reference's per-frame cv::imread + cv::remap on the main
// thread (reference src/dataset.cpp:147-157, src/pinholeStereoCamera.cpp:
// 196-208) with a C++ pipeline that overlaps disk I/O and decode with
// device compute:
//   * decoders: PGM/PPM (P2/P3/P5/P6) and PNG (8/16-bit gray/RGB/RGBA,
//     non-interlaced, via zlib inflate) -> float32 grayscale;
//   * bilinear remap against precomputed rectification maps (optional;
//     kept for parity with the JAX package's loader: the port's dataset
//     rectifies on the device and passes no maps, so nothing calls it);
//   * a prefetch thread pool that decodes at most `capacity` frames ahead
//     of the consumer, emitted in sequence order; its threads are named
//     "stvo-loader" (what /proc/<pid>/task/<tid>/comm reads), so a
//     process can tell them from its other threads.
//
// Every decoded image must be width x height: a frame whose file does not
// decode, or decodes to another size, is reported to the caller as an
// error (stvo_loader_next's negative codes), never as the end of the
// sequence.
//
// C ABI only (consumed via ctypes from stvo_pl_tpu_torch.native.loader).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <exception>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <pthread.h>
#include <zlib.h>

namespace {

struct Image {
  int w = 0, h = 0, channels = 0;
  std::vector<float> gray;  // h * w, luminance
  bool ok = false;
};

// ---------------------------------------------------------------- PGM/PPM
Image decode_pnm(const std::vector<uint8_t>& buf) {
  Image out;
  size_t pos = 0;
  auto skip_ws = [&]() {
    while (pos < buf.size()) {
      if (buf[pos] == '#') {
        while (pos < buf.size() && buf[pos] != '\n') pos++;
      } else if (isspace(buf[pos])) {
        pos++;
      } else {
        break;
      }
    }
  };
  auto read_int = [&]() -> long {
    skip_ws();
    long v = 0;
    while (pos < buf.size() && isdigit(buf[pos])) v = v * 10 + (buf[pos++] - '0');
    return v;
  };
  if (buf.size() < 2 || buf[0] != 'P') return out;
  int type = buf[1] - '0';
  pos = 2;
  long w = read_int(), h = read_int(), maxv = read_int();
  if (w <= 0 || h <= 0 || maxv <= 0) return out;
  int ch = (type == 3 || type == 6) ? 3 : 1;
  out.w = (int)w; out.h = (int)h; out.channels = ch;
  out.gray.resize(w * h);
  double scale = 255.0 / maxv;
  if (type == 5 || type == 6) {  // binary
    pos++;  // single whitespace after maxval
    int bpp = maxv > 255 ? 2 : 1;
    size_t need = (size_t)w * h * ch * bpp;
    if (buf.size() - pos < need) return out;
    const uint8_t* p = buf.data() + pos;
    for (long i = 0; i < w * h; i++) {
      double acc = 0;
      for (int c = 0; c < ch; c++) {
        long v = bpp == 1 ? p[i * ch + c]
                          : (p[(i * ch + c) * 2] << 8) | p[(i * ch + c) * 2 + 1];
        acc += c == 0 ? 0.299 * v : (c == 1 ? 0.587 * v : 0.114 * v);
      }
      if (ch == 1) acc = bpp == 1 ? p[i] : ((p[2 * i] << 8) | p[2 * i + 1]);
      out.gray[i] = (float)(acc * scale);
    }
  } else if (type == 2 || type == 3) {  // ascii
    for (long i = 0; i < w * h; i++) {
      double acc = 0;
      for (int c = 0; c < ch; c++) {
        long v = read_int();
        acc += ch == 1 ? v : (c == 0 ? 0.299 * v : (c == 1 ? 0.587 * v : 0.114 * v));
      }
      out.gray[i] = (float)(acc * scale);
    }
  } else {
    return out;
  }
  out.ok = true;
  return out;
}

// -------------------------------------------------------------------- PNG
uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

Image decode_png(const std::vector<uint8_t>& buf) {
  Image out;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 8 || memcmp(buf.data(), sig, 8) != 0) return out;
  size_t pos = 8;
  int w = 0, h = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    if (pos + 12 + len > buf.size()) break;
    const char* type = (const char*)&buf[pos + 4];
    const uint8_t* data = &buf[pos + 8];
    if (!memcmp(type, "IHDR", 4)) {
      w = be32(data); h = be32(data + 4);
      bit_depth = data[8]; color_type = data[9]; interlace = data[12];
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (w <= 0 || h <= 0 || interlace != 0) return out;
  if (bit_depth != 8 && bit_depth != 16) return out;
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default: return out;    // palette unsupported
  }
  int bpp = ch * bit_depth / 8;
  size_t stride = (size_t)w * bpp;
  std::vector<uint8_t> raw(h * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return out;
  // unfilter
  std::vector<uint8_t> img(h * stride);
  for (int y = 0; y < h; y++) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    uint8_t* dst = &img[y * stride];
    const uint8_t* prev = y > 0 ? &img[(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; x++) {
      int a = x >= (size_t)bpp ? dst[x - bpp] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= (size_t)bpp) ? prev[x - bpp] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return out;
      }
      dst[x] = (uint8_t)v;
    }
  }
  out.w = w; out.h = h; out.channels = ch;
  out.gray.resize((size_t)w * h);
  int step = bit_depth / 8;
  for (long i = 0; i < (long)w * h; i++) {
    const uint8_t* p = &img[i * bpp];
    auto sample = [&](int c) -> double {
      const uint8_t* q = p + c * step;
      return step == 1 ? *q : ((q[0] << 8) | q[1]) / 257.0;
    };
    double v;
    if (color_type == 0 || color_type == 4) v = sample(0);
    else v = 0.299 * sample(0) + 0.587 * sample(1) + 0.114 * sample(2);
    out.gray[i] = (float)v;
  }
  out.ok = true;
  return out;
}

Image decode_file(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  Image out;
  if (!f) return out;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  if (n < 0) { fclose(f); return out; }
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(n);
  if (fread(buf.data(), 1, n, f) != (size_t)n) { fclose(f); return out; }
  fclose(f);
  if (n >= 2 && buf[0] == 'P' && buf[1] >= '1' && buf[1] <= '6')
    return decode_pnm(buf);
  return decode_png(buf);
}

// ------------------------------------------------------------------ remap
void remap_bilinear(const float* src, int sh, int sw, const float* map_xy,
                    int dh, int dw, float* dst) {
  for (long i = 0; i < (long)dh * dw; i++) {
    float x = map_xy[2 * i], y = map_xy[2 * i + 1];
    int x0 = (int)floorf(x), y0 = (int)floorf(y);
    float fx = x - x0, fy = y - y0;
    auto at = [&](int yy, int xx) -> float {
      if (xx < 0 || xx >= sw || yy < 0 || yy >= sh) return 0.f;
      return src[(long)yy * sw + xx];
    };
    float top = at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx;
    float bot = at(y0 + 1, x0) * (1 - fx) + at(y0 + 1, x0 + 1) * fx;
    dst[i] = top * (1 - fy) + bot * fy;
  }
}

// --------------------------------------------------------------- prefetch
// Frame status, and stvo_loader_next's return codes: 1 a pair was
// written, 0 the sequence ended; otherwise -(2 * status + eye) with eye 0
// for the left image and 1 for the right.
enum Status { kOk = 0, kUndecodable = 1, kWrongSize = 2 };

struct Loader {
  std::vector<std::string> paths_l, paths_r;
  int width = 0, height = 0;
  std::vector<float> map_l, map_r;  // optional, 2*H*W each
  bool has_maps = false;
  int capacity = 12;  // frames decoded ahead of the consumer, at most

  struct Frame {
    int index;
    std::vector<float> l, r;
    int status = kOk, eye = 0, w = 0, h = 0;  // the failing eye's size
  };

  std::deque<std::unique_ptr<Frame>> ready;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<int> next_to_load{0};
  // guarded by mu
  int next_to_emit_seq = 0;
  int n_consumed = 0;   // frames taken by stvo_loader_next
  int peak = 0;         // most frames held (ready + done_pool) at once
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;
  // out-of-order completion buffer
  std::deque<std::unique_ptr<Frame>> done_pool;

  // A worker decodes frame idx only once idx < n_consumed + capacity, so
  // ready + done_pool never hold more than `capacity` frames.  The frame
  // the consumer waits for (idx == n_consumed) always may start, and so
  // may every frame below it: the window cannot deadlock, whatever order
  // the frames finish in.
  void worker() {
    while (!stop.load()) {
      int idx = next_to_load.fetch_add(1);
      if (idx >= (int)paths_l.size()) return;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] {
          return stop.load() || idx < n_consumed + capacity;
        });
        if (stop.load()) return;
      }
      auto fr = std::make_unique<Frame>();
      fr->index = idx;
      load_pair(idx, *fr);
      std::lock_guard<std::mutex> lk(mu);
      done_pool.push_back(std::move(fr));
      promote_ready();
      peak = std::max(peak, (int)(ready.size() + done_pool.size()));
      cv_ready.notify_all();
    }
  }

  // move frames into `ready` in sequence order (mu held)
  void promote_ready() {
    bool moved = true;
    while (moved) {
      moved = false;
      for (auto it = done_pool.begin(); it != done_pool.end(); ++it) {
        if ((*it)->index == next_to_emit_seq) {
          ready.push_back(std::move(*it));
          done_pool.erase(it);
          next_to_emit_seq++;
          moved = true;
          break;
        }
      }
    }
  }

  // decode (and remap) one eye into dst; false with fr's status, eye and
  // the image's size
  bool finish(const std::string& path, int eye,
              const std::vector<float>& mp, std::vector<float>& dst,
              Frame& fr) {
    fr.eye = eye;
    Image im = decode_file(path);
    if (!im.ok || im.w != width || im.h != height) {
      fr.status = im.ok ? kWrongSize : kUndecodable;
      fr.w = im.w;
      fr.h = im.h;
      return false;
    }
    if (has_maps) {
      dst.resize((size_t)height * width);
      remap_bilinear(im.gray.data(), im.h, im.w, mp.data(), height, width,
                     dst.data());
    } else {
      dst = std::move(im.gray);
    }
    return true;
  }

  void load_pair(int idx, Frame& fr) {
    try {
      if (finish(paths_l[idx], 0, map_l, fr.l, fr))
        finish(paths_r[idx], 1, map_r, fr.r, fr);
    } catch (const std::exception&) {  // e.g. a header's size beyond memory
      fr.status = kUndecodable;
    }
  }
};

}  // namespace

extern "C" {

void* stvo_loader_open(const char** paths_l, const char** paths_r, int n,
                       int width, int height, const float* map_l,
                       const float* map_r, int n_threads, int capacity) {
  auto* ld = new Loader();
  ld->capacity = capacity > 0 ? capacity : 1;
  ld->paths_l.assign(paths_l, paths_l + n);
  ld->paths_r.assign(paths_r, paths_r + n);
  ld->width = width;
  ld->height = height;
  if (map_l && map_r) {
    ld->has_maps = true;
    ld->map_l.assign(map_l, map_l + 2l * width * height);
    ld->map_r.assign(map_r, map_r + 2l * width * height);
  }
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; i++) {
    ld->workers.emplace_back([ld] { ld->worker(); });
    // named here, before open returns, not by the thread itself
    pthread_setname_np(ld->workers.back().native_handle(), "stvo-loader");
  }
  return ld;
}

// Blocks until the next sequential frame is ready and copies it into
// out_l/out_r (each width*height floats).  Returns 1 on success, 0 at the
// end of the sequence, and -(2 * status + eye) for a frame that failed,
// with the failing image's decoded size in wh[0], wh[1] (0 when it did not
// decode).
int stvo_loader_next(void* handle, float* out_l, float* out_r, int* wh) {
  auto* ld = (Loader*)handle;
  std::unique_lock<std::mutex> lk(ld->mu);
  ld->cv_ready.wait(lk, [&] {
    return ld->stop.load() || !ld->ready.empty() ||
           (ld->next_to_emit_seq >= (int)ld->paths_l.size() &&
            ld->done_pool.empty());
  });
  if (ld->ready.empty()) return 0;
  auto fr = std::move(ld->ready.front());
  ld->ready.pop_front();
  ld->n_consumed++;
  ld->cv_space.notify_all();
  lk.unlock();
  if (fr->status != kOk) {
    wh[0] = fr->w;
    wh[1] = fr->h;
    return -(2 * fr->status + fr->eye);
  }
  size_t n = (size_t)ld->width * ld->height;
  memcpy(out_l, fr->l.data(), n * sizeof(float));
  memcpy(out_r, fr->r.data(), n * sizeof(float));
  return 1;
}

// Frames decoded and not yet taken: returns how many there are now, and
// writes the most there have been at once to *peak.
int stvo_loader_buffered(void* handle, int* peak) {
  auto* ld = (Loader*)handle;
  std::lock_guard<std::mutex> lk(ld->mu);
  *peak = ld->peak;
  return (int)(ld->ready.size() + ld->done_pool.size());
}

void stvo_loader_close(void* handle) {
  auto* ld = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->stop.store(true);
  }
  ld->cv_space.notify_all();
  ld->cv_ready.notify_all();
  for (auto& t : ld->workers) t.join();
  delete ld;
}

// one-shot decode (no prefetch): the decoded image, with its size in w and
// h, or null when the file does not decode; stvo_image_take copies it into
// out (w * h floats) and frees it
void* stvo_image_decode(const char* path, int* w, int* h) {
  try {
    auto im = std::make_unique<Image>(decode_file(path));
    if (!im->ok) return nullptr;
    *w = im->w;
    *h = im->h;
    return im.release();
  } catch (const std::exception&) {
    return nullptr;
  }
}

void stvo_image_take(void* image, float* out) {
  auto* im = (Image*)image;
  memcpy(out, im->gray.data(), im->gray.size() * sizeof(float));
  delete im;
}

}  // extern "C"
