// Native dataset-loader runtime: threaded image decode + in-order prefetch,
// plus a generic bounded MPMC threadsafe queue.
//
// Native counterpart of the reference's C++ dataset-reader runtime
// (okvis_multisensor_processing/src/DatasetReader.cpp streaming thread,
// threadsafe::Queue at okvis_multisensor_processing/include/okvis/
// threadsafe/ThreadsafeQueue.hpp:41-212).  The device compute path consumes
// host-resident uint8 frames; this library keeps the host side off the
// Python GIL: a worker pool decodes PNG/PGM images ahead of the consumer and
// delivers them strictly in sequence order through a bounded reorder ring.
//
// C ABI for ctypes.  Build: g++ -O3 -shared -fPIC -std=c++17 \
//     -o libdataloader.so dataloader.cpp -lpng -lz -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <png.h>

namespace {

// ---------------------------------------------------------------------------
// PNG / PGM decode (8-bit grayscale output; 16-bit and RGB inputs converted)
// ---------------------------------------------------------------------------

struct Image {
  int width = 0;
  int height = 0;
  std::vector<uint8_t> pixels;  // row-major gray8
  bool ok = false;
};

Image decode_png(const char* path) {
  Image img;
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return img;
  uint8_t sig[8];
  if (std::fread(sig, 1, 8, fp) != 8 || png_sig_cmp(sig, 0, 8)) {
    std::fclose(fp);
    return img;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    std::fclose(fp);
    return img;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_expand(png);  // palette/1-2-4 bit -> 8 bit
  int color = png_get_color_type(png, info);
  if (color & PNG_COLOR_MASK_COLOR)
    png_set_rgb_to_gray_fixed(png, 1 /*silent*/, -1, -1);
  png_read_update_info(png, info);

  img.width = static_cast<int>(png_get_image_width(png, info));
  img.height = static_cast<int>(png_get_image_height(png, info));
  img.pixels.resize(static_cast<size_t>(img.width) * img.height);
  std::vector<png_bytep> rows(img.height);
  for (int r = 0; r < img.height; ++r)
    rows[r] = img.pixels.data() + static_cast<size_t>(r) * img.width;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  img.ok = true;
  return img;
}

Image decode_pgm(const char* path) {
  // Binary P5 PGM (Leica-style datasets); maxval <= 255 or 65535.
  Image img;
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return img;
  auto next_token = [&](char* buf, size_t cap) -> bool {
    int c;
    do {
      c = std::fgetc(fp);
      if (c == '#') {  // comment to end of line
        while (c != '\n' && c != EOF) c = std::fgetc(fp);
      }
    } while (c == ' ' || c == '\t' || c == '\n' || c == '\r');
    size_t i = 0;
    while (c != EOF && c != ' ' && c != '\t' && c != '\n' && c != '\r') {
      if (i + 1 < cap) buf[i++] = static_cast<char>(c);
      c = std::fgetc(fp);
    }
    buf[i] = 0;
    return i > 0;
  };
  char tok[32];
  if (!next_token(tok, sizeof tok) || std::strcmp(tok, "P5") != 0) {
    std::fclose(fp);
    return img;
  }
  int w = 0, h = 0, maxv = 0;
  if (!next_token(tok, sizeof tok)) { std::fclose(fp); return img; }
  w = std::atoi(tok);
  if (!next_token(tok, sizeof tok)) { std::fclose(fp); return img; }
  h = std::atoi(tok);
  if (!next_token(tok, sizeof tok)) { std::fclose(fp); return img; }
  maxv = std::atoi(tok);
  if (w <= 0 || h <= 0 || maxv <= 0 || maxv > 65535) {
    std::fclose(fp);
    return img;
  }
  img.width = w;
  img.height = h;
  img.pixels.resize(static_cast<size_t>(w) * h);
  if (maxv < 256) {
    if (std::fread(img.pixels.data(), 1, img.pixels.size(), fp) !=
        img.pixels.size()) {
      std::fclose(fp);
      return img;
    }
  } else {
    std::vector<uint8_t> raw(img.pixels.size() * 2);
    if (std::fread(raw.data(), 1, raw.size(), fp) != raw.size()) {
      std::fclose(fp);
      return img;
    }
    for (size_t i = 0; i < img.pixels.size(); ++i) {
      unsigned v = (unsigned(raw[2 * i]) << 8) | raw[2 * i + 1];
      img.pixels[i] = static_cast<uint8_t>(v * 255u / unsigned(maxv));
    }
  }
  std::fclose(fp);
  img.ok = true;
  return img;
}

Image decode_any(const char* path) {
  const char* dot = std::strrchr(path, '.');
  if (dot && (std::strcmp(dot, ".pgm") == 0 || std::strcmp(dot, ".PGM") == 0))
    return decode_pgm(path);
  return decode_png(path);
}

// ---------------------------------------------------------------------------
// In-order prefetcher: worker pool decodes sequence numbers, a bounded
// reorder ring delivers them strictly in file-list order.
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  std::vector<std::thread> workers;

  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for slot ready
  std::condition_variable cv_space;   // workers wait for ring space
  std::vector<Image> ring;            // slot = seq % window
  std::vector<int64_t> slot_seq;      // which seq occupies the slot (-1 free)
  size_t window = 0;
  std::atomic<int64_t> next_fetch{0};  // next seq a worker claims
  int64_t next_deliver = 0;            // next seq the consumer takes
  bool shutdown = false;

  void worker() {
    for (;;) {
      int64_t seq = next_fetch.fetch_add(1);
      if (seq >= static_cast<int64_t>(paths.size())) return;
      Image img = decode_any(paths[static_cast<size_t>(seq)].c_str());
      std::unique_lock<std::mutex> lk(mu);
      // wait until this seq's slot window is open (consumer caught up)
      cv_space.wait(lk, [&] {
        return shutdown ||
               seq < next_deliver + static_cast<int64_t>(window);
      });
      if (shutdown) return;
      size_t slot = static_cast<size_t>(seq % static_cast<int64_t>(window));
      ring[slot] = std::move(img);
      slot_seq[slot] = seq;
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// One-shot decode. Returns 0 on success; fills *w/*h; writes at most `cap`
// bytes into out. Returns -1 on decode failure, -2 if the buffer is too
// small (w/h still filled so the caller can retry).
int dl_decode(const char* path, uint8_t* out, int64_t cap, int* w, int* h) {
  Image img = decode_any(path);
  if (!img.ok) return -1;
  *w = img.width;
  *h = img.height;
  if (static_cast<int64_t>(img.pixels.size()) > cap) return -2;
  std::memcpy(out, img.pixels.data(), img.pixels.size());
  return 0;
}

// paths: n zero-terminated strings concatenated back to back.
void* dl_open(const char* paths, int64_t n, int n_threads, int window) {
  auto* p = new Prefetcher();
  const char* s = paths;
  for (int64_t i = 0; i < n; ++i) {
    p->paths.emplace_back(s);
    s += p->paths.back().size() + 1;
  }
  if (window < 2) window = 2;
  p->window = static_cast<size_t>(window);
  p->ring.resize(p->window);
  p->slot_seq.assign(p->window, -1);
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocks until the next image (in list order) is decoded. Returns 0 on
// success, -1 on decode failure of that image, -3 at end of stream,
// -2 if `cap` is too small.
int dl_next(void* handle, uint8_t* out, int64_t cap, int* w, int* h) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->next_deliver >= static_cast<int64_t>(p->paths.size())) return -3;
  int64_t seq = p->next_deliver;
  size_t slot = static_cast<size_t>(seq % static_cast<int64_t>(p->window));
  p->cv_ready.wait(lk, [&] { return p->shutdown || p->slot_seq[slot] == seq; });
  if (p->slot_seq[slot] != seq) return -3;  // shut down while waiting
  Image img = std::move(p->ring[slot]);
  p->slot_seq[slot] = -1;
  ++p->next_deliver;
  p->cv_space.notify_all();
  lk.unlock();
  if (!img.ok) return -1;
  *w = img.width;
  *h = img.height;
  if (static_cast<int64_t>(img.pixels.size()) > cap) return -2;
  std::memcpy(out, img.pixels.data(), img.pixels.size());
  return 0;
}

void dl_close(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->shutdown = true;
    // park the claim counter at the end so workers exit their loops
    p->next_fetch.store(static_cast<int64_t>(p->paths.size()));
  }
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

// ---------------------------------------------------------------------------
// Generic bounded MPMC byte queue (≙ okvis::threadsafe::Queue:
// PushBlockingIfFull / PushNonBlockingDroppingIfFull / PopBlocking /
// PopTimeout / Shutdown — ThreadsafeQueue.hpp:41-212).
// ---------------------------------------------------------------------------

struct ByteQueue {
  std::mutex mu;
  std::condition_variable cv_pop, cv_push;
  std::vector<std::vector<uint8_t>> buf;
  size_t head = 0, count = 0, cap = 0;
  bool shutdown = false;
};

void* tsq_create(int capacity) {
  auto* q = new ByteQueue();
  q->cap = capacity < 1 ? 1 : static_cast<size_t>(capacity);
  q->buf.resize(q->cap);
  return q;
}

// Blocks while full. Returns 0, or -1 after shutdown.
int tsq_push(void* handle, const uint8_t* data, int64_t size) {
  auto* q = static_cast<ByteQueue*>(handle);
  std::unique_lock<std::mutex> lk(q->mu);
  q->cv_push.wait(lk, [&] { return q->shutdown || q->count < q->cap; });
  if (q->shutdown) return -1;
  q->buf[(q->head + q->count) % q->cap].assign(data, data + size);
  ++q->count;
  q->cv_pop.notify_one();
  return 0;
}

// Drops the oldest element when full (visualisation-style queues).
// Returns number of dropped elements (0 or 1), or -1 after shutdown.
int tsq_push_dropping(void* handle, const uint8_t* data, int64_t size) {
  auto* q = static_cast<ByteQueue*>(handle);
  std::lock_guard<std::mutex> lk(q->mu);
  if (q->shutdown) return -1;
  int dropped = 0;
  if (q->count == q->cap) {
    q->head = (q->head + 1) % q->cap;
    --q->count;
    dropped = 1;
  }
  q->buf[(q->head + q->count) % q->cap].assign(data, data + size);
  ++q->count;
  q->cv_pop.notify_one();
  return dropped;
}

// Blocks up to timeout_ms (<0: forever). Returns payload size (copied into
// out, at most cap), -2 if the buffer is too small (element stays queued),
// -3 on timeout/empty-after-shutdown.
int64_t tsq_pop(void* handle, uint8_t* out, int64_t cap, int timeout_ms) {
  auto* q = static_cast<ByteQueue*>(handle);
  std::unique_lock<std::mutex> lk(q->mu);
  auto ready = [&] { return q->shutdown || q->count > 0; };
  if (timeout_ms < 0) {
    q->cv_pop.wait(lk, ready);
  } else if (!q->cv_pop.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                                 ready)) {
    return -3;
  }
  if (q->count == 0) return -3;  // shutdown drained
  auto& e = q->buf[q->head];
  if (static_cast<int64_t>(e.size()) > cap) return -2;
  std::memcpy(out, e.data(), e.size());
  int64_t size = static_cast<int64_t>(e.size());
  e.clear();
  e.shrink_to_fit();
  q->head = (q->head + 1) % q->cap;
  --q->count;
  q->cv_push.notify_one();
  return size;
}

int tsq_size(void* handle) {
  auto* q = static_cast<ByteQueue*>(handle);
  std::lock_guard<std::mutex> lk(q->mu);
  return static_cast<int>(q->count);
}

void tsq_shutdown(void* handle) {
  auto* q = static_cast<ByteQueue*>(handle);
  {
    std::lock_guard<std::mutex> lk(q->mu);
    q->shutdown = true;
  }
  q->cv_pop.notify_all();
  q->cv_push.notify_all();
}

void tsq_destroy(void* handle) { delete static_cast<ByteQueue*>(handle); }

}  // extern "C"
