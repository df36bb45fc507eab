// Native data plane: threaded record reader with ring buffer + shuffle pool.
//
// Reference parity: paddle/fluid/framework/data_feed.cc (MultiSlotDataFeed,
// channel-based readers) + operators/reader/buffered_reader.cc. The
// consumer is the Python host thread that collates batches; the Executor
// copies them to the card, so no thread of this file touches CUDA. The
// contract is:
// N file-reader threads -> bounded ring buffer (+ optional shuffle pool)
// -> single consumer pop.
//
// Record file format ("ptrec"):
//   magic  u32 = 0x70747263 ("ptrc")
//   len    u64 little-endian payload byte length
//   hash   u64 FNV-1a of payload (integrity check, no zlib dependency)
//   payload bytes
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -pthread (see build.py), at first
// use; exposed via ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x70747263u;

uint64_t fnv1a(const char* data, size_t n) {
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= 1099511628211ull;
  }
  return h;
}

struct Record {
  char* data;
  int64_t len;
};

class RingBuffer {
 public:
  explicit RingBuffer(size_t capacity) : capacity_(capacity) {}

  void Push(Record r) {
    std::unique_lock<std::mutex> lk(mu_);
    not_full_.wait(lk, [&] { return q_.size() < capacity_ || closed_; });
    if (closed_) { std::free(r.data); return; }
    q_.push_back(r);
    not_empty_.notify_one();
  }

  bool Pop(Record* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [&] { return !q_.empty() || (done_ && active_ == 0) ||
                                     closed_; });
    if (closed_ || (q_.empty() && done_ && active_ == 0)) return false;
    *out = q_.front();
    q_.pop_front();
    not_full_.notify_one();
    return true;
  }

  void ProducerStart() {
    std::lock_guard<std::mutex> lk(mu_);
    ++active_;
  }

  void ProducerDone() {
    std::lock_guard<std::mutex> lk(mu_);
    if (--active_ == 0) { done_ = true; not_empty_.notify_all(); }
  }

  void Close() {
    std::lock_guard<std::mutex> lk(mu_);
    closed_ = true;
    for (auto& r : q_) std::free(r.data);
    q_.clear();
    not_empty_.notify_all();
    not_full_.notify_all();
  }

 private:
  size_t capacity_;
  std::deque<Record> q_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  int active_ = 0;
  bool done_ = false, closed_ = false;
};

class Reader {
 public:
  Reader(std::vector<std::string> paths, int buffer_records, int shuffle_pool,
         unsigned seed, int num_threads)
      : paths_(std::move(paths)),
        ring_(buffer_records > 0 ? buffer_records : 256),
        shuffle_pool_(shuffle_pool),
        rng_(seed) {
    int n = num_threads > 0 ? num_threads : 1;
    if (n > static_cast<int>(paths_.size())) n = paths_.size();
    if (n < 1) n = 1;
    for (int t = 0; t < n; ++t) {
      ring_.ProducerStart();
      threads_.emplace_back([this, t, n] { ReadFiles(t, n); });
    }
  }

  ~Reader() {
    ring_.Close();
    for (auto& th : threads_) th.join();
  }

  // Pops through the shuffle pool: fill pool to size, then emit a random
  // element per pop (reference InMemoryDataFeed local shuffle).
  bool Next(char** data, int64_t* len) {
    while (shuffle_pool_ > 0 &&
           static_cast<int>(pool_.size()) < shuffle_pool_) {
      Record r;
      if (!ring_.Pop(&r)) break;
      pool_.push_back(r);
    }
    if (!pool_.empty()) {
      std::uniform_int_distribution<size_t> d(0, pool_.size() - 1);
      size_t i = d(rng_);
      Record r = pool_[i];
      pool_[i] = pool_.back();
      pool_.pop_back();
      *data = r.data;
      *len = r.len;
      return true;
    }
    Record r;
    if (!ring_.Pop(&r)) return false;
    *data = r.data;
    *len = r.len;
    return true;
  }

 private:
  void ReadFiles(int tid, int stride) {
    for (size_t i = tid; i < paths_.size(); i += stride) {
      FILE* f = std::fopen(paths_[i].c_str(), "rb");
      if (!f) continue;
      while (true) {
        uint32_t magic;
        if (std::fread(&magic, 4, 1, f) != 1) break;
        if (magic != kMagic) break;  // corrupt/truncated tail
        uint64_t len, hash;
        if (std::fread(&len, 8, 1, f) != 1) break;
        if (std::fread(&hash, 8, 1, f) != 1) break;
        if (len > (1ull << 33)) break;
        char* buf = static_cast<char*>(std::malloc(len));
        if (!buf || std::fread(buf, 1, len, f) != len) {
          std::free(buf);
          break;
        }
        if (fnv1a(buf, len) != hash) {  // integrity failure: stop this file
          std::free(buf);
          break;
        }
        ring_.Push({buf, static_cast<int64_t>(len)});
      }
      std::fclose(f);
    }
    ring_.ProducerDone();
  }

  std::vector<std::string> paths_;
  RingBuffer ring_;
  int shuffle_pool_;
  std::vector<Record> pool_;
  std::mt19937 rng_;
  std::vector<std::thread> threads_;
};

struct Writer {
  FILE* f;
};

// ---------------------------------------------------------------------------
// MultiSlot text parser (reference framework/data_feed.cc MultiSlotDataFeed).
// One sample per line; per slot: "<count> v0 v1 ... v(count-1)", groups
// space-separated in slot order — the exact text format our
// incubate.data_generator emits and the reference's pipe_command feeds.
// Packed output layout (host-endian):
//   u64 n_samples
//   per sample, per slot: u32 count; count values (f32 if is_float else i64)
// ---------------------------------------------------------------------------

thread_local std::string g_ms_error;

// malloc-backed growable buffer: the parse result is handed to the caller
// as-is (ownership transfer, freed via dp_free) — no final copy.
struct Buf {
  char* p = nullptr;
  size_t len = 0, cap = 0;

  bool Append(const void* src, size_t n) {
    if (len + n > cap) {
      size_t want = cap ? cap * 2 : 4096;
      while (want < len + n) want *= 2;
      char* np = static_cast<char*>(std::realloc(p, want));
      if (!np) return false;
      p = np;
      cap = want;
    }
    std::memcpy(p + len, src, n);
    len += n;
    return true;
  }
};

template <typename T>
bool AppendRaw(Buf* out, T v) {
  return out->Append(&v, sizeof(T));
}

bool ParseLine(char* line, size_t line_no, const char* path, int n_slots,
               const unsigned char* is_float, Buf* out) {
  char* p = line;
  for (int s = 0; s < n_slots; ++s) {
    char* endp = nullptr;
    long long count = std::strtoll(p, &endp, 10);
    if (endp == p || count < 0 || count > (1ll << 31)) {
      g_ms_error = std::string(path) + ":" + std::to_string(line_no) +
                   ": bad slot count for slot " + std::to_string(s);
      return false;
    }
    p = endp;
    if (!AppendRaw(out, static_cast<uint32_t>(count))) {
      g_ms_error = "out of memory";
      return false;
    }
    for (long long i = 0; i < count; ++i) {
      if (is_float[s]) {
        float v = std::strtof(p, &endp);
        if (endp == p) {
          g_ms_error = std::string(path) + ":" + std::to_string(line_no) +
                       ": slot " + std::to_string(s) + " expects " +
                       std::to_string(count) + " float values";
          return false;
        }
        if (!AppendRaw(out, v)) {
          g_ms_error = "out of memory";
          return false;
        }
      } else {
        long long v = std::strtoll(p, &endp, 10);
        if (endp == p) {
          g_ms_error = std::string(path) + ":" + std::to_string(line_no) +
                       ": slot " + std::to_string(s) + " expects " +
                       std::to_string(count) + " int values";
          return false;
        }
        if (!AppendRaw(out, static_cast<int64_t>(v))) {
          g_ms_error = "out of memory";
          return false;
        }
      }
      p = endp;
    }
  }
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  if (*p != '\0') {
    g_ms_error = std::string(path) + ":" + std::to_string(line_no) +
                 ": trailing data after the last slot";
    return false;
  }
  return true;
}

}  // namespace

extern "C" {

void* dp_reader_create(const char** paths, int n_paths, int buffer_records,
                       int shuffle_pool, unsigned seed, int num_threads) {
  std::vector<std::string> p;
  for (int i = 0; i < n_paths; ++i) p.emplace_back(paths[i]);
  return new Reader(std::move(p), buffer_records, shuffle_pool, seed,
                    num_threads);
}

int dp_reader_next(void* r, char** data, int64_t* len) {
  return static_cast<Reader*>(r)->Next(data, len) ? 1 : 0;
}

void dp_reader_destroy(void* r) { delete static_cast<Reader*>(r); }

void dp_free(char* p) { std::free(p); }

void* dp_writer_create(const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  return w;
}

int dp_writer_write(void* vw, const char* data, int64_t len) {
  auto* w = static_cast<Writer*>(vw);
  uint64_t ulen = static_cast<uint64_t>(len);
  uint64_t hash = fnv1a(data, len);
  if (std::fwrite(&kMagic, 4, 1, w->f) != 1) return 0;
  if (std::fwrite(&ulen, 8, 1, w->f) != 1) return 0;
  if (std::fwrite(&hash, 8, 1, w->f) != 1) return 0;
  if (std::fwrite(data, 1, len, w->f) != static_cast<size_t>(len)) return 0;
  return 1;
}

void dp_writer_close(void* vw) {
  auto* w = static_cast<Writer*>(vw);
  std::fclose(w->f);
  delete w;
}

char* ms_parse_file(const char* path, int n_slots,
                    const unsigned char* is_float, uint64_t* out_len) {
  g_ms_error.clear();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    g_ms_error = std::string("cannot open ") + path;
    return nullptr;
  }
  // seekable regular files only: pipes/FIFOs report ftell failure
  long sz = -1;
  if (std::fseek(f, 0, SEEK_END) == 0) sz = std::ftell(f);
  if (sz < 0 || std::fseek(f, 0, SEEK_SET) != 0) {
    std::fclose(f);
    g_ms_error = std::string(path) +
                 ": not a seekable regular file (pipe/FIFO?)";
    return nullptr;
  }
  std::vector<char> text(static_cast<size_t>(sz) + 1);
  if (sz > 0 && std::fread(text.data(), 1, sz, f) != static_cast<size_t>(sz)) {
    std::fclose(f);
    g_ms_error = std::string("short read on ") + path;
    return nullptr;
  }
  std::fclose(f);
  text[sz] = '\0';

  Buf out;
  uint64_t n_samples = 0;
  if (!out.Append(&n_samples, 8)) {  // patched at the end
    g_ms_error = "out of memory";
    return nullptr;
  }
  char* p = text.data();
  char* end = text.data() + sz;
  size_t line_no = 0;
  while (p < end) {
    char* nl = static_cast<char*>(std::memchr(p, '\n', end - p));
    char* line_end = nl ? nl : end;
    *line_end = '\0';
    ++line_no;
    bool blank = true;
    for (char* q = p; *q; ++q)
      if (*q != ' ' && *q != '\t' && *q != '\r') { blank = false; break; }
    if (!blank) {
      if (!ParseLine(p, line_no, path, n_slots, is_float, &out)) {
        std::free(out.p);
        return nullptr;
      }
      ++n_samples;
    }
    p = line_end + 1;
  }
  std::memcpy(out.p, &n_samples, 8);
  *out_len = out.len;
  return out.p;  // ownership transfers to the caller (dp_free)
}

const char* ms_last_error() { return g_ms_error.c_str(); }

}  // extern "C"
