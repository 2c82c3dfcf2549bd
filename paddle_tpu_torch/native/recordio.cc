// Native recordio reader/writer + background prefetch loader.
//
// Parity: paddle/fluid/recordio/{chunk,scanner,writer}.cc and the
// double-buffered reader (reader/create_double_buffer_reader_op.cc).
// Format (matches the Python fallback in reader_io.py):
//   [4-byte magic "PTRC"] then per record: [u32 len][u32 crc32][payload]
//
// The prefetch loader runs reader threads that stage payloads into a
// bounded multi-producer single-consumer queue, overlapping disk IO +
// checksum with device compute (the role the reference's double_buffer
// reader plays on its CUDA stream).
//
// Built with g++ at first use into build/native/ and bound from Python
// via ctypes (paddle_tpu_torch/native/loader.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr char kMagic[4] = {'P', 'T', 'R', 'C'};
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the record headers and the CRC's word loads are "
              "little-endian");

// zlib-compatible CRC-32 (IEEE 802.3 polynomial, reflected), eight
// bytes a step through eight tables ("slicing-by-8"): about 5x the
// byte-at-a-time loop, whose dependent table loads held a 19 MB image
// batch's read to ~65 ms.
class Crc32 {
 public:
  Crc32() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table_[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        table_[s][i] = (table_[s - 1][i] >> 8) ^
                       table_[0][table_[s - 1][i] & 0xFF];
  }
  uint32_t operator()(const uint8_t* data, size_t n) const {
    uint32_t c = 0xFFFFFFFFu;
    for (; n >= 8; data += 8, n -= 8) {
      uint32_t lo, hi;                 // little-endian words
      memcpy(&lo, data, 4);
      memcpy(&hi, data + 4, 4);
      lo ^= c;
      c = table_[7][lo & 0xFF] ^ table_[6][(lo >> 8) & 0xFF] ^
          table_[5][(lo >> 16) & 0xFF] ^ table_[4][lo >> 24] ^
          table_[3][hi & 0xFF] ^ table_[2][(hi >> 8) & 0xFF] ^
          table_[1][(hi >> 16) & 0xFF] ^ table_[0][hi >> 24];
    }
    for (; n > 0; ++data, --n)
      c = table_[0][(c ^ *data) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
  }

 private:
  uint32_t table_[8][256];
};

const Crc32 g_crc;

struct Reader {
  FILE* f = nullptr;
  std::vector<uint8_t> buf;
  std::string error;
};

struct Writer {
  FILE* f = nullptr;
  uint64_t count = 0;
};

bool read_header(Reader* r) {
  char magic[4];
  if (fread(magic, 1, 4, r->f) != 4 ||
      memcmp(magic, kMagic, 4) != 0) {
    r->error = "bad magic";
    return false;
  }
  return true;
}

struct Queue {
  std::deque<std::vector<uint8_t>> items;
  std::mutex mu;
  std::condition_variable not_full, not_empty;
  size_t capacity;
  bool done = false;

  explicit Queue(size_t cap) : capacity(cap) {}

  bool push(std::vector<uint8_t>&& v) {
    std::unique_lock<std::mutex> lk(mu);
    not_full.wait(lk, [&] { return items.size() < capacity || done; });
    if (done) return false;
    items.emplace_back(std::move(v));
    not_empty.notify_one();
    return true;
  }

  bool pop(std::vector<uint8_t>* out) {
    std::unique_lock<std::mutex> lk(mu);
    not_empty.wait(lk, [&] { return !items.empty() || done; });
    if (items.empty()) return false;
    *out = std::move(items.front());
    items.pop_front();
    not_full.notify_one();
    return true;
  }

  void close() {
    std::lock_guard<std::mutex> lk(mu);
    done = true;
    not_full.notify_all();
    not_empty.notify_all();
  }
};

struct Loader {
  Queue queue;
  std::vector<std::thread> threads;
  std::vector<std::string> files;
  std::mutex file_mu;
  size_t next_file = 0;
  int passes;
  int active_workers = 0;
  std::vector<uint8_t> current;
  int error_count = 0;       // guarded by err_mu
  std::string first_error;   // guarded by err_mu
  std::mutex err_mu;

  Loader(size_t cap, int passes) : queue(cap), passes(passes) {}

  void record_error(const std::string& e) {
    std::lock_guard<std::mutex> lk(err_mu);
    if (error_count++ == 0) first_error = e;
  }
};

bool read_one(FILE* f, std::vector<uint8_t>* out, std::string* err) {
  uint32_t hdr[2];
  size_t n = fread(hdr, 1, sizeof(hdr), f);
  if (n == 0) return false;  // clean EOF
  if (n != sizeof(hdr)) {
    *err = "truncated header";
    return false;
  }
  out->resize(hdr[0]);
  if (fread(out->data(), 1, hdr[0], f) != hdr[0]) {
    *err = "truncated payload";
    return false;
  }
  if (g_crc(out->data(), out->size()) != hdr[1]) {
    *err = "crc mismatch";
    return false;
  }
  return true;
}

void loader_worker(Loader* L) {
  for (;;) {
    std::string path;
    {
      std::lock_guard<std::mutex> lk(L->file_mu);
      if (L->next_file >= L->files.size() * (size_t)L->passes) break;
      path = L->files[L->next_file % L->files.size()];
      ++L->next_file;
    }
    Reader r;
    r.f = fopen(path.c_str(), "rb");
    if (!r.f || !read_header(&r)) {
      if (r.f) fclose(r.f);
      // a missing / non-recordio file is data loss, not a skip
      L->record_error(path + ": cannot open or bad magic");
      continue;
    }
    std::vector<uint8_t> rec;
    std::string err;
    while (read_one(r.f, &rec, &err)) {
      if (!L->queue.push(std::move(rec))) {
        fclose(r.f);
        goto out;
      }
      rec.clear();
    }
    if (!err.empty()) L->record_error(path + ": " + err);
    fclose(r.f);
  }
out:
  // the LAST worker to finish marks end-of-stream; pending records stay
  // in the queue and drain through pop() before it reports done
  {
    std::lock_guard<std::mutex> lk(L->file_mu);
    if (--L->active_workers == 0) {
      std::lock_guard<std::mutex> qlk(L->queue.mu);
      L->queue.done = true;
      L->queue.not_empty.notify_all();
      L->queue.not_full.notify_all();
    }
  }
}

}  // namespace

extern "C" {

// ---- sequential reader ----------------------------------------------------
void* rio_open(const char* path) {
  Reader* r = new Reader();
  r->f = fopen(path, "rb");
  if (!r->f || !read_header(r)) {
    if (r->f) fclose(r->f);
    delete r;
    return nullptr;
  }
  return r;
}

// Returns pointer to the record payload (owned by the reader until the
// next call), sets *len; nullptr at EOF or error (check rio_error).
const uint8_t* rio_next(void* handle, uint64_t* len) {
  Reader* r = static_cast<Reader*>(handle);
  std::string err;
  if (!read_one(r->f, &r->buf, &err)) {
    r->error = err;
    *len = 0;
    return nullptr;
  }
  *len = r->buf.size();
  return r->buf.data();
}

const char* rio_error(void* handle) {
  return static_cast<Reader*>(handle)->error.c_str();
}

void rio_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (r->f) fclose(r->f);
  delete r;
}

// ---- writer ---------------------------------------------------------------
void* rio_writer_open(const char* path) {
  Writer* w = new Writer();
  w->f = fopen(path, "wb");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  fwrite(kMagic, 1, 4, w->f);
  return w;
}

int rio_write(void* handle, const uint8_t* data, uint64_t len) {
  Writer* w = static_cast<Writer*>(handle);
  uint32_t hdr[2] = {static_cast<uint32_t>(len), g_crc(data, len)};
  if (fwrite(hdr, 1, sizeof(hdr), w->f) != sizeof(hdr)) return -1;
  if (fwrite(data, 1, len, w->f) != len) return -1;
  ++w->count;
  return 0;
}

uint64_t rio_writer_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  uint64_t n = w->count;
  fclose(w->f);
  delete w;
  return n;
}

// ---- prefetch loader ------------------------------------------------------
void* loader_create(const char** paths, int n_paths, int n_threads,
                    int capacity, int passes) {
  Loader* L = new Loader(capacity > 0 ? capacity : 64,
                         passes > 0 ? passes : 1);
  for (int i = 0; i < n_paths; ++i) L->files.emplace_back(paths[i]);
  int nt = n_threads > 0 ? n_threads : 1;
  L->active_workers = nt;
  for (int i = 0; i < nt; ++i)
    L->threads.emplace_back(loader_worker, L);
  return L;
}

const uint8_t* loader_next(void* handle, uint64_t* len) {
  Loader* L = static_cast<Loader*>(handle);
  if (!L->queue.pop(&L->current)) {
    *len = 0;
    return nullptr;
  }
  *len = L->current.size();
  return L->current.data();
}

// Returns the number of per-file errors seen so far; copies the first
// error message (NUL-terminated, truncated to buflen) into buf.
int loader_error(void* handle, char* buf, int buflen) {
  Loader* L = static_cast<Loader*>(handle);
  std::lock_guard<std::mutex> lk(L->err_mu);
  if (buf && buflen > 0) {
    int n = (int)L->first_error.size();
    if (n > buflen - 1) n = buflen - 1;
    memcpy(buf, L->first_error.data(), n);
    buf[n] = '\0';
  }
  return L->error_count;
}

void loader_destroy(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  L->queue.close();
  for (auto& t : L->threads)
    if (t.joinable()) t.join();
  delete L;
}

}  // extern "C"
