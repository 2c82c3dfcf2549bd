// Pinned host-memory arena.
//
// Parity: paddle/fluid/memory/ (buddy allocator + pinned memory for the
// host staging path). The device allocator is PyTorch's; what the
// framework still owns is HOST staging memory for the input pipeline.
// This is a bump arena over mlock()ed pages: allocation is a pointer
// increment, reset() recycles the whole arena between steps, and pages
// never swap, so a copy to the card never faults.
//
// Exposed via ctypes (paddle_tpu_torch/memory.py::HostArena).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include <sys/mman.h>
#include <unistd.h>

namespace {

struct Chunk {
  uint8_t* base = nullptr;
  size_t size = 0;
  size_t used = 0;
  bool locked = false;
};

struct Arena {
  std::vector<Chunk> chunks;
  size_t chunk_bytes;
  size_t total_allocated = 0;   // bytes handed out since last reset
  size_t peak_allocated = 0;
  std::mutex mu;

  explicit Arena(size_t cb) : chunk_bytes(cb) {}
};

bool add_chunk(Arena* a, size_t at_least) {
  size_t page = (size_t)sysconf(_SC_PAGESIZE);
  size_t size = a->chunk_bytes;
  if (size < at_least) size = at_least;
  size = (size + page - 1) / page * page;
  void* p = mmap(nullptr, size, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (p == MAP_FAILED) return false;
  Chunk c;
  c.base = static_cast<uint8_t*>(p);
  c.size = size;
  // Pin: best effort — unprivileged RLIMIT_MEMLOCK may be small; the
  // arena still works unpinned (just loses the no-page-fault guarantee).
  c.locked = mlock(p, size) == 0;
  a->chunks.push_back(c);
  return true;
}

}  // namespace

extern "C" {

void* arena_create(uint64_t chunk_bytes) {
  Arena* a = new Arena(chunk_bytes ? chunk_bytes : (8u << 20));
  if (!add_chunk(a, 0)) {
    delete a;
    return nullptr;
  }
  return a;
}

// Bump-allocate `size` bytes aligned to `align` (power of two; 0 -> 64).
void* arena_alloc(void* handle, uint64_t size, uint64_t align) {
  Arena* a = static_cast<Arena*>(handle);
  if (align == 0) align = 64;
  std::lock_guard<std::mutex> lk(a->mu);
  // first chunk with room — after a reset() earlier chunks refill too
  Chunk* c = nullptr;
  size_t off = 0;
  for (auto& cand : a->chunks) {
    off = (cand.used + align - 1) & ~(align - 1);
    if (off + size <= cand.size) {
      c = &cand;
      break;
    }
  }
  if (c == nullptr) {
    if (!add_chunk(a, size + align)) return nullptr;
    c = &a->chunks.back();
    off = 0;
  }
  c->used = off + size;
  a->total_allocated += size;
  if (a->total_allocated > a->peak_allocated)
    a->peak_allocated = a->total_allocated;
  return c->base + off;
}

// Recycle everything allocated so far (buffers become invalid).
void arena_reset(void* handle) {
  Arena* a = static_cast<Arena*>(handle);
  std::lock_guard<std::mutex> lk(a->mu);
  for (auto& c : a->chunks) c.used = 0;
  a->total_allocated = 0;
}

// allocated/peak/capacity in bytes; returns number of chunks. `pinned`
// gets 1 iff every chunk is mlock()ed.
int arena_stats(void* handle, uint64_t* allocated, uint64_t* peak,
                uint64_t* capacity, int* pinned) {
  Arena* a = static_cast<Arena*>(handle);
  std::lock_guard<std::mutex> lk(a->mu);
  uint64_t cap = 0;
  int all_locked = 1;
  for (auto& c : a->chunks) {
    cap += c.size;
    if (!c.locked) all_locked = 0;
  }
  if (allocated) *allocated = a->total_allocated;
  if (peak) *peak = a->peak_allocated;
  if (capacity) *capacity = cap;
  if (pinned) *pinned = all_locked;
  return (int)a->chunks.size();
}

void arena_destroy(void* handle) {
  Arena* a = static_cast<Arena*>(handle);
  for (auto& c : a->chunks) {
    if (c.locked) munlock(c.base, c.size);
    munmap(c.base, c.size);
  }
  delete a;
}

}  // extern "C"
