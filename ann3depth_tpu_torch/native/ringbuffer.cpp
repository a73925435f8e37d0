// Lock-free SPSC frame ring buffer — the native runtime piece of the live
// path (SURVEY.md §5 "Race detection", §7.2 M6, [B:10]).
//
// Single producer (camera capture thread) / single consumer (TPU inference
// loop) with latest-frame semantics: the producer never blocks (overwrites
// the oldest slot), the consumer takes the newest complete frame and
// reports how many frames were dropped since its last read. Torn reads are
// prevented seqlock-style: each slot carries a sequence counter that is odd
// while the producer is writing; the consumer validates the counter before
// and after its copy and retries on mismatch.
//
// Built as a plain C ABI shared library consumed via ctypes
// (ann3depth_tpu/live/ring_buffer.py). No dependencies beyond libstdc++.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct Slot {
  std::atomic<uint64_t> seq{0};  // even: stable; odd: write in progress
  uint64_t frame_id = 0;         // producer's monotonic frame counter
  // frame bytes follow the slot array in one contiguous allocation
};

struct Ring {
  uint32_t capacity;
  uint64_t frame_bytes;
  std::atomic<uint64_t> head{0};     // frames pushed so far
  std::atomic<uint64_t> popped{0};   // frames consumed
  std::atomic<uint64_t> dropped{0};  // frames overwritten unread
  uint64_t last_read_id = 0;         // consumer-local (SPSC: no atomics)
  Slot* slots;
  uint8_t* data;

  uint8_t* frame_ptr(uint32_t i) { return data + i * frame_bytes; }
};

}  // namespace

extern "C" {

Ring* rb_create(uint32_t capacity, uint64_t frame_bytes) {
  if (capacity < 2 || frame_bytes == 0) return nullptr;
  Ring* r = new (std::nothrow) Ring();
  if (!r) return nullptr;
  r->capacity = capacity;
  r->frame_bytes = frame_bytes;
  r->slots = new (std::nothrow) Slot[capacity];
  r->data = new (std::nothrow) uint8_t[capacity * frame_bytes];
  if (!r->slots || !r->data) {
    delete[] r->slots;
    delete[] r->data;
    delete r;
    return nullptr;
  }
  return r;
}

void rb_destroy(Ring* r) {
  if (!r) return;
  delete[] r->slots;
  delete[] r->data;
  delete r;
}

// Producer: copy one frame in. Never blocks; returns the frame id.
uint64_t rb_push(Ring* r, const uint8_t* frame) {
  const uint64_t h = r->head.load(std::memory_order_relaxed);
  const uint32_t i = static_cast<uint32_t>(h % r->capacity);
  Slot& s = r->slots[i];
  s.seq.fetch_add(1, std::memory_order_acq_rel);  // -> odd: writing
  std::memcpy(r->frame_ptr(i), frame, r->frame_bytes);
  s.frame_id = h;
  s.seq.fetch_add(1, std::memory_order_release);  // -> even: stable
  r->head.store(h + 1, std::memory_order_release);
  return h;
}

// Consumer: copy out the newest complete frame.
// Returns frame id >= 0, or -1 if no frame is available yet.
// Updates *dropped_out with frames skipped since the previous pop.
int64_t rb_pop_latest(Ring* r, uint8_t* out, uint64_t* dropped_out) {
  for (int attempt = 0; attempt < 64; ++attempt) {
    const uint64_t h = r->head.load(std::memory_order_acquire);
    if (h == 0) return -1;
    // newest slot first; under producer pressure fall back one slot
    for (uint64_t k = 0; k < 2 && k < h; ++k) {
      const uint64_t id = h - 1 - k;
      const uint32_t i = static_cast<uint32_t>(id % r->capacity);
      Slot& s = r->slots[i];
      const uint64_t s1 = s.seq.load(std::memory_order_acquire);
      if (s1 & 1) continue;  // write in progress
      std::memcpy(out, r->frame_ptr(i), r->frame_bytes);
      const uint64_t fid = s.frame_id;
      std::atomic_thread_fence(std::memory_order_acquire);
      const uint64_t s2 = s.seq.load(std::memory_order_acquire);
      if (s1 == s2 && fid == id) {
        uint64_t drops = 0;
        if (r->popped.load(std::memory_order_relaxed) > 0 &&
            id > r->last_read_id + 1) {
          drops = id - r->last_read_id - 1;
          r->dropped.fetch_add(drops, std::memory_order_relaxed);
        }
        r->last_read_id = id;
        r->popped.fetch_add(1, std::memory_order_relaxed);
        if (dropped_out) *dropped_out = drops;
        return static_cast<int64_t>(id);
      }
      // torn: producer lapped us mid-copy; retry
    }
  }
  return -1;  // pathological contention; caller treats as "no frame"
}

uint64_t rb_pushed(Ring* r) { return r->head.load(std::memory_order_acquire); }
uint64_t rb_popped(Ring* r) { return r->popped.load(std::memory_order_relaxed); }
uint64_t rb_dropped(Ring* r) { return r->dropped.load(std::memory_order_relaxed); }

}  // extern "C"
