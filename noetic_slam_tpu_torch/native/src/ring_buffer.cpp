// Thread-safe fixed-slot byte ring buffer — the ingest backpressure
// mechanism (behavioral equivalent of the reference driver's
// ThreadSafeRingBuffer, src/ouster/src/thread_safe_ring_buffer.h:18-146:
// blocking read/write, overwrite-on-full write, timed read). Exposed with a
// C ABI for ctypes.
//
// Design notes (not a translation): one mutex + two condvars, slots of a
// fixed item size; handles are opaque pointers owned by the caller.

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct RingBuffer {
    explicit RingBuffer(size_t item_size, size_t capacity)
        : item_size(item_size),
          capacity(capacity),
          data(item_size * capacity) {}

    size_t item_size;
    size_t capacity;
    std::vector<uint8_t> data;
    size_t head = 0;  // next write slot
    size_t tail = 0;  // next read slot
    size_t count = 0;
    std::mutex mtx;
    std::condition_variable not_full;
    std::condition_variable not_empty;

    uint8_t* slot(size_t idx) { return data.data() + idx * item_size; }
};

}  // namespace

extern "C" {

void* nst_ring_create(size_t item_size, size_t capacity) {
    return new RingBuffer(item_size, capacity);
}

void nst_ring_destroy(void* rb) { delete static_cast<RingBuffer*>(rb); }

size_t nst_ring_size(void* rbp) {
    auto* rb = static_cast<RingBuffer*>(rbp);
    std::lock_guard<std::mutex> lk(rb->mtx);
    return rb->count;
}

// Blocking write; returns 0 on success.
int nst_ring_write(void* rbp, const uint8_t* item) {
    auto* rb = static_cast<RingBuffer*>(rbp);
    std::unique_lock<std::mutex> lk(rb->mtx);
    rb->not_full.wait(lk, [rb] { return rb->count < rb->capacity; });
    std::memcpy(rb->slot(rb->head), item, rb->item_size);
    rb->head = (rb->head + 1) % rb->capacity;
    ++rb->count;
    rb->not_empty.notify_one();
    return 0;
}

// Overwrite-oldest write (never blocks) — the live-sensor policy
// (write_overwrite in the reference driver). Returns 1 if an item was
// dropped.
int nst_ring_write_overwrite(void* rbp, const uint8_t* item) {
    auto* rb = static_cast<RingBuffer*>(rbp);
    std::unique_lock<std::mutex> lk(rb->mtx);
    int dropped = 0;
    if (rb->count == rb->capacity) {
        rb->tail = (rb->tail + 1) % rb->capacity;
        --rb->count;
        dropped = 1;
    }
    std::memcpy(rb->slot(rb->head), item, rb->item_size);
    rb->head = (rb->head + 1) % rb->capacity;
    ++rb->count;
    rb->not_empty.notify_one();
    return dropped;
}

// Read with timeout in milliseconds (-1 = block forever). Returns 0 on
// success, 1 on timeout.
int nst_ring_read(void* rbp, uint8_t* out, long timeout_ms) {
    auto* rb = static_cast<RingBuffer*>(rbp);
    std::unique_lock<std::mutex> lk(rb->mtx);
    auto ready = [rb] { return rb->count > 0; };
    if (timeout_ms < 0) {
        rb->not_empty.wait(lk, ready);
    } else if (!rb->not_empty.wait_for(
                   lk, std::chrono::milliseconds(timeout_ms), ready)) {
        return 1;
    }
    std::memcpy(out, rb->slot(rb->tail), rb->item_size);
    rb->tail = (rb->tail + 1) % rb->capacity;
    --rb->count;
    rb->not_full.notify_one();
    return 0;
}

}  // extern "C"
