// Async IQ sample sink: lock-free ring buffer + writer thread.
//
// Plays the role the downstream half of the reference flowgraph plays
// (blocks_multiply_const_xx gain + uhd_usrp_sink streaming to hardware,
// apps/vv009-4kshort.grc): the transmit loop hands off float32-interleaved
// IQ windows and returns immediately; a consumer thread applies the scalar
// gain and streams the samples to a file descriptor in large writes, so
// host IO overlaps the next device step.  Single-producer/single-consumer,
// C++11 atomics, no locks on the hot path - the same discipline as the
// GNU Radio single-writer circular buffers the reference relies on.
//
// Plain C ABI for ctypes.

#include <atomic>
#include <cerrno>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <thread>

#include <fcntl.h>
#include <unistd.h>

namespace {

struct Sink {
  float* buf;                  // ring of float32 samples
  uint64_t capacity;           // floats, power of two
  std::atomic<uint64_t> head;  // produced (floats)
  std::atomic<uint64_t> tail;  // written out (floats)
  std::atomic<int> stop;
  int fd;
  int own_fd;
  float gain;
  std::atomic<uint64_t> floats_out;
  std::atomic<uint64_t> producer_stalls;
  std::thread writer;
  float* staging;              // writer-side gain-applied chunk
  uint64_t staging_floats;
};

uint64_t next_pow2(uint64_t v) {
  uint64_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

void writer_loop(Sink* s) {
  int idle = 0;
  for (;;) {
    uint64_t head = s->head.load(std::memory_order_acquire);
    uint64_t tail = s->tail.load(std::memory_order_acquire);
    if (head == tail) {
      if (s->stop.load(std::memory_order_acquire)) break;
      // back off to a short sleep after a burst of empty polls so an idle
      // sink does not pin a core (the common case: IO faster than compute)
      if (++idle > 64)
        std::this_thread::sleep_for(std::chrono::microseconds(100));
      else
        std::this_thread::yield();
      continue;
    }
    idle = 0;
    uint64_t n = head - tail;
    if (n > s->staging_floats) n = s->staging_floats;
    uint64_t pos = tail & (s->capacity - 1);
    uint64_t first = s->capacity - pos;
    if (n > first) n = first;  // contiguous run only; wrap next iteration
    const float g = s->gain;
    if (g == 1.0f) {
      memcpy(s->staging, s->buf + pos, n * sizeof(float));
    } else {
      const float* src = s->buf + pos;
      for (uint64_t i = 0; i < n; i++) s->staging[i] = src[i] * g;
    }
    // byte-accurate write loop: short writes need not be float-aligned,
    // and EINTR is a retry, not an error
    uint64_t total = n * sizeof(float);
    uint64_t done = 0;
    while (done < total) {
      ssize_t w = write(s->fd, reinterpret_cast<char*>(s->staging) + done,
                        total - done);
      if (w < 0) {
        if (errno == EINTR) continue;
        s->stop.store(2, std::memory_order_release);
        return;
      }
      done += static_cast<uint64_t>(w);
    }
    s->tail.store(tail + n, std::memory_order_release);
    s->floats_out.fetch_add(n, std::memory_order_relaxed);
  }
}

}  // namespace

extern "C" {

// ring_floats is rounded up to a power of two.  fd < 0 opens `path`.
void* iq_sink_create(const char* path, int fd, uint64_t ring_floats,
                     float gain) {
  if (fd < 0 && path == nullptr) return nullptr;  // nothing to write to
  Sink* s = new Sink();
  s->capacity = next_pow2(ring_floats < 1024 ? 1024 : ring_floats);
  s->buf = static_cast<float*>(malloc(s->capacity * sizeof(float)));
  s->staging_floats = 1u << 20;  // 4 MB writes
  s->staging = static_cast<float*>(malloc(s->staging_floats * sizeof(float)));
  if (!s->buf || !s->staging) { free(s->buf); free(s->staging); delete s; return nullptr; }
  s->head = 0; s->tail = 0; s->stop = 0;
  s->gain = gain;
  s->floats_out = 0; s->producer_stalls = 0;
  if (fd >= 0) { s->fd = fd; s->own_fd = 0; }
  else {
    s->fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (s->fd < 0) { free(s->buf); free(s->staging); delete s; return nullptr; }
    s->own_fd = 1;
  }
  s->writer = std::thread(writer_loop, s);
  return s;
}

// Enqueue n float32 samples (blocks only when the ring is full; counts
// those stalls).  Returns 0, or -1 after a write error.
int iq_sink_write(void* h, const float* data, uint64_t n) {
  Sink* s = static_cast<Sink*>(h);
  uint64_t written = 0;
  while (written < n) {
    if (s->stop.load(std::memory_order_acquire) == 2) return -1;
    uint64_t head = s->head.load(std::memory_order_relaxed);
    uint64_t tail = s->tail.load(std::memory_order_acquire);
    uint64_t free_f = s->capacity - (head - tail);
    if (free_f == 0) {
      s->producer_stalls.fetch_add(1, std::memory_order_relaxed);
      std::this_thread::sleep_for(std::chrono::microseconds(50));
      continue;
    }
    uint64_t take = n - written;
    if (take > free_f) take = free_f;
    uint64_t pos = head & (s->capacity - 1);
    uint64_t first = s->capacity - pos;
    uint64_t c = take < first ? take : first;
    memcpy(s->buf + pos, data + written, c * sizeof(float));
    if (take > c)
      memcpy(s->buf, data + written + c, (take - c) * sizeof(float));
    s->head.store(head + take, std::memory_order_release);
    written += take;
  }
  return 0;
}

// Block until everything queued so far has hit the fd.
int iq_sink_flush(void* h) {
  Sink* s = static_cast<Sink*>(h);
  uint64_t target = s->head.load(std::memory_order_acquire);
  while (s->tail.load(std::memory_order_acquire) < target) {
    if (s->stop.load(std::memory_order_acquire) == 2) return -1;
    std::this_thread::sleep_for(std::chrono::microseconds(50));
  }
  return 0;
}

uint64_t iq_sink_floats_written(void* h) {
  return static_cast<Sink*>(h)->floats_out.load(std::memory_order_relaxed);
}

uint64_t iq_sink_stalls(void* h) {
  return static_cast<Sink*>(h)->producer_stalls.load(std::memory_order_relaxed);
}

// Drains, closes, frees.  Returns 0, or -1 if the writer hit a write
// error (the remaining queued samples were dropped and the output file is
// truncated) - callers must check.
int iq_sink_destroy(void* h) {
  Sink* s = static_cast<Sink*>(h);
  if (s->stop.load(std::memory_order_acquire) != 2)
    s->stop.store(1, std::memory_order_release);
  s->writer.join();
  int rc = s->stop.load(std::memory_order_acquire) == 2 ? -1 : 0;
  if (s->own_fd) close(s->fd);
  free(s->buf);
  free(s->staging);
  delete s;
  return rc;
}

}  // extern "C"
