// TS ingest runtime: lock-free ring buffer + MPEG-TS framing for the
// transmit chain.
//
// Plays the role the GNU Radio runtime plays for the reference module
// (thread-per-block pipeline + ring buffers + the ule_ule_source TS input
// of apps/vv009-4kshort.grc): a producer thread reads an arbitrary TS
// byte source (file / fd / pipe), aligns to 0x47 sync, re-syncs on
// corruption, stuffs null packets on underrun to hold real-time rate, and
// hands the consumer exact step-sized windows including the 187-byte
// carry the BB-frame CRC replacement needs (SURVEY.md section 3.3).
//
// Plain C ABI for ctypes; single-producer/single-consumer, indices are
// C++11 atomics, no locks on the hot path (same discipline as GR's
// single-writer circular buffers).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr int kPacket = 188;
constexpr uint8_t kSync = 0x47;

struct Ring {
  uint8_t* buf;
  uint64_t capacity;   // bytes, power of two
  std::atomic<uint64_t> head;  // written
  std::atomic<uint64_t> tail;  // consumed
  // framing state (producer side)
  int fd;
  int sync_locked;
  uint64_t sync_errors;
  uint64_t packets_in;
  uint64_t null_stuffed;
  uint64_t bytes_out;
  uint8_t carry[kPacket - 1];  // last 187 bytes handed out
  uint8_t pending[kPacket];
  int pending_len;
  int eof;
};

uint64_t next_pow2(uint64_t v) {
  uint64_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

inline uint64_t ring_used(const Ring* r) {
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

inline uint64_t ring_free(const Ring* r) { return r->capacity - ring_used(r); }

void ring_write(Ring* r, const uint8_t* src, uint64_t n) {
  uint64_t h = r->head.load(std::memory_order_relaxed);
  uint64_t mask = r->capacity - 1;
  uint64_t off = h & mask;
  uint64_t first = n < (r->capacity - off) ? n : (r->capacity - off);
  std::memcpy(r->buf + off, src, first);
  if (n > first) std::memcpy(r->buf, src + first, n - first);
  r->head.store(h + n, std::memory_order_release);
}

void ring_read(Ring* r, uint8_t* dst, uint64_t n) {
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  uint64_t mask = r->capacity - 1;
  uint64_t off = t & mask;
  uint64_t first = n < (r->capacity - off) ? n : (r->capacity - off);
  std::memcpy(dst, r->buf + off, first);
  if (n > first) std::memcpy(dst + first, r->buf, n - first);
  r->tail.store(t + n, std::memory_order_release);
}

const uint8_t kNullPacket[kPacket] = {
    0x47, 0x1F, 0xFF, 0x10,  // sync, PID 0x1FFF, no AF, CC 0
};

}  // namespace

extern "C" {

// Create an ingest ring with at least `capacity` bytes of buffer, fed from
// file descriptor `fd` (or -1 for a pure null-packet generator).
void* ts_ingest_create(uint64_t capacity, int fd) {
  Ring* r = new Ring();
  r->capacity = next_pow2(capacity < 4096 ? 4096 : capacity);
  r->buf = static_cast<uint8_t*>(std::malloc(r->capacity));
  if (!r->buf) { delete r; return nullptr; }
  r->head.store(0); r->tail.store(0);
  r->fd = fd;
  r->sync_locked = 0;
  r->sync_errors = 0;
  r->packets_in = 0;
  r->null_stuffed = 0;
  r->bytes_out = 0;
  r->pending_len = 0;
  r->eof = 0;
  std::memset(r->carry, 0, sizeof r->carry);
  return r;
}

void ts_ingest_destroy(void* h) {
  Ring* r = static_cast<Ring*>(h);
  if (!r) return;
  std::free(r->buf);
  delete r;
}

// Producer: pull up to `budget` bytes from the fd, align to packet
// boundaries (resync by scanning for 0x47 with 188-spacing confirmation),
// push whole packets into the ring.  Returns packets pushed, -1 on EOF
// with nothing pushed.  Call from the ingest thread.
int64_t ts_ingest_pump(void* h, uint64_t budget) {
  Ring* r = static_cast<Ring*>(h);
  if (r->fd < 0) return 0;
  uint8_t chunk[64 * kPacket];
  int64_t pushed = 0;
  while (budget > 0 && ring_free(r) >= kPacket) {
    uint64_t want = budget < sizeof chunk ? budget : sizeof chunk;
    // never read more than the ring can absorb: bytes written <=
    // pending_len + bytes read, so capping the read guarantees the
    // backpressure stash below can never fire mid-chunk.  (It used to:
    // the break discarded the chunk tail, losing stream bytes whenever
    // the ring filled — one spurious resync per ring-full event.)
    uint64_t space = ring_free(r) - static_cast<uint64_t>(r->pending_len);
    if (space == 0) break;
    if (want > space) want = space;
    ssize_t n = read(r->fd, chunk, want);
    if (n <= 0) { r->eof = 1; break; }
    budget -= static_cast<uint64_t>(n);
    uint64_t pos = 0;
    // stitch with pending partial packet
    while (pos < static_cast<uint64_t>(n)) {
      if (r->pending_len == 0 && chunk[pos] != kSync) {
        // sync loss: scan forward (reference logs "Malformed MPEG-TS"
        // and drops bytes, lib/bbheaderbch_bb_impl.cc:676,704)
        r->sync_errors++;
        r->sync_locked = 0;
        while (pos < static_cast<uint64_t>(n) && chunk[pos] != kSync) pos++;
        continue;
      }
      uint64_t take = kPacket - r->pending_len;
      uint64_t avail = static_cast<uint64_t>(n) - pos;
      if (take > avail) take = avail;
      std::memcpy(r->pending + r->pending_len, chunk + pos, take);
      r->pending_len += static_cast<int>(take);
      pos += take;
      if (r->pending_len == kPacket) {
        if (r->pending[0] == kSync) {
          if (ring_free(r) < kPacket) { /* backpressure: stash */ break; }
          ring_write(r, r->pending, kPacket);
          r->packets_in++;
          r->sync_locked = 1;
          pushed++;
        } else {
          r->sync_errors++;
          r->sync_locked = 0;
        }
        r->pending_len = 0;
      }
    }
  }
  if (pushed == 0 && r->eof) return -1;
  return pushed;
}

// Consumer: fill `dst` with 187 carry bytes followed by `fresh` bytes of
// TS stream.  If the ring underruns, stuff null packets (PID 0x1FFF) to
// keep the modulator fed at real-time rate; `allow_stuffing`=0 instead
// returns 0 without filling.  Returns 1 on success.
int ts_ingest_window(void* h, uint8_t* dst, uint64_t fresh,
                     int allow_stuffing) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t used = ring_used(r);
  uint64_t whole = (used / kPacket) * kPacket;
  if (whole < fresh && !allow_stuffing) return 0;

  std::memcpy(dst, r->carry, kPacket - 1);
  uint8_t* out = dst + (kPacket - 1);
  uint64_t take = whole < fresh ? whole : fresh;
  ring_read(r, out, take);
  uint64_t left = fresh - take;
  uint8_t* p = out + take;
  while (left > 0) {  // underrun: null stuffing
    uint64_t k = left < kPacket ? left : kPacket;
    std::memcpy(p, kNullPacket, k);
    p += k;
    left -= k;
    r->null_stuffed++;
  }
  std::memcpy(r->carry, out + fresh - (kPacket - 1), kPacket - 1);
  r->bytes_out += fresh;
  return 1;
}

uint64_t ts_ingest_available(void* h) {
  return ring_used(static_cast<Ring*>(h));
}

void ts_ingest_stats(void* h, uint64_t* out4) {
  Ring* r = static_cast<Ring*>(h);
  out4[0] = r->packets_in;
  out4[1] = r->sync_errors;
  out4[2] = r->null_stuffed;
  out4[3] = r->bytes_out;
}

int ts_ingest_eof(void* h) { return static_cast<Ring*>(h)->eof; }

}  // extern "C"
