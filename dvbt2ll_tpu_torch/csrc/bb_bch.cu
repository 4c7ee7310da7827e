// BB framing, packet CRC-8, scrambling and BCH of DVB-T2 (EN 302 755
// sections 5.1 and 6.1) for Hopper: TS windows in, each FEC frame's nbch
// bits out as bytes of 0/1, the kbch scrambled BB-frame bits and then the
// BCH parity, in the (frames, nbch) layout the LDPC kernel reads.
//
// Replaces no TPU kernel: the JAX package builds this stage from XLA ops,
// its CRC-8 and BCH as GF(2) matrix products, which the TPU's matrix unit
// makes nearly free.  The reference binary does the stage in one block,
// bbheaderbch_bb (lib/bbheaderbch_bb_impl.cc:424-531), its BCH a
// byte-serial LFSR; this kernel does the same on packed bytes.
//
// Math.  Frame u of block k takes 10 header bytes, then d = kbch / 8 - 10
// data-field bytes from the block's fresh stream at s (d - 13 and the
// 13-byte in-band field for the first frame of each fec_blocks group with
// in-band signalling; s counts those 13 bytes out).  Fresh stream byte j
// is window byte 187 + j; in NORMAL mode a sync slot (j = o + 188 i,
// i < packets, o the plan's sync offset) carries instead the CRC-8 of
// window bytes j .. j + 186, the packet before it (the carry for i = 0);
// HIEFF drops every packet's sync byte, so stream byte j is window byte
// 187 + 188 (j / 187) + 1 + j % 187.  The kbch / 8 bytes are XORed with
// the scrambler.  The BCH parity is the remainder r(x) of
// m(x) x^npar mod g(x), npar = nbch - kbch, in transmit order from the
// x^(npar - 1) coefficient down.
//
// What bounds it on the card.  Its bytes: a vv009 step of BASELINE
// config 5 reads 9.3 MB of windows and writes 75.8 MB of bits (6016
// frames), 0.025 ms at 3.35 TB/s.  Its arithmetic is two walks, serial
// within a frame: the CRC-8 over 187 bytes a packet, the BCH over kbch
// bits a frame (389 32-bit steps for a short frame, 1683 for a normal
// one).  The walks' latency, not the bytes, sets a block's time: timed on
// an H100 with phases cut out, a lone block of 16 short frames took
// 0.054 ms, 0.032 of it the BCH walk of nibble tables (eight lookups a
// step) and 0.006 the byte-serial CRC; config 5 took 0.097 ms, its stores
// 0.023 of that.
//
// Design: one block of 256 threads for 16 frames (a vv009 step of 6016
// frames is 376 blocks, about 3 a SM, all resident).
// 1. All threads build the 16 frames' scrambled bytes in shared memory,
//    a frame a row of whole 32-bit words: the row starts with
//    (-kbch / 8) mod 4 zero bytes, which leave a remainder that starts at
//    0 unchanged, and rows are an odd number of words apart, so the 16
//    walkers of step 3 read 16 distinct banks.  The frames' data fields
//    are read as aligned 16-byte lines, eight loads in flight a thread,
//    each byte scattered to its place (one byte a load, a load's latency
//    an iteration, took 0.03 ms longer at config 5).
// 2. A thread a sync slot computes its CRC-8 from the window (read-only
//    cache), four bytes a step with four 256-byte tables in shared memory
//    (slicing by 4: 47 dependent lookups, not 187), and puts it,
//    scrambled, in place of the sync byte.
// 3. Sixteen lanes of the first warp walk the BCH, a frame a lane, 32
//    message bits a step, the remainder left-aligned in six registers:
//    the register shifted up a word, XOR four table entries, one for each
//    byte of the message word XOR the register's top word.  An entry's 24
//    bytes are three 8-byte loads; the four tables take 24 KB.  Chosen
//    over nibble tables (eight lookups a step, 3 KB, free of bank
//    conflicts): a walker's step is issue-bound, so half the loads beat
//    the conflicts (with the 4-byte CRC, config 5 0.097 -> 0.085 ms, a lone
//    block 0.054 -> 0.043, 8k_normal's 512 frames 0.175 -> 0.136).  Over
//    more frames a block (32: a whole warp of walkers): slower, since a
//    block's staging and CRC grow with it (config 5 0.142 ms).  Meanwhile
//    the other seven warps spread the frames' bytes to bits and write them
//    with coalesced 8-byte stores.  Each walker then writes its frame's
//    parity.
//
// Input: windows (blocks, window) u8 contiguous; headers (frames, 10),
// scrambler (kbch / 8), in-band field (13, or null) u8; the CRC-8 tables
// (4, 256) u8 (ops/fec.py::crc8_tables); the BCH step tables
// (4, 3, 256, 2) u32 (ops/fec.py::bch_step_tables).

#include <cstdint>

#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 16;           // FEC frames a block, a walker each
constexpr int kTableWords = 4 * 3 * 256 * 2;  // BCH tables, 24 KB
constexpr int kCrcBytes = 4 * 256;            // CRC-8 tables, 1 KB
constexpr int kCrcSpan = 187;
constexpr int kHeader = 10;           // BB header bytes
constexpr int kInband = 13;           // in-band type B field bytes
constexpr int kLoads = 8;             // 16-byte loads in flight a thread

// 8 bits MSB first -> 8 bytes of 0/1, byte j = bit 7 - j.  After the
// bit reversal, v * 0x00204081 moves bit k of a nibble to bit 8 k.
__device__ __forceinline__ uint2 unpack_msb(uint32_t byte) {
  const uint32_t b = __brev(byte) >> 24;
  return make_uint2((b & 0xfu) * 0x00204081u & 0x01010101u,
                    (b >> 4) * 0x00204081u & 0x01010101u);
}

// The window index of fresh-stream byte j: HIEFF drops each packet's sync
// byte, so its stream is the packets' 187-byte bodies.
__device__ __forceinline__ int window_index(int j, int hieff) {
  return kCrcSpan + (hieff ? j / 187 * 188 + 1 + j % 187 : j);
}

// Frame `loc` of a block: where its data field starts in the block's
// fresh stream, and how many stream bytes it takes.
__device__ __forceinline__ void frame_span(int loc, int d, int group,
                                           int* start, int* len) {
  if (group == 0) {
    *start = loc * d;
    *len = d;
    return;
  }
  const int g = loc / group, m = loc - g * group;
  *start = loc * d - kInband * g - (m ? kInband : 0);
  *len = m ? d : d - kInband;
}

__global__ void __launch_bounds__(kThreads, 4)
bb_bch_kernel(const uint8_t* __restrict__ ts, uint8_t* __restrict__ out,
              const uint8_t* __restrict__ headers,
              const uint8_t* __restrict__ scramble,
              const uint8_t* __restrict__ inband,
              const uint8_t* __restrict__ crc_tab,
              const uint2* __restrict__ bch_tab, int total, int window,
              int frames, int packets, int sync_offset, int hieff,
              int group, int kbch, int nbch) {
  // shared memory: the BCH tables, the CRC tables, then a row of
  // `stride` words a frame
  extern __shared__ uint2 smem8[];
  uint2* s_bch = smem8;
  uint8_t* s_crc = reinterpret_cast<uint8_t*>(smem8 + kTableWords / 2);
  uint32_t* s_msg = reinterpret_cast<uint32_t*>(s_crc + kCrcBytes);
  uint8_t* msg_b = reinterpret_cast<uint8_t*>(s_msg);
  const int tid = threadIdx.x;
  const int kb = kbch / 8;
  const int pad = -kb & 3;
  const int nwords = (kb + pad) / 4;
  const int stride = nwords | 1;
  const int d = kb - kHeader;
  const int f0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, total - f0);

  // each frame's data field: its block's window row, the stream bytes it
  // takes [s, s + len), and the 16-byte lines of the row that hold them
  __shared__ const uint4* s_line0[kFrames];
  __shared__ int s_x0[kFrames], s_start[kFrames], s_len[kFrames],
      s_loc[kFrames], s_pre[kFrames + 1];
  if (tid < nf) {
    const int fi = f0 + tid, blk = fi / frames, loc = fi - blk * frames;
    int s, len;
    frame_span(loc, d, group, &s, &len);
    const uint8_t* row = ts + static_cast<size_t>(blk) * window;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(
        row + window_index(s, hieff)) & ~uintptr_t{15};
    const uintptr_t hi = reinterpret_cast<uintptr_t>(
        row + window_index(s + len - 1, hieff) + 16) & ~uintptr_t{15};
    s_line0[tid] = reinterpret_cast<const uint4*>(lo);
    s_x0[tid] = static_cast<int>(lo - reinterpret_cast<uintptr_t>(row));
    s_start[tid] = s;
    s_len[tid] = len;
    s_loc[tid] = loc;
    s_pre[tid + 1] = static_cast<int>(hi - lo) / 16;
  }
  for (int i = tid; i < kTableWords / 2; i += kThreads) {
    s_bch[i] = bch_tab[i];
  }
  for (int i = tid; i < kCrcBytes; i += kThreads) s_crc[i] = crc_tab[i];
  for (int i = tid; i < kFrames * pad; i += kThreads) {
    msg_b[i / pad * stride * 4 + i % pad] = 0;
  }
  __syncthreads();
  if (tid == 0) {
    s_pre[0] = 0;
    for (int u = 0; u < nf; ++u) s_pre[u + 1] += s_pre[u];
  }
  __syncthreads();

  // 1. the frames' bytes, scrambled, sync bytes as they come: the lines
  // of every frame, kLoads a thread in flight, each byte scattered to its
  // place; then the headers and in-band fields
  const int lines = s_pre[nf];
  for (int t0 = tid; t0 < lines; t0 += kLoads * kThreads) {
    uint4 v[kLoads];
    int fu[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int t = t0 + k * kThreads;
      if (t < lines) {
        int u = 0;
#pragma unroll
        for (int step = kFrames / 2; step > 0; step >>= 1) {
          if (u + step < nf && s_pre[u + step] <= t) u += step;
        }
        fu[k] = u;
        v[k] = __ldg(s_line0[u] + (t - s_pre[u]));
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int t = t0 + k * kThreads;
      if (t < lines) {
        const int u = fu[k], s = s_start[u], len = s_len[u];
        // y: the fresh-stream index of the line's first byte
        const int y0 = s_x0[u] + 16 * (t - s_pre[u]) - kCrcSpan;
        // message byte kHeader + j - s of frame u, for stream byte j
        const int at = u * stride * 4 + pad + kHeader - s;
        const uint32_t w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          int j = y0 + i;
          if (hieff) {  // drop the sync bytes
            const int c = j % 188;
            j = j < 0 || c == 0 ? -1 : j / 188 * 187 + c - 1;
          }
          if (j >= s && j < s + len) {
            msg_b[at + j] = static_cast<uint8_t>(
                (w[i / 4] >> 8 * (i % 4)) ^ __ldg(scramble + kHeader + j - s));
          }
        }
      }
    }
  }
  for (int i = tid; i < nf * (kHeader + kInband); i += kThreads) {
    const int u = i / (kHeader + kInband), k = i - u * (kHeader + kInband);
    uint8_t* m = msg_b + u * stride * 4 + pad;
    if (k < kHeader) {
      m[k] = headers[s_loc[u] * kHeader + k] ^ scramble[k];
    } else if (s_len[u] < d) {  // the first frame of an in-band group
      const int b = s_len[u] + k;  // after its kHeader + len bytes
      m[b] = inband[k - kHeader] ^ scramble[b];
    }
  }
  __syncthreads();

  // 2. NORMAL mode: each sync slot's CRC-8, a thread a slot
  if (!hieff && packets > 0) {
    const int per = (d + 187) / 188;  // slots a data field can hold
    for (int t = tid; t < nf * per; t += kThreads) {
      const int u = t / per, s = s_start[u], len = s_len[u];
      const int i0 = s <= sync_offset ? 0 : (s - sync_offset + 187) / 188;
      const int i = i0 + t - u * per;
      const int j = sync_offset + 188 * i;
      if (i >= packets || j >= s + len) continue;
      const uint8_t* p =
          ts + static_cast<size_t>((f0 + u) / frames) * window + j;
      // four bytes a step: crc' = T3[crc ^ b0] ^ T2[b1] ^ T1[b2] ^ T0[b3]
      uint32_t crc = 0;
      int k = 0;
#pragma unroll 4
      for (; k + 4 <= kCrcSpan; k += 4) {
        crc = s_crc[768 + (crc ^ __ldg(p + k))] ^
              s_crc[512 + __ldg(p + k + 1)] ^
              s_crc[256 + __ldg(p + k + 2)] ^ s_crc[__ldg(p + k + 3)];
      }
      for (; k < kCrcSpan; ++k) crc = s_crc[crc ^ __ldg(p + k)];
      const int b = kHeader + j - s;
      msg_b[u * stride * 4 + pad + b] =
          static_cast<uint8_t>(crc ^ scramble[b]);
    }
  }
  __syncthreads();

  if (tid < 32) {
    // 3. the BCH walk, a frame a lane
    if (tid < nf) {
      const uint32_t* m = s_msg + tid * stride;
      uint32_t r0 = 0, r1 = 0, r2 = 0, r3 = 0, r4 = 0, r5 = 0;
      for (int j = 0; j < nwords; ++j) {
        const uint32_t v = r5 ^ __byte_perm(m[j], 0, 0x0123);
        r5 = r4;
        r4 = r3;
        r3 = r2;
        r2 = r1;
        r1 = r0;
        r0 = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint2* e = s_bch + q * 768 + (v >> 8 * q & 0xffu);
          const uint2 a = e[0], b = e[256], c = e[512];
          r0 ^= a.x;
          r1 ^= a.y;
          r2 ^= b.x;
          r3 ^= b.y;
          r4 ^= c.x;
          r5 ^= c.y;
        }
      }
      // the parity, x^(npar - 1) first: byte i is bits 191 - 8 i down
      const uint32_t r[6] = {r0, r1, r2, r3, r4, r5};
      uint2* dst = reinterpret_cast<uint2*>(
          out + static_cast<size_t>(f0 + tid) * nbch + kbch);
      const int nbytes = (nbch - kbch) / 8;
#pragma unroll
      for (int i = 0; i < 24; ++i) {
        if (i < nbytes) {
          dst[i] = unpack_msb(r[5 - i / 4] >> (24 - 8 * (i % 4)) & 0xffu);
        }
      }
    }
  } else {
    // ... while the other warps write the info bits, a byte a store
    for (int u = 0; u < nf; ++u) {
      const uint8_t* m = msg_b + u * stride * 4 + pad;
      uint2* dst = reinterpret_cast<uint2*>(
          out + static_cast<size_t>(f0 + u) * nbch);
      for (int b = tid - 32; b < kb; b += kThreads - 32) {
        dst[b] = unpack_msb(m[b]);
      }
    }
  }
}

}  // namespace

// ts (total / frames, window) and out (total, nbch), both uint8 and
// contiguous, out 8-byte aligned; kbch and nbch multiples of 8 with at
// most 192 parity bits; group = fec_blocks with in-band signalling, else
// 0 (inband may then be null).  `device` is the current device, which
// `stream` belongs to.  Returns cudaGetLastError() after the launch.
extern "C" int dvbt2ll_bb_bch(const void* ts, void* out, const void* headers,
                              const void* scramble, const void* inband,
                              const void* crc_tab, const void* bch_tab,
                              int total, int window, int frames, int packets,
                              int sync_offset, int hieff, int group,
                              int kbch, int nbch, int device, void* stream) {
  const int npar = nbch - kbch;
  if (total <= 0 || frames <= 0 || total % frames || kbch <= 8 * kHeader ||
      kbch % 8 || npar <= 0 || npar % 8 || npar > 192 || packets < 0 ||
      sync_offset < 0 || group < 0 || (group && inband == nullptr) ||
      window <= kCrcSpan) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kb = kbch / 8;
  const int stride = ((kb + (-kb & 3)) / 4) | 1;
  const int smem = 4 * kTableWords + kCrcBytes + 4 * kFrames * stride;
  // above 48 KB a launch is refused unless the kernel's limit is raised:
  // once a device, to all that a block may have (normal frames take
  // about 111 KB)
  static dvbt2ll::PerDevice<int> max_smem;
  int limit = 0;
  const cudaError_t err = max_smem.get(device, &limit, [](int dev,
                                                          int* lim) {
    int optin = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, bb_bch_kernel);
    if (e != cudaSuccess) return e;
    *lim = optin - static_cast<int>(attr.sharedSizeBytes);
    return cudaFuncSetAttribute(
        bb_bch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *lim);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (total + kFrames - 1) / kFrames;
  bb_bch_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ts), static_cast<uint8_t*>(out),
      static_cast<const uint8_t*>(headers),
      static_cast<const uint8_t*>(scramble),
      static_cast<const uint8_t*>(inband),
      static_cast<const uint8_t*>(crc_tab),
      static_cast<const uint2*>(bch_tab), total, window, frames, packets,
      sync_offset, hieff, group, kbch, nbch);
  return static_cast<int>(cudaGetLastError());
}
