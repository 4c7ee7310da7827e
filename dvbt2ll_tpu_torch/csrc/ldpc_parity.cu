// QC-LDPC encoding of DVB-T2 (EN 302 755 Annex A) codewords, for Hopper:
// the whole (frames, nldpc) codeword, the nbch info bits passed through and
// then the parity in natural order.
//
// Replaces the Pallas TPU kernel dvbt2ll_tpu/ops/ldpc_pallas.py, both its
// single-block form (_make_kernel, :33) and its row-grouped form for
// normal frames (_make_grouped_kernel, :84), and the concat of info bits
// and parity after it.  The two Pallas forms exist only because a
// normal-frame table overflows the TPU's VMEM; here one kernel takes any
// Annex-A table.
//
// Math (tables/ldpc.py::qc_entries): lay the parity out as a (360, q)
// accumulator, parity bit p = m * q + c.  Schedule entry (group g, roll s)
// of column c XORs info group g rolled by s into column c:
//   acc[m][c] ^= bits[g * 360 + (m - s) mod 360].
// The chain p[j] ^= p[j - 1] then factors into an inclusive XOR prefix
// along each row (over c) plus an exclusive XOR scan of the row totals
// over the 360 rows, applied to every column.
//
// What bounds it on the card: bytes, one per bit: nbch read and nldpc
// written a frame (25.8 MB in and 33.2 MB out for a vv009 batch-256 step
// of 2048 frames).  With a byte a bit and a thread a row, the schedule
// walk is 360 x E reads a frame (E = 85 to 648 entries), instruction work
// far above those bytes' time; 32 rows a word cut it 32 times.
//
// Design: bit-sliced, one block a frame (128 threads, or 256 where the
// step's frames are too few to fill the card), the frames resident at once.
// 1. The frame's bytes are read with coalesced 8-byte loads and packed 8
//    bits a byte into shared memory: each 360-bit group in 13 words, its
//    first 56 bits repeated after bit 360, so that any 32 bits of a roll
//    are one funnel shift of two neighbouring words.
// 2. A quarter of the threads walk the schedule, each for 32 rows at once
//    (rows 32 t .. 32 t + 31) over a run of the columns: an entry is one
//    funnel shift and one XOR for 32 rows.  The running row prefix stays
//    in a register; each column's 32 bits go to shared memory.  Meanwhile
//    the other threads unpack the info bits from shared memory and write
//    them out as the codeword's head, so the walk hides behind stores.
// 3. The row totals' exclusive XOR scan is a prefix within each word
//    (five shifts) plus the parities of the words before it; each walker
//    then XORs the earlier runs' totals and the row flips into its words.
// 4. The parity words are spread to bytes in natural order in shared
//    memory and written with coalesced 8-byte stores.
//
// Input bits must be 0 or 1.  The schedule arrives as CSR int32 device
// arrays: col_ptr[q + 1], grp[E], shift[E] with 0 <= shift < 360.

#include <cstdint>

#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

constexpr int kRows = 360;
constexpr int kWalkers = 12;          // 32-row words over the 360 rows
constexpr int kGroupBytes = 52;       // 13 words: 360 bits, then bits 0-55
constexpr int kGroupChunks = kRows / 8;
constexpr int kLoads = 8;             // 8-byte loads in flight a thread

// 8 bytes of 0/1 -> one byte, bit j = byte j.  v * 0x00204081 moves byte
// k of a word (bit 8 k) to bit 21 + k with no carry between the terms.
__device__ __forceinline__ uint32_t pack8(uint2 v) {
  const uint32_t lo = (v.x * 0x00204081u) >> 21 & 0xfu;
  const uint32_t hi = (v.y * 0x00204081u) >> 21 & 0xfu;
  return lo | hi << 4;
}

// the inverse: bit k of a nibble n lands at bit 8 k of n * 0x00204081
__device__ __forceinline__ uint2 unpack8(uint32_t b) {
  return make_uint2((b & 0xfu) * 0x00204081u & 0x01010101u,
                    (b >> 4) * 0x00204081u & 0x01010101u);
}

// shared memory: the parity bytes (360 q, natural order), then 4-byte
// words: the packed frame (groups x 13), the parity words par[c][t]
// (q x 12), the column chunks' row totals (chunks x 12), the flip words
// (12), the schedule: col_ptr (q + 1), then E entries (g * 52 | s << 16).
// At 128 threads, 16 blocks a SM (32 registers a thread) hold a vv009
// step's 2048 frames.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
ldpc_codeword_kernel(const uint8_t* __restrict__ bits,
                     uint8_t* __restrict__ out,
                     const int32_t* __restrict__ col_ptr,
                     const int32_t* __restrict__ grp,
                     const int32_t* __restrict__ shift, int nbch, int q,
                     int entries) {
  // the walk: a warp per 128 threads, each walker a run of columns of
  // one 32-row word
  constexpr int kWalkThreads = kThreads / 4;
  constexpr int kChunks = kWalkThreads / kWalkers;
  extern __shared__ uint2 smem8[];
  uint8_t* par_b = reinterpret_cast<uint8_t*>(smem8);
  uint32_t* packed = reinterpret_cast<uint32_t*>(par_b + kRows * q);
  uint32_t* par = packed + nbch / kRows * (kGroupBytes / 4);
  uint32_t* ctot = par + q * kWalkers;
  uint32_t* flip = ctot + kChunks * kWalkers;
  int32_t* s_ptr = reinterpret_cast<int32_t*>(flip + kWalkers);
  int32_t* s_ent = s_ptr + q + 1;
  uint8_t* packed_b = reinterpret_cast<uint8_t*>(packed);
  const int tid = threadIdx.x;
  const int nldpc = nbch + kRows * q;
  const int chunks = nbch / 8;
  const uint2* src = reinterpret_cast<const uint2*>(
      bits + static_cast<size_t>(blockIdx.x) * nbch);
  uint2* dst8 = reinterpret_cast<uint2*>(
      out + static_cast<size_t>(blockIdx.x) * nldpc);

  // 1. the info bits, packed into shared memory
  for (int i = tid; i <= q; i += kThreads) s_ptr[i] = col_ptr[i];
  for (int i = tid; i < entries; i += kThreads) {
    s_ent[i] = grp[i] * kGroupBytes | shift[i] << 16;
  }
  for (int k0 = tid; k0 < chunks; k0 += kLoads * kThreads) {
    uint2 v[kLoads];  // all of a round's loads in flight before any use
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = k0 + u * kThreads;
      if (k < chunks) v[u] = __ldcs(src + k);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = k0 + u * kThreads;
      if (k < chunks) {
        const uint8_t b = static_cast<uint8_t>(pack8(v[u]));
        const int g = k / kGroupChunks, kk = k - g * kGroupChunks;
        packed_b[g * kGroupBytes + kk] = b;
        if (kk < kGroupBytes - kGroupChunks) {
          packed_b[g * kGroupBytes + kGroupChunks + kk] = b;
        }
      }
    }
  }
  __syncthreads();

  // 2. the schedule walk, 32 rows a thread: walker (k, t) takes rows
  // 32 t .. 32 t + 31 over the k-th run of columns [c0, c1)
  const int wk = tid / kWalkers, wt = tid - wk * kWalkers;
  const bool walker = tid < kChunks * kWalkers;
  const int c0 = wk * q / kChunks, c1 = (wk + 1) * q / kChunks;
  if (tid < kWalkThreads) {
    if (walker) {
      uint32_t run = 0;
      for (int c = c0; c < c1; ++c) {
        uint32_t acc = 0;
        const int end = s_ptr[c + 1];
#pragma unroll 4
        for (int e = s_ptr[c]; e < end; ++e) {
          const int ent = s_ent[e];
          int r = 32 * wt - (ent >> 16);
          if (r < 0) r += kRows;
          const uint32_t* w = packed + ((ent & 0xffff) >> 2) + (r >> 5);
          acc ^= __funnelshift_r(w[0], w[1], r);
        }
        run ^= acc;
        par[c * kWalkers + wt] = run;  // this run's prefix only
      }
      ctot[wk * kWalkers + wt] = run;
    }
  } else {
    // ... while the other warps write the info bits out
#pragma unroll 4
    for (int k = tid - kWalkThreads; k < chunks;
         k += kThreads - kWalkThreads) {
      const int g = k / kGroupChunks, kk = k - g * kGroupChunks;
      __stcs(dst8 + k, unpack8(packed_b[g * kGroupBytes + kk]));
    }
  }
  __syncthreads();

  // 3. the row totals, their exclusive XOR scan over the rows (a prefix
  // within each word, five shifts, plus the parities of the words before)
  uint32_t flip_t = 0;
  if (tid < kWalkers) {
    uint32_t tot = 0;
    for (int k = 0; k < kChunks; ++k) tot ^= ctot[k * kWalkers + tid];
    // rows 360-383 of the last word are not rows
    flip[tid] = tid == kWalkers - 1 ? tot & 0xffu : tot;
  }
  __syncthreads();
  if (tid < kWalkers) {
    const uint32_t tot = flip[tid];
    uint32_t carry = 0;
    for (int u = 0; u < tid; ++u) carry ^= __popc(flip[u]) & 1u;
    uint32_t x = tot;
#pragma unroll
    for (int sh = 1; sh < 32; sh <<= 1) x ^= x << sh;
    flip_t = x ^ tot ^ (carry ? 0xffffffffu : 0u);
  }
  __syncthreads();
  if (tid < kWalkers) flip[tid] = flip_t;
  __syncthreads();
  // each walker completes its columns: the earlier runs' totals, then
  // the row flips
  if (walker) {
    uint32_t fix = flip[wt];
    for (int k = 0; k < wk; ++k) fix ^= ctot[k * kWalkers + wt];
    for (int c = c0; c < c1; ++c) par[c * kWalkers + wt] ^= fix;
  }
  __syncthreads();

  // 4. the parity bytes: each word's 32 bits to their bytes p = m q + c
  // in shared memory (neighbouring threads on neighbouring columns), then
  // out with coalesced 8-byte stores
  for (int i = tid; i < q * kWalkers; i += kThreads) {
    const int t = i / q, c = i - t * q;
    const uint32_t w = par[c * kWalkers + t];
    const int rows = t == kWalkers - 1 ? kRows - 32 * t : 32;
    uint8_t* p = par_b + 32 * t * q + c;
    for (int j = 0; j < rows; ++j) p[j * q] = w >> j & 1u;
  }
  __syncthreads();
  const uint2* par8 = reinterpret_cast<const uint2*>(par_b);
  for (int j = tid; j < kRows * q / 8; j += kThreads) {
    __stcs(dst8 + chunks + j, par8[j]);
  }
}

template <int kThreads>
int launch(const void* bits, void* out, const void* col_ptr, const void* grp,
           const void* shift, int frames, int nbch, int q, int entries,
           int device, cudaStream_t stream) {
  const auto kernel = ldpc_codeword_kernel<kThreads>;
  constexpr int kChunks = kThreads / 4 / kWalkers;
  const int smem = kRows * q + 4 * (nbch / kRows * (kGroupBytes / 4) +
                                    q * kWalkers + kChunks * kWalkers +
                                    kWalkers + q + 1 + entries);
  // above 48 KB a launch is refused unless the kernel's limit is raised:
  // once a device, to all that a block may have (a table needs up to
  // about 53 KB: normal frames at rate 1/3)
  static dvbt2ll::PerDevice<int> max_smem;
  int limit = 0;
  const cudaError_t err = max_smem.get(device, &limit, [kernel](int dev,
                                                                int* lim) {
    int optin = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    *lim = optin - static_cast<int>(attr.sharedSizeBytes);
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *lim);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<frames, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(bits), static_cast<uint8_t*>(out),
      static_cast<const int32_t*>(col_ptr), static_cast<const int32_t*>(grp),
      static_cast<const int32_t*>(shift), nbch, q, entries);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bits (frames, nbch) and out (frames, nbch + 360 * q), both uint8 and
// contiguous, 8-byte aligned, nbch a multiple of 360; the schedule holds
// `entries` entries.  `device` is the current device, which `stream`
// belongs to.  Returns cudaGetLastError() after the launch.
extern "C" int dvbt2ll_ldpc_codeword(const void* bits, void* out,
                                     const void* col_ptr, const void* grp,
                                     const void* shift, int frames, int nbch,
                                     int q, int entries, int device,
                                     void* stream) {
  if (frames <= 0 || nbch <= 0 || nbch % kRows || q <= 0 || entries < 0 ||
      nbch / kRows * kGroupBytes > 0xffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static dvbt2ll::PerDevice<int> sm_count;
  int sms = 0;
  const cudaError_t err = sm_count.get(device, &sms, [](int dev, int* n) {
    return cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // fewer frames than 8 blocks a SM: more threads a frame, for more
  // loads and stores in flight
  if (frames < 8 * sms) {
    return launch<256>(bits, out, col_ptr, grp, shift, frames, nbch, q,
                       entries, device, s);
  }
  return launch<128>(bits, out, col_ptr, grp, shift, frames, nbch, q,
                     entries, device, s);
}

extern "C" const char* dvbt2ll_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
