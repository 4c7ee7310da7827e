// Bit interleaving, Gray-coded square QAM, rotation and the cyclic Q delay
// of DVB-T2 (EN 302 755 sections 6.2 and 6.3) for Hopper: each FEC frame's
// LDPC codeword (ldpc_frame_bits bytes of 0/1, the LDPC kernel's output)
// in, its cell_size constellation cells out, as two float32 planes (the
// planar frame builder's) or as interleaved complex64 (the complex one's).
//
// Replaces no TPU kernel: the JAX package writes the stage as XLA ops
// (dvbt2ll_tpu/pipeline.py map_cells_planes), and on the card the same
// torch ops (ops/qam.py::qam_map_plain) were eight and more passes over
// the batch: an int64-indexed gather into a (F, cell_size, mod) byte
// tensor, the XOR/shift passes of each axis, the float conversion, scale,
// products, sums and a roll.  The reference binary does the stage in one
// block, interleavermod_bc (lib/interleavermod_bc_impl.cc:270-704); this
// kernel does too.
//
// Math.  Cell c of a frame takes mod bits b_k = codeword[perm[c][k]],
// k < mod (perm: the parity interleave, column twist and demux composed,
// tables/mapper.py::bit_permutation); the even k are the I axis, the odd
// the Q axis, most significant first.  On an axis of h = mod / 2 bits
// a_0 .. a_(h-1) the Gray code's level is A = (2^h - 1) - 2 G, G the packed
// prefix XOR (bit h - 1 - j of G is a_0 ^ ... ^ a_j).  Then x = A (1/norm);
// rotated, i' = x_I cos - x_Q sin and q' = x_I sin + x_Q cos, and q' of
// cell c goes to cell (c + 1) mod cell_size of the same frame.  Each
// product, difference and sum is rounded on its own (__fmul_rn, __fsub_rn,
// __fadd_rn: no FMA contraction), in the plain twin's order, so that the
// kernel is bit-identical to it.
//
// What bounds it on the card: bytes.  The codeword is read once and the
// cells written once: a vv009 mux8 step (6016 frames of 16200 bits,
// 256QAM) moves 97.5 MB in and 97.5 MB out, 0.0582 ms at 3.35 TB/s; the
// UK mux's step (9494 frames of 64800 bits) 615 MB and 615 MB, 0.3673 ms.
// The bit indices (2 bytes each) are a table of 32 KB (short frames) or
// 130 KB (normal), read by every frame from the L2 cache.
//
// Design: one block of 512 threads a FEC frame.
// 1. The frame's codeword is copied into shared memory with cp.async (16
//    bytes a copy where the row is 16-byte aligned, as normal frames'
//    are; else 8: a short frame's row is 16200 bytes), every copy in
//    flight at once and none through registers.  A normal frame takes
//    64.8 KB, so three blocks fit a SM, 48 warps.
// 2. A thread a cell, a tile of 512 cells at a time: the cell's mod
//    indices are one load from the table (16 bytes at 256QAM), prefetched
//    a tile ahead; its bits are byte reads from shared memory.  The
//    interleaver's columns run along the codeword, so a warp's reads of
//    one bit fall on neighbouring bytes or, in the parity part, on a
//    stride of q_ldpc bytes: few bank conflicts.
// 3. Planar: I at c and Q at (c + 1) mod cell_size, each a coalesced
//    store.  Interleaved: a whole (I, Q) pair is one 8-byte store, so the
//    tile's Q values pass through shared memory to the next cell's thread
//    (the first thread keeps the tile before's last Q); cell 0's Q, which
//    is the frame's last cell's, is written by that cell's thread.
//
// Input: codewords (frames, n) u8, 8-byte aligned; the index table
// (cells, mod) u16 (ops/qam.py::qam_tables), 16-byte aligned.  Output
// (frames, cells) f32 twice, or (frames, cells) complex64.

#include <cstdint>

#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBits = 65536;   // u16 indices

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  }
}

// A cell's indices as H words: word j holds bit 2j (I) in its low half
// and bit 2j + 1 (Q) in its high half.
template <int H>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p,
                                         uint32_t (&w)[H]) {
  if constexpr (H == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (H == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < H; ++j) w[j] = __ldg(p + j);
  }
}

// One axis's level (2^H - 1) - 2 G, G the packed prefix XOR of its bits;
// `shift` 0 reads the I bits, 16 the Q bits.
template <int H>
__device__ __forceinline__ float level(const uint8_t* s,
                                       const uint32_t (&w)[H], int shift) {
  uint32_t acc = s[(w[0] >> shift) & 0xffffu];
  uint32_t g = acc;
#pragma unroll
  for (int j = 1; j < H; ++j) {
    acc ^= s[(w[j] >> shift) & 0xffffu];
    g = (g << 1) | acc;
  }
  return static_cast<float>(static_cast<int>((1u << H) - 1u) -
                            2 * static_cast<int>(g));
}

template <int MOD>
__global__ void __launch_bounds__(kThreads, 3)
qam_map_kernel(const uint8_t* __restrict__ code,
               const uint32_t* __restrict__ perm, float* __restrict__ out_i,
               float* __restrict__ out_q, int n, int cells, int rotate,
               int interleaved, float inv_norm, float cos_t, float sin_t) {
  constexpr int H = MOD / 2;
  extern __shared__ uint4 smem[];
  __shared__ float s_q[kThreads];
  uint8_t* s_code = reinterpret_cast<uint8_t*>(smem);
  const int tid = threadIdx.x;
  const size_t frame = blockIdx.x;
  const uint8_t* src = code + frame * n;

  // 1. the codeword into shared memory
  const int step = ((reinterpret_cast<uintptr_t>(src) | n) & 15) ? 8 : 16;
  for (int b = tid * step; b < n; b += kThreads * step) {
    cp_async(s_code + b, src + b, step);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  uint32_t w[H];
  if (tid < cells) load_row<H>(perm + tid * H, w);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // 2-3. a tile of kThreads cells at a time
  const size_t base = frame * cells;
  float2* out2 = reinterpret_cast<float2*>(out_i) + base;
  float carry = 0.0f;  // thread 0: the tile before's last Q
  for (int c0 = 0; c0 < cells; c0 += kThreads) {
    const int c = c0 + tid;
    uint32_t cur[H];
#pragma unroll
    for (int j = 0; j < H; ++j) cur[j] = w[j];
    if (c + kThreads < cells) load_row<H>(perm + (c + kThreads) * H, w);
    float xi = 0.0f, xq = 0.0f;
    if (c < cells) {
      xi = __fmul_rn(level<H>(s_code, cur, 0), inv_norm);
      xq = __fmul_rn(level<H>(s_code, cur, 16), inv_norm);
      if (rotate) {
        const float ri = __fsub_rn(__fmul_rn(xi, cos_t), __fmul_rn(xq, sin_t));
        const float rq = __fadd_rn(__fmul_rn(xi, sin_t), __fmul_rn(xq, cos_t));
        xi = ri;
        xq = rq;
      }
    }
    if (!interleaved) {
      if (c < cells) {
        out_i[base + c] = xi;
        out_q[base + (rotate && c + 1 == cells ? 0 : c + rotate)] = xq;
      }
    } else if (!rotate) {
      if (c < cells) out2[c] = make_float2(xi, xq);
    } else {
      s_q[tid] = xq;
      __syncthreads();
      const float prev = tid ? s_q[tid - 1] : carry;
      if (tid == 0) carry = s_q[kThreads - 1];
      if (c < cells) {
        if (c == 0) {
          reinterpret_cast<float*>(out2)[0] = xi;
        } else {
          out2[c] = make_float2(xi, prev);
        }
        if (c == cells - 1) reinterpret_cast<float*>(out2)[1] = xq;
      }
      __syncthreads();  // before the next tile writes s_q
    }
  }
}

using Kernel = void (*)(const uint8_t*, const uint32_t*, float*, float*, int,
                        int, int, int, float, float, float);

const Kernel kKernels[4] = {qam_map_kernel<2>, qam_map_kernel<4>,
                                qam_map_kernel<6>, qam_map_kernel<8>};

}  // namespace

// code (frames, n) u8, 8-byte aligned; perm (cells, mod) u16, 16-byte
// aligned, every index below n; mod 2, 4, 6 or 8 with cells * mod == n
// <= 65536 and n a multiple of 8.  interleaved: out_i is (frames, cells)
// complex64 and out_q unused; else out_i and out_q are (frames, cells)
// f32.  `device` is the current device, which `stream` belongs to.
// Returns cudaGetLastError() after the launch.
extern "C" int dvbt2ll_qam_map(const void* code, const void* perm,
                               void* out_i, void* out_q, int frames, int n,
                               int cells, int mod, int rotate,
                               int interleaved, float inv_norm, float cos_t,
                               float sin_t, int device, void* stream) {
  const auto bad = [](const void* p, uintptr_t align) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % align != 0;
  };
  if (frames <= 0 || (mod != 2 && mod != 4 && mod != 6 && mod != 8) ||
      cells <= 0 || cells * mod != n || n > kMaxBits || n % 8 ||
      bad(code, 8) || bad(perm, 16) || bad(out_i, interleaved ? 8 : 4) ||
      (!interleaved && bad(out_q, 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB a launch is refused unless the kernel's limit is raised:
  // once a device, for each form, to all that a block may have
  static dvbt2ll::PerDevice<int> max_smem;
  int limit = 0;
  const cudaError_t err = max_smem.get(device, &limit, [](int dev,
                                                          int* lim) {
    int optin = 0;
    cudaError_t e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    *lim = optin;
    for (const Kernel k : kKernels) {
      cudaFuncAttributes attr;
      if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, k);
      if (e != cudaSuccess) return e;
      const int room = optin - static_cast<int>(attr.sharedSizeBytes);
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               room);
      *lim = room < *lim ? room : *lim;
    }
    return e;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = (n + 15) / 16 * 16;
  if (smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  kKernels[mod / 2 - 1]<<<frames, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(code), static_cast<const uint32_t*>(perm),
      static_cast<float*>(out_i), static_cast<float*>(out_q), n, cells,
      rotate != 0, interleaved != 0, inv_norm, cos_t, sin_t);
  return static_cast<int>(cudaGetLastError());
}
