// QC-LDPC parity of DVB-T2 (EN 302 755 Annex A) codewords, for Hopper.
//
// Replaces the Pallas TPU kernel dvbt2ll_tpu/ops/ldpc_pallas.py, both its
// single-block form (_make_kernel, :33) and its row-grouped form for
// normal frames (_make_grouped_kernel, :84).  Those two exist only because
// a normal-frame table overflows the TPU's VMEM; here one kernel takes
// any Annex-A table.
//
// Math (tables/ldpc.py::qc_entries): lay the parity out as a (360, q)
// accumulator, parity bit p = m * q + c.  Schedule entry (group g, roll s)
// of column c XORs info group g rolled by s into column c:
//   acc[m][c] ^= bits[g * 360 + (m - s) mod 360].
// The chain p[j] ^= p[j - 1] then factors into an inclusive XOR prefix
// along each row (over c) plus an exclusive XOR scan of the row totals
// over the 360 rows, applied to every column.
//
// Design: one block per FEC frame, one thread per accumulator row m.
// Thread m walks the schedule, keeps the running row prefix in a register
// and writes out[f][m * q + c] in natural parity order.  The row totals
// are scanned in shared memory (Hillis-Steele, 9 steps), and a second
// pass flips the row's q outputs where the exclusive scan is 1.
//
// What bounds it on the card: the codeword bits it reads, one byte per
// bit, nbch bytes per frame (about 26 MB per vv009 step of 2048 frames),
// and the (360 x schedule entries) byte loads that read each bit a few
// times over.  The design reads each frame's bits only through that
// block's loads, which are consecutive bytes across the 360 threads
// (a rotation of one 360-byte group), and keeps the accumulator in
// registers.  Packing 32 frames per word and staging groups in shared
// memory are left for later.
//
// Input bits must be 0 or 1.  The schedule arrives as CSR int32 device
// arrays: col_ptr[q + 1], grp[E], shift[E] with 0 <= shift < 360.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 360;

__global__ void __launch_bounds__(kRows)
ldpc_parity_kernel(const uint8_t* __restrict__ bits,
                   uint8_t* __restrict__ out,
                   const int32_t* __restrict__ col_ptr,
                   const int32_t* __restrict__ grp,
                   const int32_t* __restrict__ shift, int nbch, int q) {
  __shared__ uint8_t scan[kRows];
  const int m = threadIdx.x;
  const uint8_t* frame = bits + static_cast<size_t>(blockIdx.x) * nbch;
  uint8_t* row = out + (static_cast<size_t>(blockIdx.x) * kRows + m) * q;

  uint8_t run = 0;
  for (int c = 0; c < q; ++c) {
    uint8_t acc = 0;
    for (int e = col_ptr[c]; e < col_ptr[c + 1]; ++e) {
      int k = m - shift[e];
      if (k < 0) k += kRows;
      acc ^= frame[grp[e] * kRows + k];
    }
    run ^= acc;
    row[c] = run;
  }

  // inclusive XOR scan of the row totals over m
  scan[m] = run;
  __syncthreads();
  for (int step = 1; step < kRows; step <<= 1) {
    uint8_t v = scan[m];
    if (m >= step) v ^= scan[m - step];
    __syncthreads();
    scan[m] = v;
    __syncthreads();
  }
  if (m > 0 && scan[m - 1]) {
    for (int c = 0; c < q; ++c) row[c] ^= 1;
  }
}

}  // namespace

// bits (frames, nbch) and out (frames, 360 * q), both uint8 and
// contiguous; returns cudaGetLastError() after the launch.
extern "C" int dvbt2ll_ldpc_parity(const void* bits, void* out,
                                   const void* col_ptr, const void* grp,
                                   const void* shift, int frames, int nbch,
                                   int q, void* stream) {
  ldpc_parity_kernel<<<frames, kRows, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<uint8_t*>(out),
      static_cast<const int32_t*>(col_ptr), static_cast<const int32_t*>(grp),
      static_cast<const int32_t*>(shift), nbch, q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dvbt2ll_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
