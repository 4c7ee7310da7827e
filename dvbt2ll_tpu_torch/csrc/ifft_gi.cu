// Fused 4-step IFFT + guard interval of DVB-T2 OFDM symbols (1K-8K FFTs),
// for Hopper, in full float32.
//
// Replaces the Pallas TPU kernel dvbt2ll_tpu/ops/ifft_pallas.py:
// ifft_gi_pallas (:181), its body _kernel (:136), pallas_call at :226.
// That kernel tiles frames and symbols (b_tile, s_tile), tiles the twiddle
// on the host and applies W2 as a block-diagonal kron(eye, W2) (:214-220),
// all to feed a 128 x 128 matrix unit from VMEM.  None of that carries
// over: here one block takes one symbol.
//
// Math (ops/ifft.py): with N = N1 * N2, N1 = 128, the input plane holds
// A[k2][k1] = X[N2 * k1 + k2] (the frame builder's transposed layout), and
//   B[k2][n1] = sum_k1 A[k2][k1] W1[k1][n1]      (W1 carries the scale)
//   C[k2][n1] = B[k2][n1] T[k2][n1]
//   x[n2][n1] = sum_k2 W2[n2][k2] C[k2][n1]      = sample N1 * n2 + n1,
// so the rows come out in natural sample order and the guard interval is
// a copy of the last gi_rows rows ahead of the body.  All complex, on
// separate re/im float32 planes.
//
// What bounds it on the card: float32 FMA.  For vv009 at batch 256 (1792
// symbols of N2 = 32) stage 1 is 7.52 GFLOP and stage 3 1.88 GFLOP, about
// 9.4 GFLOP for 119 MB read and written: some 79 FLOP per byte, against a
// float32 ridge of about 20 on an H100 (67 TFLOP/s over 3.35 TB/s).  TF32
// tensor cores would not hold the chain's 100 dB bar.
//
// Design: one block of 256 threads per symbol.  The symbol's A planes
// (N2 x 128 x 2 floats: 32 KB at 4K, 64 KB at 8K) are staged in dynamic
// shared memory.  Thread (g, n1), g = 0 or 1, owns column n1 of rows
// g * N2/2 ... (g + 1) * N2/2 - 1 and keeps their stage-1 sums in
// registers: W1 comes from global memory (128 KB, L2-resident), coalesced
// across n1, and the A rows are broadcast float4 reads of shared memory.
// The twiddled C overwrites A in shared memory after a barrier; stage 3
// reads C's column n1 and broadcast float4 rows of W2.  The grid is read
// once and the guarded time domain written once, with nothing in device
// memory in between; the guard interval is the same registers stored a
// second time.  Neighbouring threads write neighbouring n1.
//
// Left for later: wgmma with a split-precision (3xTF32-style) scheme that
// keeps 100 dB, several symbols per block at 1K/2K, and writing straight
// into the (B, samples, 2) output after P1.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kN1 = 128;
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kN1;

template <int N2>
__global__ void __launch_bounds__(kThreads)
ifft_gi_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
               float* __restrict__ out_r, float* __restrict__ out_i,
               const float* __restrict__ w1r, const float* __restrict__ w1i,
               const float* __restrict__ ttr, const float* __restrict__ tti,
               const float* __restrict__ w2r, const float* __restrict__ w2i,
               int gi_rows) {
  constexpr int kRows = N2 / kGroups;   // rows of one thread
  constexpr int kPlane = N2 * kN1;      // floats of one plane of a symbol
  extern __shared__ float4 smem[];
  float* sr = reinterpret_cast<float*>(smem);
  float* si = sr + kPlane;

  const int n1 = threadIdx.x % kN1;
  const int row0 = (threadIdx.x / kN1) * kRows;
  const size_t sym = blockIdx.x;

  const float4* gr = reinterpret_cast<const float4*>(ar + sym * kPlane);
  const float4* gi = reinterpret_cast<const float4*>(ai + sym * kPlane);
  for (int v = threadIdx.x; v < kPlane / 4; v += kThreads) {
    smem[v] = gr[v];
    smem[kPlane / 4 + v] = gi[v];
  }
  __syncthreads();

  // stage 1: B = A W1, complex, four k1 at a time
  float br[kRows], bi[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) br[j] = bi[j] = 0.f;
  for (int k1 = 0; k1 < kN1; k1 += 4) {
    float wr[4], wi[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      wr[u] = __ldg(w1r + (k1 + u) * kN1 + n1);
      wi[u] = __ldg(w1i + (k1 + u) * kN1 + n1);
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(
          sr + (row0 + j) * kN1 + k1);
      const float4 b = *reinterpret_cast<const float4*>(
          si + (row0 + j) * kN1 + k1);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        br[j] = fmaf(av[u], wr[u], br[j]);
        br[j] = fmaf(-bv[u], wi[u], br[j]);
        bi[j] = fmaf(av[u], wi[u], bi[j]);
        bi[j] = fmaf(bv[u], wr[u], bi[j]);
      }
    }
  }
  __syncthreads();  // every thread has read A: C may overwrite it

  // stage 2: C = B T, into shared memory
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int at = (row0 + j) * kN1 + n1;
    const float tr = __ldg(ttr + at);
    const float ti = __ldg(tti + at);
    sr[at] = fmaf(br[j], tr, -bi[j] * ti);
    si[at] = fmaf(br[j], ti, bi[j] * tr);
  }
  __syncthreads();

  // stage 3: x = W2 C, complex, four k2 at a time
  float xr[kRows], xi[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) xr[j] = xi[j] = 0.f;
  for (int k2 = 0; k2 < N2; k2 += 4) {
    float cr[4], ci[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      cr[u] = sr[(k2 + u) * kN1 + n1];
      ci[u] = si[(k2 + u) * kN1 + n1];
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(
          w2r + (row0 + j) * N2 + k2));
      const float4 b = __ldg(reinterpret_cast<const float4*>(
          w2i + (row0 + j) * N2 + k2));
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        xr[j] = fmaf(av[u], cr[u], xr[j]);
        xr[j] = fmaf(-bv[u], ci[u], xr[j]);
        xi[j] = fmaf(av[u], ci[u], xi[j]);
        xi[j] = fmaf(bv[u], cr[u], xi[j]);
      }
    }
  }

  // rows in sample order after gi_rows prefix rows; the last gi_rows rows
  // of the body are the prefix
  const size_t out0 = sym * (N2 + gi_rows) * kN1 + n1;
  const int wrap = N2 - gi_rows;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int n2 = row0 + j;
    const size_t at = out0 + static_cast<size_t>(gi_rows + n2) * kN1;
    out_r[at] = xr[j];
    out_i[at] = xi[j];
    if (n2 >= wrap) {
      const size_t pre = out0 + static_cast<size_t>(n2 - wrap) * kN1;
      out_r[pre] = xr[j];
      out_i[pre] = xi[j];
    }
  }
}

template <int N2>
int launch(const float* ar, const float* ai, float* out_r, float* out_i,
           const float* w1r, const float* w1i, const float* ttr,
           const float* tti, const float* w2r, const float* w2i,
           int symbols, int gi_rows, cudaStream_t stream) {
  const int smem = 2 * N2 * kN1 * static_cast<int>(sizeof(float));
  // above 48 KB (8K) the launch is refused without this
  cudaError_t err = cudaFuncSetAttribute(
      ifft_gi_kernel<N2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ifft_gi_kernel<N2><<<symbols, kThreads, smem, stream>>>(
      ar, ai, out_r, out_i, w1r, w1i, ttr, tti, w2r, w2i, gi_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grids ar, ai (symbols, n2, 128); out_r, out_i (symbols, n2 + gi_rows,
// 128); w1 (128, 128), t (n2, 128), w2 (n2, n2): all float32, contiguous,
// 16-byte aligned.  n2 is 8, 16, 32 or 64 and 0 <= gi_rows <= n2.
// Returns cudaGetLastError() after the launch.
extern "C" int dvbt2ll_ifft_gi(const void* ar, const void* ai, void* out_r,
                               void* out_i, const void* w1r, const void* w1i,
                               const void* ttr, const void* tti,
                               const void* w2r, const void* w2i, int symbols,
                               int n2, int gi_rows, void* stream) {
  if (symbols <= 0 || gi_rows < 0 || gi_rows > n2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o_r = static_cast<float*>(out_r);
  float* o_i = static_cast<float*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n2) {
    case 8:
      return launch<8>(f(ar), f(ai), o_r, o_i, f(w1r), f(w1i), f(ttr),
                       f(tti), f(w2r), f(w2i), symbols, gi_rows, s);
    case 16:
      return launch<16>(f(ar), f(ai), o_r, o_i, f(w1r), f(w1i), f(ttr),
                        f(tti), f(w2r), f(w2i), symbols, gi_rows, s);
    case 32:
      return launch<32>(f(ar), f(ai), o_r, o_i, f(w1r), f(w1i), f(ttr),
                        f(tti), f(w2r), f(w2i), symbols, gi_rows, s);
    case 64:
      return launch<64>(f(ar), f(ai), o_r, o_i, f(w1r), f(w1i), f(ttr),
                        f(tti), f(w2r), f(w2i), symbols, gi_rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
