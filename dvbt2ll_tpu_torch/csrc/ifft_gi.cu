// The planar OFDM tail of DVB-T2 (1K-8K FFTs), for Hopper, in full float32:
// P1, then each symbol's 4-step IFFT with its guard interval, stored once
// as the final (B, samples, 2) interleaved I/Q.
//
// Replaces the Pallas TPU kernel dvbt2ll_tpu/ops/ifft_pallas.py:
// ifft_gi_pallas (:181), its body _kernel (:136), pallas_call at :226,
// and the P1 concat and I/Q interleave after it.  That kernel computes
// the 4-step IFFT as two dense DFT matrix products sized for a 128 x 128
// matrix unit.  None of that carries over.
//
// Math: with N = N1 * N2, N1 = 128, the input plane holds
// A[k2][k1] = X[N2 * k1 + k2] (the frame builder's transposed layout), and
//   x[N1 * n2 + n1] = scale * sum_k2 w_N2^(k2 n2) w_N^(k2 n1)
//                             sum_k1 A[k2][k1] w_128^(k1 n1),
// w_M = exp(2 pi i / M): a 128-point inverse FFT along each row, the
// twiddle w_N^(k2 n1) (with the scale), then an N2-point inverse FFT down
// each column.  The rows come out in natural sample order, so the guard
// interval is the last gi_rows rows stored a second time.
//
// What bounds it on the card: bytes.  The transform needs about
// 5 N log2 N FLOP a symbol (0.44 GFLOP for a vv009 batch-256 step) for
// 58.7 MB read and 64.7 MB written, about 3.6 FLOP a byte against a
// float32 ridge of about 20 on an H100 (67 TFLOP/s over 3.35 TB/s).  So
// radix FFT passes, not dense DFT products, and no tensor cores: there is
// no matrix work for wgmma to take, and TF32 would not hold the chain's
// 100 dB bar.  Twiddles come from host tables made in float64 (w_128^k,
// and scale * w_N^k), not from sin/cos intrinsics.
//
// Design: a persistent grid, a few blocks a SM, each walking over tiles
// of 4096 points (G = 32 / N2 symbols at 1K-4K, one 8K symbol of 8192
// points with twice the threads).  A tile's two planes are loaded with
// cp.async into one of two shared-memory buffers while the other is
// transformed.  Rows are padded to 136 floats so that the accesses below
// are free of bank conflicts.
// - Rows: 8 threads a row, one warp holds 4 rows.  128 = 16 x 8: each
//   thread does a 16-point DFT in registers over k1 = 8 ka + kb, the
//   twiddle w_128^(kb na), an exchange through the row's own storage
//   (stride 17), then two 8-point DFTs; the 4-step twiddle and the scale
//   are applied as the row is written back.  A row never leaves its warp,
//   so it needs only __syncwarp.
// - Columns: N2 = 16 Q (Q threads a column) or 8 (a thread does two
//   columns).  A 16-point (8-point) DFT down the column, then for Q > 1
//   the twiddle w_N2^(q na), an exchange through the column and Q-point
//   DFTs.  Each result is stored straight to device memory as one float2
//   (I, Q), neighbouring threads on neighbouring samples; guard rows twice.
// - P1 (2048 samples, the same for every frame) is copied into each
//   frame's head by the whole grid before the tiles.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

constexpr int kN1 = 128;
constexpr int kRowStride = 136;  // floats: rows 8 banks apart
constexpr int kP1 = 2048;

// cos and sin of 2 pi m / 16 for m = 0..7, as float literals
__device__ __forceinline__ float cos16(int m) {
  switch (m) {
    case 0: return 1.0f;
    case 1: return 0.92387953251128674f;
    case 2: return 0.70710678118654752f;
    case 3: return 0.38268343236508978f;
    case 4: return 0.0f;
    case 5: return -0.38268343236508978f;
    case 6: return -0.70710678118654752f;
    default: return -0.92387953251128674f;
  }
}

// sin(2 pi m / 16) = cos(2 pi (m - 4) / 16)
__device__ __forceinline__ float sin16(int m) {
  return cos16(m < 4 ? 4 - m : m - 4);
}

// Inverse DFT of R = 1, 2, 4, 8 or 16 points in registers, natural order
// in and out: radix-2 decimation in time.
template <int R>
__device__ __forceinline__ void dft(float* re, float* im) {
  if constexpr (R > 1) {
    constexpr int H = R / 2;
    float er[H], ei[H], odr[H], odi[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      er[i] = re[2 * i];
      ei[i] = im[2 * i];
      odr[i] = re[2 * i + 1];
      odi[i] = im[2 * i + 1];
    }
    dft<H>(er, ei);
    dft<H>(odr, odi);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      float tr = odr[k], ti = odi[k];
      if (k != 0) {  // w_R^k = exp(+2 pi i k / R)
        const float c = cos16(k * (16 / R)), s = sin16(k * (16 / R));
        tr = odr[k] * c - odi[k] * s;
        ti = odr[k] * s + odi[k] * c;
      }
      re[k] = er[k] + tr;
      im[k] = ei[k] + ti;
      re[k + H] = er[k] - tr;
      im[k + H] = ei[k] - ti;
    }
  }
}

__device__ __forceinline__ void cmul(float& re, float& im, float c, float s) {
  const float r = re * c - im * s;
  im = re * s + im * c;
  re = r;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

template <int N2>
struct Tile {
  static constexpr int kSymbols = N2 >= 32 ? 1 : 32 / N2;   // G
  static constexpr int kRows = kSymbols * N2;                // 32 or 64
  static constexpr int kThreads = kRows * 8;                 // 256 or 512
  static constexpr int kPlane = kRows * kRowStride;          // floats
  static constexpr int kR1 = N2 < 16 ? N2 : 16;             // column radix
  static constexpr int kQ = N2 / kR1;                        // threads a column
  static constexpr int kCols = kSymbols * kN1;
  static constexpr int kColItems = 16 / kR1;                 // columns a thread
  static constexpr int kSmemBytes =
      (2 * 2 * kPlane + 2 * kN1) * static_cast<int>(sizeof(float));
};

template <int N2>
__global__ void __launch_bounds__(Tile<N2>::kThreads)
ofdm_tail_kernel(const float* __restrict__ ar, const float* __restrict__ ai,
                 const float2* __restrict__ p1,
                 const float2* __restrict__ w128,
                 const float2* __restrict__ tw, float2* __restrict__ out,
                 int frames, int spf, int gi_rows) {
  using T = Tile<N2>;
  constexpr int kFft = N2 * kN1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* wr = smem + 2 * 2 * T::kPlane;  // w_128^k, k = 0..127
  float* wi = wr + kN1;
  const int tid = threadIdx.x;

  const int gi = gi_rows * kN1;
  const size_t samples = kP1 + static_cast<size_t>(spf) * (kFft + gi);
  const int total = frames * spf;
  const int tiles = (total + T::kSymbols - 1) / T::kSymbols;

  // buffer k's re plane at smem + 2 k kPlane, im plane kPlane after it
  const auto load = [&](int buf, int tile) {
    float* sr = smem + 2 * buf * T::kPlane;
    float* si = sr + T::kPlane;
    const int first = tile * T::kSymbols;
    const int sym = min(T::kSymbols, total - first);
    const size_t row0 = static_cast<size_t>(first) * N2;
    for (int c = tid; c < sym * N2 * (kN1 / 4); c += T::kThreads) {
      const int r = c / (kN1 / 4), j = (c % (kN1 / 4)) * 4;
      cp_async16(sr + r * kRowStride + j, ar + (row0 + r) * kN1 + j);
      cp_async16(si + r * kRowStride + j, ai + (row0 + r) * kN1 + j);
    }
  };

  if (static_cast<int>(blockIdx.x) < tiles) load(0, blockIdx.x);
  cp_async_commit();

  for (int k = tid; k < kN1; k += T::kThreads) {
    const float2 w = w128[k];
    wr[k] = w.x;
    wi[k] = w.y;
  }
  for (size_t i = static_cast<size_t>(blockIdx.x) * T::kThreads + tid;
       i < static_cast<size_t>(frames) * kP1;
       i += static_cast<size_t>(gridDim.x) * T::kThreads) {
    __stcs(out + (i / kP1) * samples + i % kP1, p1[i % kP1]);
  }

  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    if (tile + static_cast<int>(gridDim.x) < tiles) {
      load((it + 1) & 1, tile + gridDim.x);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    float* sr = smem + 2 * (it & 1) * T::kPlane;
    float* si = sr + T::kPlane;

    // ---- rows: 128-point inverse FFT, then w_N^(k2 n1) * scale ----
    {
      const int row = tid >> 3, kb = tid & 7;
      float* rr = sr + row * kRowStride;
      float* ri = si + row * kRowStride;
      float xr[16], xi[16];
#pragma unroll
      for (int ka = 0; ka < 16; ++ka) {
        xr[ka] = rr[8 * ka + kb];
        xi[ka] = ri[8 * ka + kb];
      }
      dft<16>(xr, xi);
#pragma unroll
      for (int na = 1; na < 16; ++na) {
        cmul(xr[na], xi[na], wr[kb * na], wi[kb * na]);
      }
      __syncwarp();
#pragma unroll
      for (int na = 0; na < 16; ++na) {
        rr[kb * 17 + na] = xr[na];
        ri[kb * 17 + na] = xi[na];
      }
      __syncwarp();
      float yr[2][8], yi[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          yr[h][k] = rr[k * 17 + kb + 8 * h];
          yi[h][k] = ri[k * 17 + kb + 8 * h];
        }
        dft<8>(yr[h], yi[h]);
      }
      __syncwarp();
      const int k2 = row % N2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int n1 = kb + 8 * h + 16 * nb;
          const float2 t = __ldg(tw + k2 * n1);  // k2 n1 < N
          cmul(yr[h][nb], yi[h][nb], t.x, t.y);
          rr[n1] = yr[h][nb];
          ri[n1] = yi[h][nb];
        }
      }
    }
    __syncthreads();

    // ---- columns: N2-point inverse FFT, stored as final I/Q ----
#pragma unroll
    for (int item = 0; item < T::kColItems; ++item) {
      const int idx = tid + item * T::kThreads;
      const int c = idx % T::kCols, q = idx / T::kCols;
      const int g = c / kN1, n1 = c % kN1;
      float* cr = sr + g * N2 * kRowStride + n1;
      float* ci = si + g * N2 * kRowStride + n1;
      float vr[T::kR1], vi[T::kR1];
#pragma unroll
      for (int ka = 0; ka < T::kR1; ++ka) {
        vr[ka] = cr[(T::kQ * ka + q) * kRowStride];
        vi[ka] = ci[(T::kQ * ka + q) * kRowStride];
      }
      dft<T::kR1>(vr, vi);
      float xr[T::kR1], xi[T::kR1];  // x[n2] for n2 = nidx[j]
      int nidx[T::kR1];
      if constexpr (T::kQ == 1) {
#pragma unroll
        for (int j = 0; j < T::kR1; ++j) {
          xr[j] = vr[j];
          xi[j] = vi[j];
          nidx[j] = j;
        }
      } else {
        constexpr int kShare = 16 / T::kQ;  // n_a values of one thread
#pragma unroll
        for (int na = 1; na < 16; ++na) {
          const int m = (q * na * (kN1 / N2)) % kN1;  // w_N2^(q na)
          cmul(vr[na], vi[na], wr[m], wi[m]);
        }
        __syncthreads();
#pragma unroll
        for (int na = 0; na < 16; ++na) {
          cr[(q * 16 + na) * kRowStride] = vr[na];
          ci[(q * 16 + na) * kRowStride] = vi[na];
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kShare; ++j) {
          const int na = q * kShare + j;
          float ur[T::kQ], ui[T::kQ];
#pragma unroll
          for (int k = 0; k < T::kQ; ++k) {
            ur[k] = cr[(k * 16 + na) * kRowStride];
            ui[k] = ci[(k * 16 + na) * kRowStride];
          }
          dft<T::kQ>(ur, ui);
#pragma unroll
          for (int nb = 0; nb < T::kQ; ++nb) {
            xr[j * T::kQ + nb] = ur[nb];
            xi[j * T::kQ + nb] = ui[nb];
            nidx[j * T::kQ + nb] = na + 16 * nb;
          }
        }
      }
      const int sym = tile * T::kSymbols + g;
      if (sym < total) {
        const int b = sym / spf, s = sym % spf;
        float2* o = out + static_cast<size_t>(b) * samples + kP1 +
                    static_cast<size_t>(s) * (kFft + gi) + n1;
        const int wrap = N2 - gi_rows;
#pragma unroll
        for (int j = 0; j < T::kR1; ++j) {
          const int n2 = nidx[j];
          const float2 v = make_float2(xr[j], xi[j]);
          __stcs(o + (gi_rows + n2) * kN1, v);
          if (n2 >= wrap) __stcs(o + (n2 - wrap) * kN1, v);
        }
      }
    }
    __syncthreads();  // the next load may overwrite this buffer
  }
}

// What a launch of one tile shape needs of its device: the SM count and
// the blocks resident on one SM.
struct Residency {
  int sms;
  int per_sm;
};

template <int N2>
int launch(const float* ar, const float* ai, const float2* p1,
           const float2* w128, const float2* tw, float2* out, int frames,
           int spf, int gi_rows, int device, cudaStream_t stream) {
  using T = Tile<N2>;
  const auto kernel = ofdm_tail_kernel<N2>;
  static dvbt2ll::PerDevice<Residency> residency;
  Residency r{};
  const cudaError_t err = residency.get(device, &r, [kernel](int dev,
                                                            Residency* v) {
    // above 48 KB the launch is refused without this
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&v->sms, cudaDevAttrMultiProcessorCount,
                                 dev);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &v->per_sm, kernel, T::kThreads, T::kSmemBytes);
    }
    return e;
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      (static_cast<long long>(frames) * spf + T::kSymbols - 1) / T::kSymbols;
  const long long resident = static_cast<long long>(r.sms) * r.per_sm;
  const int grid = static_cast<int>(
      tiles < resident ? (tiles > 0 ? tiles : 1) : resident);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      ar, ai, p1, w128, tw, out, frames, spf, gi_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grids ar, ai (frames, spf, n2, 128) float32; p1 (2048, 2), w128 (128, 2)
// = w_128^k, tw (n2 * 128, 2) = scale * w_N^k, all float32; out (frames,
// 2048 + spf * (n2 + gi_rows) * 128, 2) float32.  All contiguous and
// 16-byte aligned; n2 is 8, 16, 32 or 64 and 0 <= gi_rows <= n2.
// `device` is the current device, which `stream` belongs to.  Returns
// cudaGetLastError() after the launch.
extern "C" int dvbt2ll_ofdm_tail(const void* ar, const void* ai,
                                 const void* p1, const void* w128,
                                 const void* tw, void* out, int frames,
                                 int spf, int n2, int gi_rows, int device,
                                 void* stream) {
  if (frames <= 0 || spf <= 0 || gi_rows < 0 || gi_rows > n2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto c = [](const void* p) { return static_cast<const float2*>(p); };
  float2* o = static_cast<float2*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n2) {
    case 8:
      return launch<8>(f(ar), f(ai), c(p1), c(w128), c(tw), o, frames, spf,
                       gi_rows, device, s);
    case 16:
      return launch<16>(f(ar), f(ai), c(p1), c(w128), c(tw), o, frames, spf,
                        gi_rows, device, s);
    case 32:
      return launch<32>(f(ar), f(ai), c(p1), c(w128), c(tw), o, frames, spf,
                        gi_rows, device, s);
    case 64:
      return launch<64>(f(ar), f(ai), c(p1), c(w128), c(tw), o, frames, spf,
                        gi_rows, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
