// Per-leaf bit-plane GeMV kernels for Hopper (sm_90a).
//
// B1 gemv_bs — replaces the TPU kernel `gemv_bs_pallas` / `_gemv_bs_kernel`
//   (src/repro/kernels/bitplane_gemv/kernel.py): integer activation codes ×
//   packed weight planes, per-tile zero-point correction, f32 scaling.
// B3 gemv_f  — replaces `gemv_f_pallas` / `_gemv_f_kernel` (same file):
//   float activations × packed weight planes.
//
// Bound. At decode (B = 4 rows) both are bound by bytes: each call must read
// the packed planes once, q·N·M/8 bytes (4 MiB for a 4096×4096 q2 layer,
// 32.8 MB for the 4096→32000 lm_head), and little else. B1's operation
// count sits far below the card's integer rate; B3's 2·B·N·M f32
// multiply-adds on CUDA cores come near the byte time (67 TFLOP/s).
//
// Design for that bound. A block owns a strip of 32 output columns and up
// to 8 rows of the batch; each thread owns one column. Planes are read in
// their packed form straight from device memory, once per block, with
// neighbouring lanes on neighbouring words (coalesced), and without the
// padding copy the TPU path makes: the words past the leaf's last one and
// the columns past M read as zero bits. The reduction tiles are split over
// the block's 8 warps (one tile per warp per round, so many loads are in
// flight), and each round's per-tile results go through shared memory into
// the output in ascending tile order: no atomics, and the same rounding
// sequence as the plain version. Narrow strips give 128 to 1000 blocks at
// the main-path widths, enough to cover the 132 SMs.
//
// Launch functions return cudaGetLastError() after the launch; the Python
// wrapper raises on anything but 0.

#include "bitplane_tile.cuh"

using namespace bitplane;

// codes (B, n_pad) uint8; planes (q, n_words, M) int32 with
// n_words ≤ n_pad/32; scales (n_pad/bn, M) f32 → out (B, M) f32
__global__ void __launch_bounds__(kWarps * 32)
gemv_bs_kernel(const uint8_t* __restrict__ codes,
               const int32_t* __restrict__ planes,
               const float* __restrict__ scales, float* __restrict__ out,
               int B, int n_pad, int n_words, int M, int q, int p, int z_a,
               int z_w, int bn) {
  __shared__ IntTileSmem sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * 32 + lane;
  const bool col_ok = m < M;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, B - row0);
  const int words = bn >> 5;
  const int tiles = n_pad / bn;
  const long plane_stride = static_cast<long>(n_words) * M;
  float acc = 0.f;                      // row `warp` of this block
  for (int t0 = 0; t0 < tiles; t0 += kWarps) {
    const int t = t0 + warp;
    if (t < tiles)
      int_tile(codes + static_cast<long>(row0) * n_pad
                   + static_cast<long>(t) * bn,
               n_pad, rows,
               planes + static_cast<long>(t) * words * M + m, plane_stride,
               M, words, min(words, n_words - t * words), col_ok, q, p, z_a,
               z_w, bn, sm, warp, lane);
    __syncthreads();
    if (warp < rows && col_ok)
      acc = int_epilogue(sm, min(kWarps, tiles - t0),
                         scales + static_cast<long>(t0) * M + m, M, warp,
                         lane, acc);
    __syncthreads();
  }
  if (warp < rows && col_ok) out[static_cast<long>(row0 + warp) * M + m] = acc;
}

// a (B, n_pad) f32; planes and scales as gemv_bs → out (B, M) f32
__global__ void __launch_bounds__(kWarps * 32)
gemv_f_kernel(const float* __restrict__ a, const int32_t* __restrict__ planes,
              const float* __restrict__ scales, float* __restrict__ out,
              int B, int n_pad, int n_words, int M, int q, int zero, int bn) {
  __shared__ float s_corr[kWarps][kRows][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * 32 + lane;
  const bool col_ok = m < M;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, B - row0);
  const int words = bn >> 5;
  const int tiles = n_pad / bn;
  const long plane_stride = static_cast<long>(n_words) * M;
  float out_acc = 0.f;
  for (int t0 = 0; t0 < tiles; t0 += kWarps) {
    const int t = t0 + warp;
    if (t < tiles) {
      float acc[kMaxBits][kRows];
      float sum_a[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        sum_a[r] = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxBits; ++i) acc[i][r] = 0.f;
      }
      const float* a_tile = a + static_cast<long>(row0) * n_pad
                            + static_cast<long>(t) * bn;
      const int32_t* p_tile = planes + static_cast<long>(t) * words * M + m;
      const int live_words = col_ok ? min(words, n_words - t * words) : 0;
      for (int w = 0; w < words; ++w) {
        // lane j holds reduction row 32w + j of every batch row; the bit
        // loop broadcasts them with shuffles
        float av[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          av[r] = r < rows ? a_tile[static_cast<long>(r) * n_pad + w * 32
                                    + lane]
                           : 0.f;
          sum_a[r] += av[r];
        }
        uint32_t wi[kMaxBits];
#pragma unroll
        for (int i = 0; i < kMaxBits; ++i)
          wi[i] = (i < q && w < live_words)
                      ? static_cast<uint32_t>(
                            p_tile[i * plane_stride + static_cast<long>(w) * M])
                      : 0u;
        for (int j = 0; j < 32; ++j) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < rows) {
              const float aj = __shfl_sync(kFull, av[r], j);
#pragma unroll
              for (int i = 0; i < kMaxBits; ++i)
                if (i < q) acc[i][r] += ((wi[i] >> j) & 1u) ? aj : 0.f;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          float s = sum_a[r];
          for (int off = 16; off > 0; off >>= 1)
            s += __shfl_xor_sync(kFull, s, off);
          float tot = 0.f;
#pragma unroll
          for (int i = 0; i < kMaxBits; ++i)
            if (i < q) tot += static_cast<float>(1 << i) * acc[i][r];
          s_corr[warp][r][lane] = tot - static_cast<float>(zero) * s;
        }
      }
    }
    __syncthreads();
    if (warp < rows && col_ok) {
      const int n = min(kWarps, tiles - t0);
      for (int j = 0; j < n; ++j)
        out_acc = __fmaf_rn(s_corr[j][warp][lane],
                            scales[static_cast<long>(t0 + j) * M + m],
                            out_acc);
    }
    __syncthreads();
  }
  if (warp < rows && col_ok)
    out[static_cast<long>(row0 + warp) * M + m] = out_acc;
}

extern "C" int gemv_bs_launch(const void* codes, const void* planes,
                              const void* scales, void* out, int B,
                              int n_pad, int n_words, int M, int q, int p,
                              int z_a, int z_w, int bn, void* stream) {
  const dim3 grid((M + 31) / 32, (B + kRows - 1) / kRows);
  gemv_bs_kernel<<<grid, kWarps * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(planes),
      static_cast<const float*>(scales), static_cast<float*>(out), B, n_pad,
      n_words, M, q, p, z_a, z_w, bn);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gemv_f_launch(const void* a, const void* planes,
                             const void* scales, void* out, int B, int n_pad,
                             int n_words, int M, int q, int zero, int bn,
                             void* stream) {
  const dim3 grid((M + 31) / 32, (B + kRows - 1) / kRows);
  gemv_f_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const int32_t*>(planes),
      static_cast<const float*>(scales), static_cast<float*>(out), B, n_pad,
      n_words, M, q, zero, bn);
  return static_cast<int>(cudaGetLastError());
}
