// B5 quant_matmul — replaces the TPU kernel `quant_matmul_pallas` /
// `_qmm_kernel` (src/repro/kernels/quant_matmul/kernel.py): the
// processor-side (llama.cpp-style) low-bit GeMV the paper compares MVDRAM
// against. Float activations × q-bit weight codes packed 32/q to a 32-bit
// word along N, dequantized as (code − zero)·scale of the reduction tile,
// summed in f32 (the JAX dot is Precision.HIGHEST: no TF32 here either).
//
// Bound. At decode (B = 4 rows) a q2 layer's packed codes are N·M/4 bytes
// (4.2 MB for 4096×4096, 3.35 TB/s → 1.25 µs), while its 2·B·N·M f32
// operations on CUDA cores take 2.0 µs at 67 TFLOP/s: the operations bound
// it, by a little.
//
// Design for that bound. The scale is constant over a tile, so a tile's
// term is scale·(Σ a·code − zero·Σ a): one multiply-add per weight and
// batch row, the dequantization folded into one correction per tile, as
// the bit-plane kernels do it. Each thread owns one output column of a
// 32-column strip and up to 8 batch rows; it reads its column's words
// straight from device memory (neighbouring lanes on neighbouring words,
// coalesced), eight words in flight, and unpacks them in registers. The
// activations are the same for every lane of a warp, so they are read as
// 16-byte broadcasts that the L1 cache serves. The block's 8 warps take the
// reduction tiles in turn; their partial sums meet in shared memory. The
// ragged ends (words past the leaf's last one, columns past M) are masked
// here, so the leaf's words are never padded.
//
// The launch function returns cudaGetLastError() after the launch; the
// Python wrapper raises on anything but 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;       // batch rows per block
constexpr int kBatch = 8;      // words in flight per lane

// a (B, n_pad) f32; words (W, M) with W ≤ n_pad / per; scales
// (n_pad / bn, M) f32 → out (B, M) f32. Grid (ceil(M / 32), ceil(B / 8)).
template <int Q>
__global__ void __launch_bounds__(kWarps * 32)
quant_matmul_kernel(const float* __restrict__ a,
                    const uint32_t* __restrict__ words,
                    const float* __restrict__ scales,
                    float* __restrict__ out, int B, int n_pad, int W, int M,
                    int zero, int bn) {
  constexpr int kPer = 32 / Q;
  constexpr uint32_t kMask = (1u << Q) - 1u;
  __shared__ float s_part[kWarps][kRows][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * 32 + lane;
  const bool col_ok = m < M;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, B - row0);
  const int tiles = n_pad / bn;
  const int tile_words = bn / kPer;
  const float* a0 = a + static_cast<long>(row0) * n_pad;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int t = warp; t < tiles; t += kWarps) {
    // Σ a over the tile, per row: lanes split it, then a warp sum
    float sa[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float s = 0.f;
      if (r < rows)
        for (int i = lane; i < bn; i += 32)
          s += a0[static_cast<long>(r) * n_pad + static_cast<long>(t) * bn
                  + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      sa[r] = s;
    }
    float part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0.f;
    const int w0 = t * tile_words;
    const int live = col_ok ? max(0, min(tile_words, W - w0)) : 0;
    for (int wi = 0; wi < live; wi += kBatch) {
      uint32_t wd[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        wd[j] = wi + j < live
                    ? words[static_cast<long>(w0 + wi + j) * M + m]
                    : 0u;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (wi + j < live) {
          // the word's codes are rows (w0 + wi + j)·per ... of a
          const float* ap = a0 + static_cast<long>(w0 + wi + j) * kPer;
#pragma unroll
          for (int c = 0; c < kPer; c += 4) {
            float cf[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              cf[e] = static_cast<float>((wd[j] >> (Q * (c + e))) & kMask);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              if (r < rows) {
                const float4 av = __ldg(reinterpret_cast<const float4*>(
                    ap + static_cast<long>(r) * n_pad + c));
                part[r] = fmaf(av.x, cf[0], part[r]);
                part[r] = fmaf(av.y, cf[1], part[r]);
                part[r] = fmaf(av.z, cf[2], part[r]);
                part[r] = fmaf(av.w, cf[3], part[r]);
              }
            }
          }
        }
      }
    }
    const float s = col_ok ? scales[static_cast<long>(t) * M + m] : 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      acc[r] = fmaf(part[r] - static_cast<float>(zero) * sa[r], s, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) s_part[warp][r][lane] = acc[r];
  __syncthreads();
  // warp r sums row r over the warps, in warp order
  if (warp < rows && col_ok) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += s_part[w][warp][lane];
    out[static_cast<long>(row0 + warp) * M + m] = o;
  }
}

template <int Q>
int launch(const void* a, const void* words, const void* scales, void* out,
           int B, int n_pad, int W, int M, int zero, int bn,
           cudaStream_t stream) {
  const dim3 grid((M + 31) / 32, (B + kRows - 1) / kRows);
  quant_matmul_kernel<Q><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const uint32_t*>(words),
      static_cast<const float*>(scales), static_cast<float*>(out), B, n_pad,
      W, M, zero, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q in {1, 2, 4, 8}; bn a multiple of 32 (so of 32 / q) dividing n_pad
extern "C" int quant_matmul_launch(const void* a, const void* words,
                                   const void* scales, void* out, int B,
                                   int n_pad, int W, int M, int q, int zero,
                                   int bn, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q) {
    case 1:
      return launch<1>(a, words, scales, out, B, n_pad, W, M, zero, bn, st);
    case 2:
      return launch<2>(a, words, scales, out, B, n_pad, W, M, zero, bn, st);
    case 4:
      return launch<4>(a, words, scales, out, B, n_pad, W, M, zero, bn, st);
    case 8:
      return launch<8>(a, words, scales, out, B, n_pad, W, M, zero, bn, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
