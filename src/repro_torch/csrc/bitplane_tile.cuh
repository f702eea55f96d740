// Device code of the integer bit-plane GeMV kernel B2 program_gemv: one
// warp computes the exact integer zero-point correction of one reduction
// tile for 32 output columns, one per lane.
//
// Layouts are the JAX package's: weight planes are 32-row words, bit j of
// word w is reduction row 32w + j, and neighbouring output columns sit at
// neighbouring addresses, so a warp's 32 lanes load one plane word each in
// one coalesced 128-byte transaction.
//
// The integer dot is the paper's bit-serial form. The tile's activation
// codes are decomposed on the fly into p packed planes (lane j holds the
// code of row 32w + j; __ballot_sync gathers bit k of all 32 lanes into one
// word, exactly the weight planes' layout), and then
//     acc     += 2^(i+k) · popc(a_k[w] & W_i[w, m])
//     col_sum += 2^i     · popc(W_i[w, m])
// Every quantity is an exact int32 (|acc| ≤ 255·255·512 < 2^31).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bitplane {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;      // warps per block, one reduction tile each
constexpr int kRows = 8;       // activation rows per block (= kWarps: warp r
                               // runs row r's epilogue)
constexpr int kMaxWords = 16;  // words per reduction tile: bn <= 512
constexpr int kMaxBits = 8;    // q, p <= 8

struct IntTileSmem {
  uint32_t bits[kWarps][kRows][kMaxBits][kMaxWords];  // activation planes
  int sum_a[kWarps][kRows];                           // Σ codes per row
  int corr[kWarps][kRows][32];                        // per-tile result
};

// codes:     row 0's first code of the tile; row r at codes + r*code_stride
// plane_col: plane 0, word 0 of the tile at this lane's column; plane i,
//            word w at plane_col[i*plane_stride + w*word_stride]. Only
//            words w < valid_words exist, and only if col_ok; the rest
//            read as zero bits (the padding of a ragged tile or strip).
// bn:        the width that enters the epilogue's bn·z_a·z_w term
// Writes the tile's correction for rows [0, rows) to sm.corr[warp].
__device__ __forceinline__ void int_tile(
    const uint8_t* codes, long code_stride, int rows,
    const int32_t* plane_col, long plane_stride, long word_stride,
    int words, int valid_words, bool col_ok, int q, int p, int z_a,
    int z_w, int bn,
    IntTileSmem& sm, int warp, int lane) {
  for (int r = 0; r < rows; ++r) {
    int s = 0;
    for (int w = 0; w < words; ++w) {
      const uint32_t c = codes[r * code_stride + w * 32 + lane];
      s += static_cast<int>(c);
      for (int k = 0; k < p; ++k) {
        const uint32_t word = __ballot_sync(kFull, (c >> k) & 1u);
        if (lane == 0) sm.bits[warp][r][k][w] = word;
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) sm.sum_a[warp][r] = s;
  }
  __syncwarp();

  int acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0;
  int col_sum = 0;
  const int live_words = col_ok ? valid_words : 0;
  for (int w = 0; w < live_words; ++w) {
    for (int i = 0; i < q; ++i) {
      const uint32_t wi = static_cast<uint32_t>(
          plane_col[i * plane_stride + w * word_stride]);
      col_sum += __popc(wi) << i;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          for (int k = 0; k < p; ++k)
            acc[r] += __popc(sm.bits[warp][r][k][w] & wi) << (i + k);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < rows)
      sm.corr[warp][r][lane] = acc[r] - z_a * col_sum
                               - z_w * sm.sum_a[warp][r] + bn * z_a * z_w;
  }
}

// Folds tiles [t0, t0 + n) of this block's chunk into row `warp`'s output
// in ascending tile order, one fused multiply-add each — the rounding the
// plain versions (ref.py) and XLA on the CPU take. Tile t0 + j's scale for
// this lane's column is scale0[j * scale_stride].
__device__ __forceinline__ float int_epilogue(const IntTileSmem& sm, int n,
                                              const float* scale0,
                                              long scale_stride, int warp,
                                              int lane, float out) {
  for (int j = 0; j < n; ++j)
    out = __fmaf_rn(__int2float_rn(sm.corr[j][warp][lane]),
                    scale0[j * scale_stride], out);
  return out;
}

}  // namespace bitplane
