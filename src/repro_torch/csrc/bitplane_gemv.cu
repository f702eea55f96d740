// Per-leaf bit-plane GeMV kernels for Hopper (sm_90a).
//
// B1 gemv_bs — replaces the TPU kernel `gemv_bs_pallas` / `_gemv_bs_kernel`
//   (src/repro/kernels/bitplane_gemv/kernel.py): integer activation codes ×
//   packed weight planes, per-tile zero-point correction, f32 scaling.
// B3 gemv_f  — replaces `gemv_f_pallas` / `_gemv_f_kernel` (same file):
//   float activations × packed weight planes.
//
// Bound. At decode (B = 4 rows) B1 is bound by bytes: each call must read
// the packed planes once, q·N·M/8 bytes (4 MiB for a 4096×4096 q2 layer,
// 32.8 MB for the 4096→32000 lm_head), and little else. B3's 2·B·N·M f32
// multiply-adds on CUDA cores (67 TFLOP/s) take longer than its bytes.
// Either way the time goes to memory round trips unless many loads are in
// flight, and then to unpacking bits and to multiply-adds.
//
// Design.
//  * Work items. A lane owns 4 neighbouring output columns and loads a
//    plane word of them as one 16-byte int4 (a warp reads 512 contiguous
//    bytes per plane word); a warp covers a strip of 128 columns. A work
//    item is a unit of U = max(1, 4/q) words of one reduction tile of the
//    strip: the warp issues all q·U plane loads of the unit, and loads its
//    activations, before any arithmetic. A block of 8 warps owns one strip,
//    4 batch rows (grid.z) and `tiles_per_block` consecutive tiles (grid.y
//    splits the tiles); its warps take the items of those tiles in turn.
//    The split is the wrapper's plan (kernel.py `split_plan`), chosen so
//    that every shape runs several blocks per SM.
//  * B3: folded codes. Per weight the q plane bits are assembled into the
//    code c in a register, and c − zero becomes a float without a
//    conversion instruction: as_float(0x4B000000 | c) − (2^23 + zero). Each
//    weight then costs one f32 FMA per batch row against activations that
//    the warp stages once per unit in shared memory as float4s of 4 batch
//    rows (one broadcast load per reduction row). With the zero point
//    inside the product, Σ a·(c − zero) over a tile is its correction
//    acc − zero·Σa; each unit's sum is multiplied by its tile's scale at
//    once (the sum order is free within rtol 1e-5).
//  * B1: byte dot products. The unit's codes (masked to p bits) are staged
//    as bytes, 4 reduction rows to a word per batch row; the weight codes
//    of 4 rows are spread into the bytes of a word (nibble · 0x00204081
//    puts bit k at bit 8k, one multiply per plane) and one dp4a per batch
//    row adds 4 products. A unit's correction is then the exact integer
//    Σ (a − z_a)(w − z_w) = Σaw − z_w·Σa − z_a·Σw + rows·z_a·z_w (Σa by a
//    warp reduction, Σw by popcounts), added into its tile's correction in
//    shared memory: integer adds, so any order gives the same integer.
//    Over a tile it is exactly the reference's acc − z_a·col_sum − z_w·Σa
//    + bn·z_a·z_w, padding included (a padded row has a = z_a, w = 0).
//  * Fold. With one split (no workspace given) a block owns every tile of
//    its strip and writes the output: B3 the sum of its warps' partials in
//    warp order, B1 the epilogue out = fma(f32(corr_t), scale_t, out) in
//    ascending tile order, bitwise the plain version's. Given a workspace,
//    the blocks write to it (B3 each split's partial, (splits, B, M); B1
//    each tile's correction, (tiles, B, M)) and a second small launch folds
//    it in the same fixed order: deterministic, no atomics on floats. The
//    wrapper passes one exactly when the plan has several splits.
//  * Ragged edges. Words past the leaf's last one are zero bits and are not
//    read; columns past M load as zero and are not stored; batch rows past
//    B are not stored. Planes are read unpadded. M not a multiple of 4 (or
//    planes not 16-byte aligned) takes scalar loads.
//
// B2 (program_gemv.cu) keeps the tile core of bitplane_tile.cuh.
//
// Launch functions return cudaGetLastError() after their launches; the
// Python wrapper raises on anything but 0.

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;            // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;             // output columns per lane
constexpr int kStrip = 32 * kCols;   // output columns per block
constexpr int kRows = 4;             // batch rows per block (grid.z)
constexpr int kOut = kRows * kStrip; // outputs of a block's strip
constexpr int kMaxUnit = 4;          // words per work item
constexpr int kMaxTiles = 8;         // tiles per block (B1's shared sums)
constexpr float kMagic = 8388608.f;  // as_float(0x4B000000 | c) = 2^23 + c

__host__ __device__ constexpr int unit_words(int q) {
  return q >= 4 ? 1 : 4 / q;
}

struct Smem {
  union {
    float4 f[kWarps][kMaxUnit * 32];            // B3: activations, 4 rows
    uint32_t i[kWarps][kMaxUnit * 8][kRows];    // B1: codes, 4 to a word
  } act;
  union {
    float part[kWarps][kOut];                   // B3: each warp's partial
    int corr[kMaxTiles][kOut];                  // B1: each tile's correction
  };
};

// 4 int32 words at p[0..3] (columns m..m+3), zero past M
__device__ __forceinline__ int4 load4(const int32_t* p, int m, int M,
                                      bool vec) {
  if (vec) return m < M ? __ldg(reinterpret_cast<const int4*>(p))
                        : make_int4(0, 0, 0, 0);
  int v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) v[c] = m + c < M ? __ldg(p + c) : 0;
  return make_int4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float4 load4f(const float* p, int m, int M,
                                         bool vec) {
  if (vec) return m < M ? __ldg(reinterpret_cast<const float4*>(p))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  float v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) v[c] = m + c < M ? __ldg(p + c) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename V>
__device__ __forceinline__ uint32_t geti(const V& v, int i) {
  return static_cast<uint32_t>(i == 0 ? v.x : i == 1 ? v.y
                                                     : i == 2 ? v.z : v.w);
}

// One block: strip blockIdx.x of 128 columns, tiles [t_begin, t_begin +
// nt) with t_begin = blockIdx.y·tiles_per_block, batch rows 4·blockIdx.z +
// [0, 4). a: B3 (B, n_pad) f32, B1 (B, n_pad) uint8 codes; planes (q,
// n_words, M) int32; scales (n_pad/bn, M) f32; out (B, M) f32. ws: null
// when one block owns every tile of a strip (gridDim.y = 1) and writes
// out, else B3 (splits, B, M) f32 and B1 (tiles, B, M) int32.
template <int Q, bool kInt>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const void* __restrict__ a, const int32_t* __restrict__ planes,
            const float* __restrict__ scales, float* __restrict__ out,
            void* __restrict__ ws, int B, int n_pad, int n_words, int M,
            int bn, int mask, int z_a, int zero, int tiles_per_block) {
  constexpr int U = unit_words(Q);
  static_assert(U <= kMaxUnit, "unit too wide for the staging buffer");
  __shared__ Smem sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kStrip + lane * kCols;
  const int row0 = blockIdx.z * kRows;
  const int tiles = n_pad / bn;
  const int wpt = bn >> 5;                          // words per tile
  const int upt = (wpt + U - 1) / U;                // items per tile
  const int t_begin = blockIdx.y * tiles_per_block;
  const int nt = min(tiles_per_block, tiles - t_begin);
  const long plane_stride = static_cast<long>(n_words) * M;
  const bool vec = (M % kCols) == 0
                   && (reinterpret_cast<uintptr_t>(planes) & 15) == 0
                   && (reinterpret_cast<uintptr_t>(scales) & 15) == 0;

  float4* act_f = sm.act.f[warp];
  uint32_t* act_i = &sm.act.i[warp][0][0];
  int* corr = &sm.corr[0][0];

  if (kInt) {
    for (int i = threadIdx.x; i < nt * kOut; i += kThreads) corr[i] = 0;
    __syncthreads();
  }
  float fpart[kRows][kCols];                        // B3: Σ scale·corr
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) fpart[r][c] = 0.f;

  for (int it = warp; it < nt * upt; it += kWarps) {
    const int tl = it / upt;
    const int t = t_begin + tl;
    const int w0 = t * wpt + (it - tl * upt) * U;
    const int live = min(min(U, (t + 1) * wpt - w0), n_words - w0);
    if (live <= 0) continue;                        // padding words only
    // every load of the unit first: q·U plane words, then activations
    uint32_t wd[U][Q][kCols];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        int4 v = make_int4(0, 0, 0, 0);
        if (u < live)
          v = load4(planes + i * plane_stride
                        + static_cast<long>(w0 + u) * M + m, m, M, vec);
#pragma unroll
        for (int c = 0; c < kCols; ++c) wd[u][i][c] = geti(v, c);
      }
    // B3: the tile's scales, loaded beside the planes
    const float4 sc = kInt ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : load4f(scales + static_cast<long>(t) * M + m,
                                    m, M, vec);
    // B1 the codes, B3 the floats of row 32(w0 + u) + lane
    using Act = std::conditional_t<kInt, int, float>;
    Act av[U][kRows];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        av[u][r] = 0;
        const int row = row0 + r;
        if (u < live && row < B) {
          const long at = static_cast<long>(row) * n_pad
                          + static_cast<long>(w0 + u) * 32 + lane;
          if constexpr (kInt)
            av[u][r] = static_cast<const uint8_t*>(a)[at] & mask;
          else
            av[u][r] = static_cast<const float*>(a)[at];
        }
      }
    __syncwarp();                                  // last item's reads done

    if constexpr (kInt) {
      // codes as bytes: act_i[u·8 + j/4][r] holds rows 4(j/4)..+3 of row r
      uint8_t* bytes = reinterpret_cast<uint8_t*>(act_i);
      int sum_a[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sum_a[r] = 0;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < live) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int v = av[u][r];
            bytes[((u * 8 + (lane >> 2)) * kRows + r) * 4 + (lane & 3)] =
                static_cast<uint8_t>(v);
            sum_a[r] += __reduce_add_sync(kFull, v);
          }
        }
      }
      __syncwarp();
      uint32_t acc[kRows][kCols];
      int sum_w[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        sum_w[c] = 0;
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][c] = 0u;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < live) {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
#pragma unroll
            for (int i = 0; i < Q; ++i) sum_w[c] += __popc(wd[u][i][c]) << i;
#pragma unroll
          for (int j4 = 0; j4 < 8; ++j4) {
            const uint4 x =
                reinterpret_cast<const uint4*>(act_i)[u * 8 + j4];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              uint32_t wb = 0;                      // codes of 4 rows
#pragma unroll
              for (int i = 0; i < Q; ++i)
                wb |= (((wd[u][i][c] >> (4 * j4)) & 0xFu)
                       * (0x00204081u << i)) & (0x01010101u << i);
#pragma unroll
              for (int r = 0; r < kRows; ++r)
                acc[r][c] = __dp4a(geti(x, r), wb, acc[r][c]);
            }
          }
        }
      }
      const int rows_zz = 32 * live * z_a * zero;   // zero is z_w here
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          atomicAdd(&corr[tl * kOut + r * kStrip + lane * kCols + c],
                    static_cast<int>(acc[r][c]) - zero * sum_a[r]
                        - z_a * sum_w[c] + rows_zz);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        act_f[u * 32 + lane] =
            make_float4(av[u][0], av[u][1], av[u][2], av[u][3]);
      __syncwarp();
      const float bias = kMagic + static_cast<float>(zero);
      float acc[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < live) {
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const float4 x = act_f[u * 32 + j];
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              uint32_t code = 0x4B000000u;
#pragma unroll
              for (int i = 0; i < Q; ++i)
                code |= j >= i ? (wd[u][i][c] >> (j - i)) & (1u << i)
                               : (wd[u][i][c] << (i - j)) & (1u << i);
              const float f = __uint_as_float(code) - bias;  // c − zero
#pragma unroll
              for (int r = 0; r < kRows; ++r)
                acc[r][c] = fmaf(get(x, r), f, acc[r][c]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          fpart[r][c] = fmaf(acc[r][c], get(sc, c), fpart[r][c]);
    }
  }

  if constexpr (!kInt) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        sm.part[warp][r * kStrip + lane * kCols + c] = fpart[r][c];
  }
  __syncthreads();
  // one thread per (row, column) of the block's output
  const bool whole = ws == nullptr;        // the block owns every tile
  for (int o = threadIdx.x; o < kOut; o += kThreads) {
    const int r = o / kStrip, col = o % kStrip;
    const int row = row0 + r, mc = blockIdx.x * kStrip + col;
    if (row >= B || mc >= M) continue;
    const long at = static_cast<long>(row) * M + mc;
    if constexpr (kInt) {
      if (whole) {
        float y = 0.f;
        for (int tl = 0; tl < nt; ++tl)
          y = __fmaf_rn(__int2float_rn(corr[tl * kOut + o]),
                        scales[static_cast<long>(tl) * M + mc], y);
        out[at] = y;
      } else {
        for (int tl = 0; tl < nt; ++tl)
          static_cast<int*>(ws)[static_cast<long>(t_begin + tl) * B * M
                                + at] = corr[tl * kOut + o];
      }
    } else {
      float y = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) y += sm.part[w][o];
      if (whole)
        out[at] = y;
      else
        static_cast<float*>(ws)[static_cast<long>(blockIdx.y) * B * M + at] =
            y;
    }
  }
}

// B1's epilogue over the workspace: out = fma(f32(corr_t), scale_t, out)
// for t = 0, 1, ... in order. corr (tiles, B, M) int32.
__global__ void fold_int_kernel(const int* __restrict__ corr,
                                const float* __restrict__ scales,
                                float* __restrict__ out, int B, int M,
                                int tiles) {
  const long o = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= static_cast<long>(B) * M) return;
  const int mc = static_cast<int>(o % M);
  float y = 0.f;
  for (int t = 0; t < tiles; ++t)
    y = __fmaf_rn(__int2float_rn(corr[static_cast<long>(t) * B * M + o]),
                  scales[static_cast<long>(t) * M + mc], y);
  out[o] = y;
}

// B3's fold: out = Σ_s part_s in split order. part (splits, B, M) f32.
__global__ void fold_float_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, long BM,
                                  int splits) {
  const long o = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= BM) return;
  float y = 0.f;
  for (int s = 0; s < splits; ++s) y += part[s * BM + o];
  out[o] = y;
}

template <bool kInt>
int launch(const void* a, const void* planes, const void* scales, void* out,
           void* ws, int B, int n_pad, int n_words, int M, int q, int bn,
           int mask, int z_a, int zero, int tiles_per_block, int splits,
           cudaStream_t stream) {
  const int tiles = bn > 0 ? n_pad / bn : 0;
  if (q < 1 || q > 8 || bn % 32 || bn <= 0 || n_pad % bn
      || tiles_per_block < 1 || tiles_per_block > kMaxTiles
      || splits != (tiles + tiles_per_block - 1) / tiles_per_block
      || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kStrip - 1) / kStrip, splits, (B + kRows - 1) / kRows);
  const auto* p = static_cast<const int32_t*>(planes);
  const auto* s = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
#define GEMV_CASE(QQ)                                                       \
  case QQ:                                                                  \
    gemv_kernel<QQ, kInt><<<grid, kThreads, 0, stream>>>(                   \
        a, p, s, o, ws, B, n_pad, n_words, M, bn, mask, z_a, zero,          \
        tiles_per_block);                                                   \
    break;
  switch (q) {
    GEMV_CASE(1) GEMV_CASE(2) GEMV_CASE(3) GEMV_CASE(4)
    GEMV_CASE(5) GEMV_CASE(6) GEMV_CASE(7) GEMV_CASE(8)
  }
#undef GEMV_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return static_cast<int>(err);
  const long bm = static_cast<long>(B) * M;
  const int blocks = static_cast<int>((bm + 255) / 256);
  if (kInt)
    fold_int_kernel<<<blocks, 256, 0, stream>>>(static_cast<const int*>(ws),
                                                s, o, B, M, tiles);
  else
    fold_float_kernel<<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(ws), o, bm, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// codes (B, n_pad) uint8 (p-bit codes, padded with z_a); planes (q,
// n_words, M) int32 with n_words ≤ n_pad/32; scales (n_pad/bn, M) f32 →
// out (B, M) f32; splits = ceil(tiles / tiles_per_block). ws: (tiles, B,
// M) int32, or null with one split (the blocks then write out themselves).
extern "C" int gemv_bs_launch(const void* codes, const void* planes,
                              const void* scales, void* out, void* ws,
                              int B, int n_pad, int n_words, int M, int q,
                              int p, int z_a, int z_w, int bn,
                              int tiles_per_block, int splits,
                              void* stream) {
  if (p < 1 || p > 8) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(codes, planes, scales, out, ws, B, n_pad, n_words, M,
                      q, bn, (1 << p) - 1, z_a, z_w, tiles_per_block, splits,
                      static_cast<cudaStream_t>(stream));
}

// a (B, n_pad) f32 padded with 0; planes, scales and the split as gemv_bs
// → out (B, M) f32. ws: (splits, B, M) f32, or null with one split.
extern "C" int gemv_f_launch(const void* a, const void* planes,
                             const void* scales, void* out, void* ws, int B,
                             int n_pad, int n_words, int M, int q, int zero,
                             int bn, int tiles_per_block, int splits,
                             void* stream) {
  return launch<false>(a, planes, scales, out, ws, B, n_pad, n_words, M, q,
                       bn, 0, 0, zero, tiles_per_block, splits,
                       static_cast<cudaStream_t>(stream));
}
