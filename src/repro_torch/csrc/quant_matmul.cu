// B5 quant_matmul — replaces the TPU kernel `quant_matmul_pallas` /
// `_qmm_kernel` (src/repro/kernels/quant_matmul/kernel.py): the
// processor-side (llama.cpp-style) low-bit GeMV the paper compares MVDRAM
// against. Float activations × q-bit weight codes packed 32/q to a 32-bit
// word along N, dequantized as (code − zero)·scale of the reduction tile,
// summed in f32 (the JAX dot is Precision.HIGHEST: no TF32 and no tensor
// cores here either).
//
// Bound. At decode (B = 4 rows) a q2 layer's packed codes are N·M/4 bytes
// (4.2 MB for 4096×4096, 3.35 TB/s → 1.25 µs), while its 2·B·N·M f32
// operations on CUDA cores take 2.0 µs at 67 TFLOP/s: the operations bound
// it, by a little. So the design spends as few instructions per weight as
// it can, and keeps enough loads in flight to stay near the byte rate.
//
// Design (B3's, `bitplane_gemv.cu`, on packed codes instead of planes):
//  * Work items. A lane owns 4 neighbouring output columns and loads a
//    word of them as one 16-byte int4; a warp covers a strip of 128
//    columns. A work item is a unit of kUnit words of one reduction tile
//    (4·32/q reduction rows): the warp issues the unit's kUnit word loads,
//    the tile's scales and the unit's activations before any arithmetic.
//    A block of 8 warps owns one strip, 4 batch rows (grid.z) and
//    `tiles_per_block` consecutive tiles (grid.y splits the tiles, by the
//    wrapper's plan, bitplane_gemv/kernel.py `split_plan`); its warps take
//    the items of those tiles in turn.
//  * Activations. The unit's rows are staged once in shared memory as
//    float4s of the 4 batch rows: one broadcast load feeds 4 columns × 4
//    rows.
//  * No conversion instruction. The code of row j of a word is
//    c = (w >> q·j) & mask, and c − zero = as_float(0x4B000000 | c) −
//    (2^23 + zero), exact: one shift, one logic op and one subtraction,
//    then one f32 FMA per weight and batch row. The tile's scale multiplies
//    each unit's sum once.
//  * Fold. With one split (no workspace) the block writes the sum of its
//    warps' partials in warp order; with several, each split writes its
//    partial to a (splits, B, M) workspace and a second small launch sums
//    them in split order: deterministic, no atomics.
//  * Ragged edges. Words past the leaf's last one are not read (their
//    activations are the zero padding); columns past M load as zero and
//    are not stored; batch rows past B are not stored. M not a multiple of
//    4 (or words, scales not 16-byte aligned) takes scalar loads.
//
// The launch function returns cudaGetLastError() after its launches; the
// Python wrapper raises on anything but 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;             // output columns per lane
constexpr int kStrip = 32 * kCols;   // output columns per block
constexpr int kRows = 4;             // batch rows per block (grid.z)
constexpr int kOut = kRows * kStrip;
constexpr int kUnit = 4;             // words per work item
constexpr int kMaxUnitRows = kUnit * 32;  // at q = 1
constexpr float kMagic = 8388608.f;  // as_float(0x4B000000 | c) = 2^23 + c

struct Smem {
  float4 act[kWarps][kMaxUnitRows];  // the unit's rows, 4 batch rows each
  float part[kWarps][kOut];          // each warp's partial
};

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

__device__ __forceinline__ uint32_t geti(const int4& v, int i) {
  return static_cast<uint32_t>(i == 0 ? v.x : i == 1 ? v.y
                                                     : i == 2 ? v.z : v.w);
}

// a (B, n_pad) f32, zero-padded; words (W, M) int32 with W ≤ n_pad / per;
// scales (n_pad / bn, M) f32 → out (B, M) f32, or with a workspace each
// split's partial to ws (splits, B, M). Grid (ceil(M / 128), splits,
// ceil(B / 4)).
template <int Q>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const float* __restrict__ a,
                    const int32_t* __restrict__ words,
                    const float* __restrict__ scales,
                    float* __restrict__ out, float* __restrict__ ws, int B,
                    int n_pad, int W, int M, int zero, int bn,
                    int tiles_per_block) {
  constexpr int kPer = 32 / Q;                     // codes per word
  constexpr uint32_t kMask = (1u << Q) - 1u;
  constexpr int kUnitRows = kUnit * kPer;          // reduction rows a unit
  constexpr int kActs = (kUnitRows + 31) / 32;     // rows a lane stages
  __shared__ Smem sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x * kStrip + lane * kCols;
  const int row0 = blockIdx.z * kRows;
  const int tiles = n_pad / bn;
  const int wpt = bn / kPer;                       // words per tile
  const int upt = (wpt + kUnit - 1) / kUnit;       // items per tile
  const int t_begin = blockIdx.y * tiles_per_block;
  const int nt = min(tiles_per_block, tiles - t_begin);
  const bool vec = (M % kCols) == 0
                   && (reinterpret_cast<uintptr_t>(words) & 15) == 0
                   && (reinterpret_cast<uintptr_t>(scales) & 15) == 0;
  const float bias = kMagic + static_cast<float>(zero);
  float4* act = sm.act[warp];

  float fpart[kRows][kCols];                       // Σ scale·Σ a·(c − zero)
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) fpart[r][c] = 0.f;

  for (int it = warp; it < nt * upt; it += kWarps) {
    const int tl = it / upt;
    const int t = t_begin + tl;
    const int w0 = t * wpt + (it - tl * upt) * kUnit;
    const int live = min(min(kUnit, (t + 1) * wpt - w0), W - w0);
    if (live <= 0) continue;                       // padding words only
    // every load of the unit first: its words, the tile's scales, then
    // the activations of its rows
    int4 wd[kUnit];
#pragma unroll
    for (int u = 0; u < kUnit; ++u)
      wd[u] = u < live ? load4(words + static_cast<long long>(w0 + u) * M
                                   + m, m, M, vec)
                       : make_int4(0, 0, 0, 0);
    const float4 sc = load4f(scales + static_cast<long long>(t) * M + m, m,
                             M, vec);
    const int rows = live * kPer;                  // live reduction rows
    float av[kActs][kRows];
#pragma unroll
    for (int k = 0; k < kActs; ++k)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = k * 32 + lane;
        const int row = row0 + r;
        av[k][r] = j < rows && row < B
                       ? a[static_cast<long long>(row) * n_pad
                           + static_cast<long long>(w0) * kPer + j]
                       : 0.f;
      }
    __syncwarp();                                  // last item's reads done
#pragma unroll
    for (int k = 0; k < kActs; ++k) {
      const int j = k * 32 + lane;
      if (j < kUnitRows)
        act[j] = make_float4(av[k][0], av[k][1], av[k][2], av[k][3]);
    }
    __syncwarp();

    float acc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
#pragma unroll
    for (int u = 0; u < kUnit; ++u) {
      if (u < live) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float4 x = act[u * kPer + j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const uint32_t code =
                0x4B000000u | ((geti(wd[u], c) >> (Q * j)) & kMask);
            const float f = __uint_as_float(code) - bias;   // c − zero
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

#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      sm.part[warp][r * kStrip + lane * kCols + c] = fpart[r][c];
  __syncthreads();
  // one thread per (row, column) of the block's output, warps in order
  for (int o = threadIdx.x; o < kOut; o += kThreads) {
    const int r = o / kStrip, col = o % kStrip;
    const int row = row0 + r, mc = blockIdx.x * kStrip + col;
    if (row >= B || mc >= M) continue;
    float y = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) y += sm.part[w][o];
    const long long at = static_cast<long long>(row) * M + mc;
    if (ws == nullptr)
      out[at] = y;
    else
      ws[static_cast<long long>(blockIdx.y) * B * M + at] = y;
  }
}

// out = Σ_s part_s in split order. part (splits, B, M) f32.
__global__ void fold_kernel(const float* __restrict__ part,
                            float* __restrict__ out, long long BM,
                            int splits) {
  const long long o =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= BM) return;
  float y = 0.f;
  for (int s = 0; s < splits; ++s) y += part[s * BM + o];
  out[o] = y;
}

}  // namespace

// q in {1, 2, 4, 8}; bn a multiple of 32 (so of 32 / q) dividing n_pad;
// splits = ceil(tiles / tiles_per_block); ws (splits, B, M) f32, or null
// with one split.
extern "C" int quant_matmul_launch(const void* a, const void* words,
                                   const void* scales, void* out, void* ws,
                                   int B, int n_pad, int W, int M, int q,
                                   int zero, int bn, int tiles_per_block,
                                   int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = bn > 0 ? n_pad / bn : 0;
  if (bn <= 0 || bn % 32 || n_pad % bn || tiles_per_block < 1
      || splits != (tiles + tiles_per_block - 1) / tiles_per_block
      || (splits > 1) != (ws != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kStrip - 1) / kStrip, splits, (B + kRows - 1) / kRows);
  const auto* pa = static_cast<const float*>(a);
  const auto* pw = static_cast<const int32_t*>(words);
  const auto* ps = static_cast<const float*>(scales);
  auto* po = static_cast<float*>(out);
  auto* pws = static_cast<float*>(ws);
#define QMM_CASE(QQ)                                                        \
  case QQ:                                                                  \
    quant_matmul_kernel<QQ><<<grid, kThreads, 0, st>>>(                     \
        pa, pw, ps, po, pws, B, n_pad, W, M, zero, bn, tiles_per_block);    \
    break;
  switch (q) {
    QMM_CASE(1) QMM_CASE(2) QMM_CASE(4) QMM_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QMM_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return static_cast<int>(err);
  const long long bm = static_cast<long long>(B) * M;
  fold_kernel<<<static_cast<int>((bm + 255) / 256), 256, 0, st>>>(
      pws, po, bm, splits);
  return static_cast<int>(cudaGetLastError());
}
