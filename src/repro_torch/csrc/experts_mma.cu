// B3 over an expert stack with bf16 activations, on the tensor cores —
// replaces, for the MoE path's bf16 stacks, the JAX package's `jax.vmap`
// of `gemv_f_pallas` / `_gemv_f_kernel` over the routed experts
// (src/repro/models/moe.py, `_expert_mm`; src/repro/kernels/bitplane_gemv/
// kernel.py). f32 stacks run B3's block body (`bitplane_gemv.cu`,
// `experts_kernel`).
//
// Bound. qwen2-moe (64 experts × 8 capacity rows, 2048→1408 and
// 1408→2048, q4): at full capacity 92 MB of planes a matrix (0.0275 ms at
// 3.35 TB/s), against 2.95 GFLOP at the bf16 tensor-core rate (0.003 ms):
// bytes. At a decode step only the ≤ 16 experts with rows need their
// planes read (≈ 0.007 ms). What stands between is unpacking the planes
// into bf16 on the CUDA cores.
//
// The launch function returns cudaGetLastError() after its launches; the
// Python wrapper raises on anything but 0.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemv_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B3 over an expert stack with bf16 activations, on the tensor cores
// (`experts_mma_kernel`). The activations are read in place, unpadded;
// the weights are unpacked from the q plane words straight into the A
// fragments of mma.m16n8k16 (bf16 × bf16 → f32); every product
// a·(c − zero) is exact (c − zero has at most 8 significant bits, a bf16
// 8), so only the order of the f32 sums differs from JAX's f32-HIGHEST
// dot.
//  * Fragments. A warp covers a 128-column strip as 8 m-tiles of 16
//    columns; lane (g, t) = (lane / 4, lane % 4) loads the plane words of
//    columns 16g + 4t .. +3 as one 16-byte int4 (a warp reads 512
//    contiguous bytes a plane word), and m-tile j maps its A rows g and
//    g + 8 to columns 16g + 2j and 16g + 2j + 1 of group g, which two
//    shuffles fetch from lane 4g + j/2. The reduction order inside a word
//    is permuted so that lane t's k-slots of both k16 chunks are bits
//    8t .. 8t + 7 of the word (chunk kc: bits 8t + 4kc + {0, 1} as k =
//    2t, 2t + 1 and + {2, 3} as k = 2t + 8, 2t + 9): its B fragments are
//    then 8 consecutive bf16 of one activation row, one 16-byte load a
//    word, and its codes one nibble of the word per chunk, spread into
//    bytes by one multiply per plane (B1's nibble · 0x00204081), turned
//    into bf16 (128 + c) by a byte permute and into c − zero by one bf16x2
//    subtraction (q = 8: the top bit apart, added back by an exact fma).
//  * Rows. Up to 8 rows (the 8 capacity rows of qwen2-moe) are one
//    n-tile, 9–16 two n-tiles on the same A fragments: the expert's planes
//    are read once for all its rows. A block takes a chunk of 16 rows;
//    R > 16 takes more chunks (grid.z), each reading the planes again.
//  * The plan over the experts a step can route. grid.z walks `live`
//    slots (the caller's bound on experts with rows, e.g. min(E, tokens ·
//    top_k)), not all E: a block's expert is the slot-th with counts[e] >
//    0, found by a warp ballot over counts in device memory (no host
//    sync); blocks past the experts with rows exit. With one split, each
//    block also writes zeros for the experts without rows whose rank ≡
//    slot (mod live); with several, the fold writes them.
//  * Sums. Each warp item (U words of one reduction tile) runs its mma
//    chain from a fresh zero accumulator (at most 4 k16 chunks), then
//    adds it times the tile's column scale into the lane's f32 partials;
//    the block's 8 warps add their partials in warp order, and the fold
//    adds the splits in split order: deterministic, no atomics.
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 16;        // batch rows of a block (2 n-tiles)
constexpr int kMaxExperts = 256;    // experts a launch scans for rows
constexpr int kExpertWords = kMaxExperts / 32;

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t x, uint32_t y) {
  __nv_bfloat162 a, b;
  memcpy(&a, &x, 4);
  memcpy(&b, &y, 4);
  const __nv_bfloat162 r = __hsub2(a, b);
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t x, uint32_t y,
                                               uint32_t z) {
  __nv_bfloat162 a, b, c;
  memcpy(&a, &x, 4);
  memcpy(&b, &y, 4);
  memcpy(&c, &z, 4);
  const __nv_bfloat162 r = __hfma2(a, b, c);
  uint32_t out;
  memcpy(&out, &r, 4);
  return out;
}

constexpr uint32_t kBf16x2_128 = 0x43004300u;   // (128, 128) in bf16

// bytes c0..c3 (codes of q bits) → the bf16x2 pairs (c0, c1) − zero and
// (c2, c3) − zero; bias = (128 + zero) twice in bf16. bf16 (0x43 << 8 | c)
// is 128 + c for c < 128.
template <int Q>
__device__ __forceinline__ void codes_to_bf16(uint32_t c, uint32_t bias,
                                              uint32_t& p01,
                                              uint32_t& p23) {
  if constexpr (Q <= 7) {
    p01 = bf16x2_sub(__byte_perm(c, 0x43434343u, 0x4140), bias);
    p23 = bf16x2_sub(__byte_perm(c, 0x43434343u, 0x4342), bias);
  } else {                       // c7 − zero, plus 128 · bit 7 (exact)
    const uint32_t lo = c & 0x7F7F7F7Fu, hi = (c >> 7) & 0x01010101u;
    p01 = bf16x2_fma(
        bf16x2_sub(__byte_perm(hi, 0x43434343u, 0x4140), kBf16x2_128),
        kBf16x2_128,
        bf16x2_sub(__byte_perm(lo, 0x43434343u, 0x4140), bias));
    p23 = bf16x2_fma(
        bf16x2_sub(__byte_perm(hi, 0x43434343u, 0x4342), kBf16x2_128),
        kBf16x2_128,
        bf16x2_sub(__byte_perm(lo, 0x43434343u, 0x4342), bias));
  }
}

// 8 bf16 of an activation row at p, of which the first `valid` lie below
// N (the rest read as zero); vec: one 16-byte load when all 8 are valid
__device__ __forceinline__ uint4 load_act8(const __nv_bfloat16* p,
                                           int valid, bool vec) {
  if (valid <= 0) return make_uint4(0, 0, 0, 0);
  if (vec && valid >= 8) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < valid) w[e >> 1] |= static_cast<uint32_t>(__ldg(h + e))
                                << (16 * (e & 1));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

enum : int { kVecPlanes = 1, kVecScales = 2, kVecAct = 4 };

// a (E, R, N) bf16; planes (E, Q, W, M) int32; expert e's tile t scale of
// column c at scales[e·scale_expert + t·scale_tile + c]; counts null
// (every expert all R rows) or (E,); out (E, R, M) f32, or ws (E, splits,
// R, M) f32 when the plan splits. Grid (ceil(M/128), splits, live ·
// chunks); NT n-tiles of 8 rows, chunks = ceil(R / 16).
template <int Q, int NT>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 2 : 1)
experts_mma_kernel(const __nv_bfloat16* __restrict__ a,
                   const int32_t* __restrict__ planes,
                   const float* __restrict__ scales,
                   float* __restrict__ out, float* __restrict__ ws,
                   const int* __restrict__ counts, int E, int R, int N,
                   int W, int M, int zero, int bn, long long scale_expert,
                   int scale_tile, int live, int chunks,
                   int tiles_per_block, int splits, int flags) {
  constexpr int U = Q <= 4 ? 2 : 1;               // words per warp item
  __shared__ unsigned s_live[kExpertWords];
  // the block's sums, lane-major: [C element (j, n, i)][lane], padded
  __shared__ float s_out[8 * (kMmaRows / 8) * 4][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slot = blockIdx.z / chunks;
  const int row0 = (blockIdx.z - slot * chunks) * kMmaRows;
  const int m0 = blockIdx.x * kStrip;
  const int ewords = (E + 31) / 32;

  // the experts with rows, one bit each
  if (warp == 0)
    for (int w = 0; w < ewords; ++w) {
      const int e = w * 32 + lane;
      const unsigned has = __ballot_sync(
          kFull, e < E && (counts == nullptr || counts[e] > 0));
      if (lane == 0) s_live[w] = has;
    }
  __syncthreads();
  int expert = -1;                                 // the slot-th of them
  for (int w = 0, k = slot; w < ewords; ++w) {
    unsigned mk = s_live[w];
    const int pc = __popc(mk);
    if (k < pc) {
      for (int i = 0; i < k; ++i) mk &= mk - 1;
      expert = w * 32 + __ffs(mk) - 1;
      break;
    }
    k -= pc;
  }
  // one split: zeros for the experts without rows of rank ≡ slot
  if (ws == nullptr && counts != nullptr) {
    int rank = 0;
    for (int w = 0; w < ewords; ++w) {
      unsigned dead = ~s_live[w];
      if (w == ewords - 1 && E % 32) dead &= (1u << (E % 32)) - 1u;
      while (dead) {
        const int e = w * 32 + __ffs(dead) - 1;
        dead &= dead - 1;
        if (rank++ % live != slot) continue;
        for (int o = threadIdx.x; o < kMmaRows * kStrip; o += kThreads) {
          const int row = row0 + o / kStrip, col = m0 + o % kStrip;
          if (row < R && col < M)
            out[(static_cast<long long>(e) * R + row) * M + col] = 0.f;
        }
      }
    }
  }
  if (expert < 0) return;                          // block-uniform

  const int rows = counts == nullptr ? R : max(0, min(counts[expert], R));
  const int live_rows = min(rows - row0, 8 * NT);  // ≤ 0: none
  const int wpt = bn >> 5;                         // words per tile
  const int upt = (wpt + U - 1) / U;               // items per tile
  const int tiles = (N + bn - 1) / bn;
  const int t_begin = blockIdx.y * tiles_per_block;
  const int nt = min(tiles_per_block, tiles - t_begin);
  const bool vec_p = flags & kVecPlanes, vec_s = flags & kVecScales,
             vec_a = flags & kVecAct;
  const int32_t* pe = planes + static_cast<long long>(expert) * Q * W * M;
  const __nv_bfloat16* ae =
      a + (static_cast<long long>(expert) * R + row0) * N;
  const float* se = scales + expert * scale_expert + m0 + 16 * g;
  const int m = m0 + kCols * lane;                 // the lane's int4
  uint32_t bias;
  {
    const __nv_bfloat16 b = __float2bfloat16_rn(128.f + zero);
    const __nv_bfloat162 b2 = __halves2bfloat162(b, b);
    memcpy(&bias, &b2, 4);
  }

  float part[8][NT][4];                            // Σ scale · tile sums
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[j][n][i] = 0.f;
  float sc[16];
  int sc_tile = -1;

  const int items = live_rows > 0 && nt > 0 ? nt * upt : 0;
  for (int it = warp; it < items; it += kWarps) {
    const int tl = it / upt;
    const int tt = t_begin + tl;
    const int j0 = (it - tl * upt) * U;
    const int w0 = tt * wpt + j0;
    const int nlive = min(min(U, wpt - j0), W - w0);
    if (nlive <= 0) continue;                      // warp-uniform
    // every load of the item first: Q·U plane words, U·NT activations
    uint32_t pv[U][Q][4];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        int4 v = make_int4(0, 0, 0, 0);
        if (u < nlive)
          v = load4(pe + (static_cast<long long>(i) * W + w0 + u) * M + m,
                    m, M, vec_p);
        pv[u][i][0] = v.x;
        pv[u][i][1] = v.y;
        pv[u][i][2] = v.z;
        pv[u][i][3] = v.w;
      }
    uint4 av[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int r = 8 * n + g, k0 = 32 * (w0 + u) + 8 * t;
        av[u][n] = u < nlive && r < live_rows
                       ? load_act8(ae + static_cast<long long>(r) * N + k0,
                                   N - k0, vec_a)
                       : make_uint4(0, 0, 0, 0);
      }
    if (tt != sc_tile && (scale_tile != 0 || sc_tile < 0)) {
      sc_tile = tt;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = m0 + 16 * g + 4 * k;
        const float4 v = load4f(
            se + static_cast<long long>(tt) * scale_tile + 4 * k, c, M,
            vec_s);
        sc[4 * k] = v.x;
        sc[4 * k + 1] = v.y;
        sc[4 * k + 2] = v.z;
        sc[4 * k + 3] = v.w;
      }
    }

    const int src = (lane & ~3);                   // group g's first lane
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float d[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[n][i] = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u >= nlive) continue;                  // warp-uniform
        // codes of columns 16g + 2j (x) and 16g + 2j + 1 (y), k16 chunks
        // 0 and 1, one byte per reduction row
        uint32_t x0 = 0, x1 = 0, y0 = 0, y1 = 0;
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const uint32_t wx = __shfl_sync(kFull, pv[u][i][2 * (j & 1)],
                                          src | (j >> 1)) >> (8 * t);
          const uint32_t wy = __shfl_sync(kFull, pv[u][i][2 * (j & 1) + 1],
                                          src | (j >> 1)) >> (8 * t);
          const uint32_t mul = 0x00204081u << i;
          x0 |= ((wx & 0xFu) * mul) & (0x01010101u << i);
          y0 |= ((wy & 0xFu) * mul) & (0x01010101u << i);
          if constexpr (Q <= 4) {    // bits 4..7 spread to 4 + 8k + i
            x1 |= ((wx & 0xF0u) * mul) & (0x10101010u << i);
            y1 |= ((wy & 0xF0u) * mul) & (0x10101010u << i);
          } else {
            x1 |= (((wx >> 4) & 0xFu) * mul) & (0x01010101u << i);
            y1 |= (((wy >> 4) & 0xFu) * mul) & (0x01010101u << i);
          }
        }
        if constexpr (Q <= 4) {
          x1 >>= 4;
          y1 >>= 4;
        }
        uint32_t ax01, ax23, ay01, ay23;
        codes_to_bf16<Q>(x0, bias, ax01, ax23);
        codes_to_bf16<Q>(y0, bias, ay01, ay23);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (8 * n < live_rows)                   // warp-uniform
            mma_bf16(d[n], ax01, ay01, ax23, ay23, av[u][n].x, av[u][n].y);
        codes_to_bf16<Q>(x1, bias, ax01, ax23);
        codes_to_bf16<Q>(y1, bias, ay01, ay23);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (8 * n < live_rows)
            mma_bf16(d[n], ax01, ay01, ax23, ay23, av[u][n].z, av[u][n].w);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          part[j][n][i] = fmaf(d[n][i], sc[2 * j + (i >> 1)], part[j][n][i]);
    }
  }

  // the warps' partials, added in warp order (lane-major: no bank
  // conflicts)
#pragma unroll 1
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float& o = s_out[(j * NT + n) * 4 + i][lane];
            o = w == 0 ? part[j][n][i] : o + part[j][n][i];
          }
    }
    __syncthreads();
  }
  // C element i of m-tile j, n-tile n in lane (g, t) is row 8n + 2t +
  // (i & 1), column 16g + 2j + (i >> 1)
  const int split = blockIdx.y;
  for (int o = threadIdx.x; o < 8 * NT * kStrip; o += kThreads) {
    const int r = o / kStrip, c = o % kStrip;
    const int row = row0 + r, col = m0 + c;
    if (row >= R || col >= M) continue;
    const int n = r >> 3, j = (c & 15) >> 1;
    const int i = ((c & 1) << 1) | (r & 1);
    const float y =
        s_out[(j * NT + n) * 4 + i][4 * (c >> 4) + ((r & 7) >> 1)];
    if (ws != nullptr)
      ws[((static_cast<long long>(expert) * splits + split) * R + row) * M
         + col] = y;
    else
      out[(static_cast<long long>(expert) * R + row) * M + col] = y;
  }
}

// The bf16 stack's fold: out (E, R, M) = Σ_s ws[e, s] in split order for
// rows below min(counts[e], R), else 0 (experts without rows included).
__global__ void fold_experts_kernel(const float* __restrict__ ws,
                                    const int* __restrict__ counts,
                                    float* __restrict__ out, int R, int M,
                                    long total, int splits) {
  const long o = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const long rm = static_cast<long>(R) * M;
  const long e = o / rm, i = o - e * rm;
  const int rows = counts == nullptr ? R : max(0, min(counts[e], R));
  float y = 0.f;
  if (i / M < rows)
    for (int s = 0; s < splits; ++s) y += ws[(e * splits + s) * rm + i];
  out[o] = y;
}

}  // namespace

// B3 over E experts with bf16 activations, on the tensor cores: a (E, R,
// N) bf16, unpadded and read in place; planes (E, q, n_words, M) int32,
// n_words = ceil(N/32); scales as gemv_f_experts_launch over ceil(N/bn)
// tiles; counts null or (E,) int32; live: grid.z's expert slots, at least
// the number of experts with counts[e] > 0 (E when counts is null) → out
// (E, R, M) f32. ws: (E, splits, R, M) f32, or null with one split.
// 0 ≤ zero ≤ 128 (bf16 (128 + zero) exact); E ≤ 256.
extern "C" int gemv_f_experts_mma_launch(
    const void* a, const void* planes, const void* scales, void* out,
    void* ws, const void* counts, int E, int R, int N, int n_words, int M,
    int q, int zero, int bn, int scale_expert, int scale_tile, int live,
    int tiles_per_block, int splits, void* stream) {
  const int tiles = bn > 0 ? (N + bn - 1) / bn : 0;
  const int nt = R > 8 ? 2 : 1;
  const int chunks = (R + kMmaRows - 1) / kMmaRows;
  if (q < 1 || q > 8 || bn <= 0 || bn % 32 || N < 1
      || n_words != (N + 31) / 32 || M < 1 || E < 1 || E > kMaxExperts
      || R < 1 || live < 1 || live > E || (counts == nullptr && live != E)
      || zero < 0 || zero > 128 || tiles_per_block < 1
      || tiles_per_block > kMaxTiles
      || splits != (tiles + tiles_per_block - 1) / tiles_per_block
      || (splits > 1 && ws == nullptr) || scale_expert < 0
      || scale_tile < 0 || static_cast<long>(live) * chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int flags = 0;
  if (M % kCols == 0 && aligned16(planes)) flags |= kVecPlanes;
  if (M % kCols == 0 && scale_tile % kCols == 0 && scale_expert % kCols == 0
      && aligned16(scales))
    flags |= kVecScales;
  if (N % 8 == 0 && aligned16(a)) flags |= kVecAct;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + kStrip - 1) / kStrip, splits, live * chunks);
  const auto* av = static_cast<const __nv_bfloat16*>(a);
  const auto* pv = static_cast<const int32_t*>(planes);
  const auto* sv = static_cast<const float*>(scales);
  auto* ov = static_cast<float*>(out);
  float* wsf = splits > 1 ? static_cast<float*>(ws) : nullptr;
  const auto* cnt = static_cast<const int*>(counts);
#define MMA_CASE(QQ)                                                        \
  case QQ:                                                                  \
    if (nt == 1)                                                            \
      experts_mma_kernel<QQ, 1><<<grid, kThreads, 0, st>>>(                 \
          av, pv, sv, ov, wsf, cnt, E, R, N, n_words, M, zero, bn,          \
          scale_expert, scale_tile, live, chunks, tiles_per_block, splits,  \
          flags);                                                           \
    else                                                                    \
      experts_mma_kernel<QQ, 2><<<grid, kThreads, 0, st>>>(                 \
          av, pv, sv, ov, wsf, cnt, E, R, N, n_words, M, zero, bn,          \
          scale_expert, scale_tile, live, chunks, tiles_per_block, splits,  \
          flags);                                                           \
    break;
  switch (q) {
    MMA_CASE(1) MMA_CASE(2) MMA_CASE(3) MMA_CASE(4)
    MMA_CASE(5) MMA_CASE(6) MMA_CASE(7) MMA_CASE(8)
  }
#undef MMA_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || wsf == nullptr) return static_cast<int>(err);
  const long total = static_cast<long>(E) * R * M;
  fold_experts_kernel<<<static_cast<int>((total + 255) / 256), 256, 0, st>>>(
      wsf, cnt, ov, R, M, total, splits);
  return static_cast<int>(cudaGetLastError());
}
