// B4 decode_attention — replaces the TPU kernel `decode_attention_pallas` /
// `_decode_kernel` (src/repro/kernels/decode_attention/kernel.py): one
// query token per lane against a position-stamped KV cache, f32, bf16 or
// int8 with per-(token, head) scales, softmax with a running max and
// denominator.
//
// Bound. Bytes: every call must read, for each lane, the K and V rows (and
// for int8 the scales) of its valid slots once per KV head, and the stamps
// once. llama2-7b at its full context (B = 4 lanes, 4096 slots, 32 heads of
// 128) reads 134 MB per layer from an int8 cache (40 µs at 3.35 TB/s);
// qwen2-7b (28 query heads over 4 KV heads) reads 17 MB, but does 7 dots a
// K row, about 7 f32 operations a byte: still below the card's ratio.
//
// Design for that bound.
// - Grid (split, KV head, lane). A block owns one range of cache slots
//   (a split, `chunk` slots, from the wrapper's plan `kernel.decode_plan`)
//   of one KV head of one lane, and all g = H / Hkv query heads that read
//   that KV head: each K/V byte of the range is read once from device
//   memory for the whole GQA group. The plan fills the card with one wave
//   of blocks, 4 an SM, even where lanes × KV heads are few (qwen2-7b at
//   B = 1: 4 pairs, 32 splits).
// - A block loads its range's stamps once, ballots them into a list of
//   valid slots in shared memory, and reads K, V and scales only for those.
//   A range without a valid slot reads no K/V. So the path's cache of 4096
//   slots with 16–31 valid a lane costs the stamps and the valid rows.
// - The valid rows go from device memory into shared memory in stages of
//   8 KB of K and V, kStages deep, in 16-byte cp.async pieces: three
//   stages stay in flight while the block computes on the fourth, whatever
//   the layout of its lanes. (One bulk TMA copy a row was slower under MHA
//   and no faster under GQA; int8 scales copied all at once with the
//   stamps, rather than with their stage, cost int8 MHA 18 %: PERF.md.)
// - A row is read from shared memory by a group of L lanes, 16 bytes a
//   lane, widened (int8 exactly, by a byte permute into 2^23 + u and one
//   subtraction) and scaled in registers: no dequantized copy reaches
//   device memory. The 32 / L lane groups of a warp split into head groups
//   (each with up to kGH query heads, q and accumulator in registers) and
//   slot groups. MHA runs every group on its own row; GQA puts the heads
//   over the groups, which then read the same row (a broadcast).
// - Each block merges its lane groups (shuffles) and warps (shared
//   memory) in a fixed order. With one split it writes the output; with
//   more it writes (m, l, acc) per query head into an f32 workspace, and a
//   second launch (`fold_kernel`, grid (query head, KV head, lane)) merges
//   the splits online in split order. The fold is launched as a
//   programmatic dependent of the split grid: its blocks are scheduled
//   while the splits run and wait for their end, so the second launch adds
//   no launch gap. No float atomics: the sums are deterministic. Scores
//   are kept in base 2 (times log2 e), so every weight is one ex2.
//
// The reference's masking. A slot counts iff 0 ≤ stamp ≤ pos (and pos −
// stamp < window). In a lane with any valid slot a masked slot weighs
// exp(NEG_INF − max) = 0 exactly, so skipping it is exact. A lane with no
// valid slot weighs every slot exp(NEG_INF − NEG_INF) = 1, and the JAX
// wrapper's padding slots (v = 0) too: such a lane gets Σ v / s_pad (the
// padded slot count, s_pad ≥ S). A split without a valid slot looks
// through the lane's other stamps until it finds one (the path's lanes
// have theirs in the first range); if it does, it reports l = 0 (l ≥ 1
// wherever a slot counted: the largest score weighs 1) and reads no K/V;
// if the lane has none, it sums its range's V once for the g heads, and
// the fold adds the splits' sums in split order and divides by s_pad.
//
// Head dims. The fast body is built for kD ∈ {32, 64, 128, 256} and takes
// the true head dim D ≤ kD at run time: elements at d ≥ D are neither
// loaded nor stored and count as 0 in q·k. D = kD runs with D known at
// compile time (`kExact`). A D whose K/V row is a whole number of 16-byte
// loads keeps them; any other D takes element-wide loads packed into the
// same registers on their way to shared memory (`kNarrow`, synchronous).
// The largest D on the fast body is kFastHeadDim = 256. A larger D (no
// model of the zoo has one) takes
// `generic_kernel`: the same grid, list and fold, one query head at a time,
// scores in shared memory, then the softmax statistics, then P·V over D in
// tiles of the block's threads, loads element by element.
//
// The launch function returns cudaGetLastError() after the launches; the
// Python wrapper raises on anything but 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;   // the reference's NEG_INF
constexpr int kWarps = 4;                   // warps of a split's block
constexpr int kThreads = kWarps * 32;
constexpr int kFoldThreads = 128;
constexpr int kFoldBatch = 8;    // splits a fold thread loads at once
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFastHeadDim = 256;   // the largest head dim of the fast body
// the plan's limit (kernel.py MAX_CHUNK): slots a block's valid-slot list
// holds
constexpr int kMaxChunk = 1024;
constexpr int kMaxWords = kMaxChunk / 32;
// q and accumulator floats a lane holds (kGH heads × kD / L elements)
constexpr int kLaneFloats = 48;
// the fast body's pipeline: K and V bytes a stage, stages in the ring
constexpr int kStageBytes = 8192;
constexpr int kStages = 4;

template <typename T>
struct Elems;                  // elements of T in 16 bytes
template <>
struct Elems<float> { static constexpr int value = 4; };
template <>
struct Elems<__nv_bfloat16> { static constexpr int value = 8; };
template <>
struct Elems<int8_t> { static constexpr int value = 16; };

// 16 bytes of the cache → E floats
template <typename T>
__device__ __forceinline__ void widen(const uint4& r, float* out) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      out[i] = __uint_as_float(w[i]);
    } else if constexpr (sizeof(T) == 2) {        // bf16: low half first
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      // int8 x: x + 128 (xor 0x80) as the low mantissa byte of 2^23 is
      // 2^23 + 128 + x exactly, and 2^23 + 128 comes off exactly
      const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] =
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j))
            - 8388736.f;
    }
  }
}

// 16 bytes' worth of elements at p, of which the first `valid` are read
// one at a time (any alignment) and packed as a 16-byte load would hold
// them; the rest are zero
template <typename T>
__device__ __forceinline__ uint4 load_narrow(const T* p, int valid) {
  constexpr int E = Elems<T>::value;
  constexpr int per = E / 4;                       // elements per word
  constexpr int bits = 32 / per;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e < valid) {
      uint32_t raw;
      if constexpr (sizeof(T) == 4)
        raw = __ldg(reinterpret_cast<const uint32_t*>(p) + e);
      else if constexpr (sizeof(T) == 2)
        raw = __ldg(reinterpret_cast<const unsigned short*>(p) + e);
      else
        raw = static_cast<uint8_t>(__ldg(reinterpret_cast<const char*>(p)
                                         + e));
      w[e / per] |= raw << (bits * (e % per));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool slot_ok(int stamp, int pos, int window) {
  return stamp >= 0 && stamp <= pos && (window < 0 || pos - stamp < window);
}

// 2^x, one MUFU instruction (2 ulp; 0 below 2^-126): the scores are kept
// in base 2 (scaled by log2 e), so every softmax weight is one of these
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Problem shape and pointers shared by the kernels. pos (B,); q (B, H,
// D) and out (B, H, D), f32 or, with q_bf16, bf16 (a run-time choice: it
// touches only q's loads and the output's stores); k/v (B, S, Hkv, D);
// stamps (B, S); ks/vs (B, S, Hkv) f32 or null (float cache); ws_acc (B,
// Hkv, splits, g, D) and ws_ml (B, Hkv, splits, g, 2) f32, unused with one
// split.
template <typename KT>
struct Args {
  const int32_t* pos;
  const void* q;
  const KT* k;
  const KT* v;
  const int32_t* stamps;
  const float* ks;
  const float* vs;
  void* out;
  float* ws_acc;
  float* ws_ml;
  int S, s_pad, H, Hkv, D, chunk, splits, window, q_bf16;
  float scale;   // the softmax scale times log2 e: scores in base 2
};

// element i of q, and the output's element i ← x
template <typename KT>
__device__ __forceinline__ float q_at(const Args<KT>& a, long i) {
  return a.q_bf16 ? to_float(static_cast<const __nv_bfloat16*>(a.q)[i])
                  : static_cast<const float*>(a.q)[i];
}
template <typename KT>
__device__ __forceinline__ void out_at(const Args<KT>& a, long i, float x) {
  if (a.q_bf16)
    store(static_cast<__nv_bfloat16*>(a.out) + i, x);
  else
    store(static_cast<float*>(a.out) + i, x);
}

// The valid slots of [c0, c1) (at most kMaxChunk) of a lane, in ascending
// order, into s_list; returns their count. Called by every thread of a
// block of kThreads; each thread's stamps are loaded together.
__device__ int valid_slots(const int32_t* st, int c0, int c1, int p,
                           int window, int* s_list, uint32_t* s_mask,
                           int* s_off) {
  constexpr int kPer = kMaxWords / kWarps;    // words a warp at most
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = (c1 - c0 + 31) / 32;
  int stamp[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int t = c0 + (warp + i * kWarps) * 32 + lane;
    stamp[i] = t < c1 ? st[t] : -1;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const unsigned m = __ballot_sync(kFull, slot_ok(stamp[i], p, window));
    if (lane == 0 && warp + i * kWarps < words) s_mask[warp + i * kWarps] = m;
  }
  __syncthreads();
  if (warp == 0) {      // exclusive prefix of the words' counts, 2 a lane
    const int w0 = 2 * lane, w1 = 2 * lane + 1;
    const int n0 = w0 < words ? __popc(s_mask[w0]) : 0;
    const int n1 = w1 < words ? __popc(s_mask[w1]) : 0;
    int incl = n0 + n1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int excl = incl - n0 - n1;
    if (w0 < words) s_off[w0] = excl;
    if (w1 < words) s_off[w1] = excl + n0;
    if (lane == 31) s_off[kMaxWords] = incl;
  }
  __syncthreads();
  for (int wd = warp; wd < words; wd += kWarps) {
    const unsigned m = s_mask[wd];
    if ((m >> lane) & 1u)
      s_list[s_off[wd] + __popc(m & ((1u << lane) - 1u))] =
          c0 + wd * 32 + lane;
  }
  __syncthreads();
  return s_off[kMaxWords];
}

// Whether lane b has a valid slot outside [c0, c1): its stamps in tiles of
// 4 a thread, from slot 0, stopping at the first tile with one. Called by
// every thread of a block of kThreads whose own range has none.
template <typename KT>
__device__ bool lane_has_slot(const Args<KT>& a, int b, int c0, int c1) {
  const int32_t* st = a.stamps + static_cast<long>(b) * a.S;
  const int p = a.pos[b];
  for (int t0 = 0; t0 < a.S; t0 += 4 * kThreads) {
    bool any = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + u * kThreads + threadIdx.x;
      if (t < a.S && (t < c0 || t >= c1)) any |= slot_ok(st[t], p, a.window);
    }
    if (__syncthreads_or(any)) return true;
  }
  return false;
}

// A lane with no valid slot: Σ v over the slots [t0, t1) of KV head hk,
// for each element, read once for the g query heads. With one split (the
// range is the lane) Σ v / s_pad into every query head of the group; with
// more, into the split's workspace row of head 0, marked l = −1, for the
// fold to add in split order. Called by every thread of the block; the
// warps split the slots, lanes the elements (tiles of 128), and the warps'
// sums meet in `red` (blockDim / 32 × 128 floats) in warp order.
template <typename KT>
__device__ void v_sum(const Args<KT>& a, int b, int hk, int g, int split,
                      int t0, int t1, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const long row = static_cast<long>(a.Hkv) * a.D;
  const KT* vp = a.v + static_cast<long>(b) * a.S * row
                 + static_cast<long>(hk) * a.D;
  const float* vsp = a.vs ? a.vs + static_cast<long>(b) * a.S * a.Hkv + hk
                          : nullptr;
  const long ws = ((static_cast<long>(b) * a.Hkv + hk) * a.splits + split)
                  * g;                             // (split, head 0) row
  if (a.splits > 1 && threadIdx.x == 0) {
    a.ws_ml[ws * 2] = 0.f;
    a.ws_ml[ws * 2 + 1] = -1.f;
  }
  for (int d0 = 0; d0 < a.D; d0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int tb = t0 + warp; tb < t1; tb += 8 * nwarps) { // 8 slots' loads
      float x[8][4], sc[8];                               // then their sums
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const long t = tb + u * nwarps;
        const bool ok = t < t1;
        sc[u] = !ok ? 0.f : vsp ? vsp[t * a.Hkv] : 1.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + lane + 32 * j;
          x[u][j] = ok && d < a.D ? to_float(vp[t * row + d]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(x[u][j], sc[u], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp * 128 + lane + 32 * j] = acc[j];
    __syncthreads();
    for (int i = threadIdx.x; i < 128 && d0 + i < a.D; i += blockDim.x) {
      float r = 0.f;
      for (int w = 0; w < nwarps; ++w) r += red[w * 128 + i];
      if (a.splits > 1) {
        a.ws_acc[ws * a.D + d0 + i] = r;
        continue;
      }
      r /= static_cast<float>(a.s_pad);
      for (int j = 0; j < g; ++j)
        out_at(a, (static_cast<long>(b) * a.H + hk * g + j) * a.D + d0 + i,
               r);
    }
    __syncthreads();
  }
}

// A range without a valid slot: the lane has one elsewhere (then (m, l) =
// (NEG_INF, 0) for each query head: the fold weighs the split 0 and reads
// nothing else of it), or none (then its share of Σ v).
template <typename KT>
__device__ void no_slot(const Args<KT>& a, int b, int hk, int g, int split,
                        int c0, int c1, float* red) {
  if (a.splits > 1 && lane_has_slot(a, b, c0, c1)) {
    const long base = ((static_cast<long>(b) * a.Hkv + hk) * a.splits
                       + split) * g;
    for (int j = threadIdx.x; j < g; j += blockDim.x) {
      a.ws_ml[(base + j) * 2] = kNegInf;
      a.ws_ml[(base + j) * 2 + 1] = 0.f;
    }
    return;
  }
  v_sum(a, b, hk, g, split, c0, c1, red);
}

// One query head's finished (m, l, acc[d]) of a split: the output itself
// with one split, else its workspace row
template <typename KT>
__device__ __forceinline__ void put(const Args<KT>& a, int b, int hk,
                                    int g, int split, int j, int d,
                                    float acc, float l) {
  if (a.splits == 1)
    out_at(a, (static_cast<long>(b) * a.H + hk * g + j) * a.D + d,
           acc / fmaxf(l, 1e-30f));
  else
    a.ws_acc[(((static_cast<long>(b) * a.Hkv + hk) * a.splits + split) * g
              + j) * a.D + d] = acc;
}

template <typename KT>
__device__ __forceinline__ void put_ml(const Args<KT>& a, int b, int hk,
                                       int g, int split, int j, float m,
                                       float l) {
  if (a.splits == 1) return;
  const long i = (((static_cast<long>(b) * a.Hkv + hk) * a.splits + split)
                  * g + j) * 2;
  a.ws_ml[i] = m;
  a.ws_ml[i + 1] = l;
}

// The fast body. Built for head dim kD (D ≤ kD at run time), up to kGH
// query heads a lane group. kExact: D = kD, known at compile time.
// kNarrow: D·sizeof(KT) is not a multiple of 16 bytes, and K/V are read
// element by element. Grid (splits, Hkv, B).
template <typename KT, int kD, int kGH, bool kExact, bool kNarrow>
__global__ void __launch_bounds__(kThreads)
split_kernel(const Args<KT> a) {
  constexpr int E = Elems<KT>::value;          // elements per 16 bytes
  constexpr int L = kD / E < 32 ? kD / E : 32; // lanes per row
  constexpr int NV = kD / (E * L);             // 16-byte pieces a lane
  constexpr int PE = NV * E;                   // elements a lane holds
  constexpr int kGroups = 32 / L;              // lane groups of a warp
  constexpr int kRow = kD * static_cast<int>(sizeof(KT));  // row bytes
  constexpr int kPieces = kRow / 16;           // 16-byte pieces a row
  constexpr int T = kStageBytes / (2 * kRow);  // rows a stage
  constexpr int kBatch = 2;                    // rows a softmax update
  constexpr bool kInt8 = sizeof(KT) == 1;
  static_assert(kD % (E * L) == 0 && 32 % L == 0, "head dim");
  static_assert(kGH * PE <= kLaneFloats, "lane registers");
  static_assert(T >= 1 && T * 2 * kRow == kStageBytes, "stage");
  static_assert((kWarps - 1) * 32 * kGH * (PE + 2) * 4
                <= kStages * kStageBytes, "merge buffers");
  // a stage: T rows of K, then T rows of V; its scales
  __shared__ __align__(128) unsigned char s_kv[kStages][kStageBytes];
  __shared__ float s_ks[kStages][T], s_vs[kStages][T];
  __shared__ int s_list[kMaxChunk];
  __shared__ uint32_t s_mask[kMaxWords];
  __shared__ int s_off[kMaxWords + 1];
  const float kMinusInf = __int_as_float(0xff800000);   // -inf

  const int D = kExact ? kD : a.D;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % L, grp = lane / L;
  const int c0 = split * a.chunk;
  const int c1 = min(a.S, c0 + a.chunk);
  // the fold may launch now; it waits for this grid's end and writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int n = valid_slots(a.stamps + static_cast<long>(b) * a.S, c0, c1,
                            a.pos[b], a.window, s_list, s_mask, s_off);
  if (n == 0) {
    no_slot(a, b, hk, g, split, c0, c1,
            reinterpret_cast<float*>(&s_kv[0][0]));
    return;
  }

  const long row = static_cast<long>(a.Hkv) * D;     // elements per slot
  const long base = static_cast<long>(b) * a.S * row
                    + static_cast<long>(hk) * D;
  const long sbase = static_cast<long>(b) * a.S * a.Hkv + hk;
  const int stages = (n + T - 1) / T;

  // passes of up to kGroups·kGH query heads; within a pass, Gh head groups
  // (a power of two) of ≤ kGH heads each, and Gs = kGroups / Gh slot
  // groups
  int seq = 0;                 // stages the block issued in earlier passes
  for (int h0 = 0; h0 < g; h0 += kGroups * kGH) {
    const int gp = min(g - h0, kGroups * kGH);
    int Gh = 1;
    while (Gh * kGH < gp) Gh <<= 1;
    const int Gs = kGroups / Gh;
    const int hg = grp % Gh, sg = grp / Gh;
    // a stage's rows of this lane group: r_j = (j·kWarps + warp)·Gs + sg
    const int J = (T + kWarps * Gs - 1) / (kWarps * Gs);
    auto row_of = [&](int j) { return (j * kWarps + warp) * Gs + sg; };

    // stage st: rows [st·T, st·T + T) of the list, K and V (and int8
    // scales), into the buffer of the block's stage number seq + st (mod
    // kStages); one cp.async group a stage, empty past the list's end
    auto issue = [&](int st) {
      const int q = seq + st, buf = q % kStages;
      const int r0 = st * T, rows = min(T, n - r0);
      if (rows > 0) {          // (constant divisors: T, kPieces)
        unsigned char* kb = s_kv[buf];
        for (int c = threadIdx.x; c < 2 * T * kPieces; c += kThreads) {
          const int half = c / (T * kPieces), r = (c / kPieces) % T;
          const int d0 = (c % kPieces) * E;
          if (r >= rows || d0 >= D) continue;
          const KT* src = (half ? a.v : a.k) + base
                          + static_cast<long>(s_list[r0 + r]) * row + d0;
          unsigned char* dst = kb + (half * T + r) * kRow + (c % kPieces) * 16;
          if constexpr (kNarrow)    // rows not of whole 16-byte pieces
            *reinterpret_cast<uint4*>(dst) = load_narrow(src, D - d0);
          else
            cp_async16(dst, src);
        }
        if constexpr (kInt8) {
          for (int r = threadIdx.x; r < 2 * T; r += kThreads) {
            const int rr = r % T;
            if (rr >= rows) continue;
            const long i = sbase + static_cast<long>(s_list[r0 + rr])
                           * a.Hkv;
            if (r < T)
              cp_async4(&s_ks[buf][rr], a.ks + i);
            else
              cp_async4(&s_vs[buf][rr], a.vs + i);
          }
        }
      }
      cp_async_commit();
    };
    // this lane's share of row r of a stage's K (half 0) or V (half 1),
    // widened; zeros past D
    auto row_floats = [&](const unsigned char* kb, int half, int r,
                          float* out) {
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        const int d0 = (nv * L + sub) * E;
        uint4 raw = make_uint4(0, 0, 0, 0);
        if (kExact || d0 < D)
          raw = *reinterpret_cast<const uint4*>(kb + (half * T + r) * kRow
                                                + d0 * sizeof(KT));
        widen<KT>(raw, out + nv * E);
      }
    };
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) issue(st);
    float qv[kGH][PE], acc[kGH][PE], m[kGH], l[kGH];
#pragma unroll
    for (int i = 0; i < kGH; ++i) {
      const int j = hg + i * Gh;                  // head within the pass
      const long qrow = (static_cast<long>(b) * a.H + hk * g + h0 + j) * D;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = (nv * L + sub) * E + e;
          qv[i][nv * E + e] = j < gp && d < D ? q_at(a, qrow + d) : 0.f;
          acc[i][nv * E + e] = 0.f;
        }
      m[i] = kNegInf;
      l[i] = 0.f;
    }

    for (int st = 0; st < stages; ++st) {
      cp_async_wait<kStages - 2>();
      __syncthreads();        // stage st's pieces landed; st − 1 consumed
      issue(st + kStages - 1);
      const int q = seq + st;
      const unsigned char* kb = s_kv[q % kStages];
      const int live_rows = min(T, n - st * T);
      for (int j0 = 0; j0 < J; j0 += kBatch) {
        float sc[kBatch][kGH], ksc[kBatch], vsc[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int r = row_of(j0 + u);
          const bool live = j0 + u < J && r < live_rows;
          ksc[u] = kInt8 && live ? s_ks[q % kStages][r] : 1.f;
          vsc[u] = kInt8 && live ? s_vs[q % kStages][r] : 1.f;
          float kf[PE];
          row_floats(kb, 0, live ? r : 0, kf);
#pragma unroll
          for (int i = 0; i < kGH; ++i) {
            float part[4] = {0.f, 0.f, 0.f, 0.f};   // four short chains
#pragma unroll
            for (int e = 0; e < PE; ++e)
              part[e % 4] = fmaf(qv[i][e], kf[e], part[e % 4]);
            float dot = (part[0] + part[1]) + (part[2] + part[3]);
#pragma unroll
            for (int off = L / 2; off > 0; off >>= 1)
              dot += __shfl_xor_sync(kFull, dot, off);
            // rows past the stage's end weigh nothing
            sc[u][i] = live ? dot * ksc[u] * a.scale : kMinusInf;
          }
        }
        float pw[kBatch][kGH];
#pragma unroll
        for (int i = 0; i < kGH; ++i) {
          float m_new = m[i];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) m_new = fmaxf(m_new, sc[u][i]);
          const float alpha = exp2_fast(m[i] - m_new);
          l[i] *= alpha;
#pragma unroll
          for (int e = 0; e < PE; ++e) acc[i][e] *= alpha;
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            pw[u][i] = exp2_fast(sc[u][i] - m_new);
            l[i] += pw[u][i];
          }
          m[i] = m_new;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int r = row_of(j0 + u);
          const bool live = j0 + u < J && r < live_rows;
          float vf[PE];
          row_floats(kb, 1, live ? r : 0, vf);
#pragma unroll
          for (int i = 0; i < kGH; ++i) {
            const float pv = pw[u][i] * vsc[u];     // 0 for a dead row
#pragma unroll
            for (int e = 0; e < PE; ++e)
              acc[i][e] = fmaf(pv, vf[e], acc[i][e]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                 // the stages are free for the merge
    seq += stages;

    // merge the warp's slot groups (lanes hg·L + sub + k·Gh·L hold one
    // head group's share of the same elements)
    for (int off = L * Gh; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < kGH; ++i) {
        const float m_o = __shfl_xor_sync(kFull, m[i], off);
        const float l_o = __shfl_xor_sync(kFull, l[i], off);
        const float m_n = fmaxf(m[i], m_o);
        const float fa = exp2_fast(m[i] - m_n), fb = exp2_fast(m_o - m_n);
        l[i] = l[i] * fa + l_o * fb;
#pragma unroll
        for (int e = 0; e < PE; ++e) {
          const float a_o = __shfl_xor_sync(kFull, acc[i][e], off);
          acc[i][e] = acc[i][e] * fa + a_o * fb;
        }
        m[i] = m_n;
      }
    }
    // then the warps, in warp order, into warp 0, through the stages'
    // memory: per warp w ≥ 1 and lane, kGH (m, l) and kGH·PE accumulators
    float* s_part = reinterpret_cast<float*>(&s_kv[0][0]);
    auto part = [&](int w, int k) -> float& {
      return s_part[((w - 1) * kGH * (PE + 2) + k) * 32 + lane];
    };
    const bool owner = sg == 0;
    if (warp > 0 && owner) {
#pragma unroll
      for (int i = 0; i < kGH; ++i) {
        part(warp, kGH * PE + 2 * i) = m[i];
        part(warp, kGH * PE + 2 * i + 1) = l[i];
#pragma unroll
        for (int e = 0; e < PE; ++e) part(warp, i * PE + e) = acc[i][e];
      }
    }
    __syncthreads();
    if (warp == 0 && owner) {
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
#pragma unroll
        for (int i = 0; i < kGH; ++i) {
          const float m_o = part(w, kGH * PE + 2 * i);
          const float l_o = part(w, kGH * PE + 2 * i + 1);
          const float m_n = fmaxf(m[i], m_o);
          const float fa = exp2_fast(m[i] - m_n), fb = exp2_fast(m_o - m_n);
          l[i] = l[i] * fa + l_o * fb;
#pragma unroll
          for (int e = 0; e < PE; ++e)
            acc[i][e] = acc[i][e] * fa + part(w, i * PE + e) * fb;
          m[i] = m_n;
        }
#pragma unroll
      for (int i = 0; i < kGH; ++i) {
        const int j = hg + i * Gh;
        if (j >= gp) continue;
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int d = (nv * L + sub) * E + e;
            if (d < D)
              put(a, b, hk, g, split, h0 + j, d, acc[i][nv * E + e], l[i]);
          }
        if (sub == 0) put_ml(a, b, hk, g, split, h0 + j, m[i], l[i]);
      }
    }
    __syncthreads();             // the stages are free for the next pass
  }
}

// Any head dim (off every model's path: D > kFastHeadDim). The same grid,
// list and output as split_kernel; one query head at a time: its scores
// over the valid slots into shared memory, their max and sum, then P·V
// with a thread per element of D. K/V are read element by element.
template <typename KT>
__global__ void __launch_bounds__(kThreads)
generic_kernel(const Args<KT> a) {
  __shared__ int s_list[kMaxChunk];
  __shared__ uint32_t s_mask[kMaxWords];
  __shared__ int s_off[kMaxWords + 1];
  __shared__ float s_p[kMaxChunk];
  __shared__ float s_red[kWarps];
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.Hkv, D = a.D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = split * a.chunk;
  const int c1 = min(a.S, c0 + a.chunk);
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int n = valid_slots(a.stamps + static_cast<long>(b) * a.S, c0, c1,
                            a.pos[b], a.window, s_list, s_mask, s_off);
  if (n == 0) {
    no_slot(a, b, hk, g, split, c0, c1, s_p);
    return;
  }
  const long row = static_cast<long>(a.Hkv) * D;
  const long base = static_cast<long>(b) * a.S * row
                    + static_cast<long>(hk) * D;
  const long sbase = static_cast<long>(b) * a.S * a.Hkv + hk;
  // a block-wide reduction of one value per thread (max or sum), in a
  // fixed order
  auto reduce = [&](float x, bool is_max) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(kFull, x, off);
      x = is_max ? fmaxf(x, y) : x + y;
    }
    if (lane == 0) s_red[warp] = x;
    __syncthreads();
    x = s_red[0];
    for (int w = 1; w < kWarps; ++w)
      x = is_max ? fmaxf(x, s_red[w]) : x + s_red[w];
    __syncthreads();
    return x;
  };
  for (int j = 0; j < g; ++j) {
    const long qrow = (static_cast<long>(b) * a.H + hk * g + j) * D;
    for (int i = warp; i < n; i += kWarps) {     // a warp a slot
      const long t = s_list[i];
      float dot = 0.f;
      for (int d = lane; d < D; d += 32)
        dot = fmaf(q_at(a, qrow + d), to_float(a.k[base + t * row + d]),
                   dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kFull, dot, off);
      if (lane == 0)
        s_p[i] = dot * (a.ks ? a.ks[sbase + t * a.Hkv] : 1.f) * a.scale;
    }
    __syncthreads();
    float mx = kNegInf;
    for (int i = threadIdx.x; i < n; i += kThreads) mx = fmaxf(mx, s_p[i]);
    mx = reduce(mx, true);
    float sum = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float w = exp2_fast(s_p[i] - mx);
      s_p[i] = w * (a.vs ? a.vs[sbase + static_cast<long>(s_list[i])
                                * a.Hkv] : 1.f);
      sum += w;
    }
    const float l = reduce(sum, false);
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < n; ++i)
        acc = fmaf(s_p[i], to_float(a.v[base + s_list[i] * row + d]), acc);
      put(a, b, hk, g, split, j, d, acc, l);
    }
    if (threadIdx.x == 0) put_ml(a, b, hk, g, split, j, mx, l);
    __syncthreads();                             // s_p free for head j + 1
  }
}

// Merge the splits of one query head of one lane, online in split order:
// (M, L, A) ← (M', L·2^(M − M') + l_s·2^(m_s − M'), A·2^(M − M') +
// acc_s·2^(m_s − M')) with M' = max(M, m_s), skipping splits without a
// valid slot (l_s = 0); out = A / L. A lane without a valid slot (split 0
// marked l = −1) gets the splits' Σ v, added in split order, / s_pad. Each
// thread reads every split's (m, l) and its elements' partials in one
// pass, kFoldBatch splits' loads at a time, without a branch between them.
// Launched behind the split grid (programmatic dependent launch): it waits
// here until that grid has ended and its writes are visible. Grid (g, Hkv,
// B).
template <typename KT>
__global__ void __launch_bounds__(kFoldThreads)
fold_kernel(const Args<KT> a) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int j = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.Hkv, splits = a.splits;
  const long lane0 = (static_cast<long>(b) * a.Hkv + hk) * splits * g;
  const long o = (static_cast<long>(b) * a.H + hk * g + j) * a.D;
  const bool empty = a.ws_ml[lane0 * 2 + 1] < 0.f;
  for (int d = threadIdx.x; d < a.D; d += kFoldThreads) {
    if (empty) {
      float r = 0.f;
      for (int s = 0; s < splits; ++s)
        r += a.ws_acc[(lane0 + static_cast<long>(s) * g) * a.D + d];
      out_at(a, o + d, r / static_cast<float>(a.s_pad));
      continue;
    }
    float M = kNegInf, L = 0.f, A = 0.f;
    for (int s0 = 0; s0 < splits; s0 += kFoldBatch) {
      float m[kFoldBatch], l[kFoldBatch], x[kFoldBatch];
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u) {    // the batch's loads at once
        const long i = lane0 + static_cast<long>(s0 + u) * g + j;
        const bool in = s0 + u < splits;
        m[u] = in ? a.ws_ml[i * 2] : kNegInf;
        l[u] = in ? a.ws_ml[i * 2 + 1] : 0.f;
        x[u] = in ? a.ws_acc[i * a.D + d] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kFoldBatch; ++u) {
        // a split without a valid slot (l = 0; its acc unwritten) leaves
        // (M, L, A) as they are
        const bool live = l[u] != 0.f;
        const float Mn = live ? fmaxf(M, m[u]) : M;
        const float fa = exp2_fast(M - Mn);
        const float fb = live ? exp2_fast(m[u] - Mn) : 0.f;
        L = L * fa + l[u] * fb;
        A = A * fa + (live ? x[u] * fb : 0.f);
        M = Mn;
      }
    }
    out_at(a, o + d, A / fmaxf(L, 1e-30f));
  }
}

// the fast body at the built head dim kD with kGH heads a lane group: the
// fewest of 1, 2, 4 and kLaneFloats / PE that hold the group's g heads in
// the warp's lane groups (past that, passes of the largest); D ≠ kD takes
// 1 or the largest only
template <typename KT, int kD, bool kExact, bool kNarrow>
int launch_fast(const Args<KT>& a, dim3 grid, cudaStream_t stream) {
  constexpr int E = Elems<KT>::value;
  constexpr int L = kD / E < 32 ? kD / E : 32;
  constexpr int kGroups = 32 / L;
  constexpr int kMany = kLaneFloats / (kD / L);
  const int need = (a.H / a.Hkv + kGroups - 1) / kGroups;
#define FAST(GH)                                                            \
  split_kernel<KT, kD, GH, kExact, kNarrow><<<grid, kThreads, 0, stream>>>( \
      a);                                                                   \
  return 0
  if (need <= 1) {
    FAST(1);
  }
  if constexpr (kExact && 2 < kMany) {
    if (need <= 2) {
      FAST(2);
    }
  }
  if constexpr (kExact && 4 < kMany) {
    if (need <= 4) {
      FAST(4);
    }
  }
  FAST(kMany);
#undef FAST
}

template <typename KT, int kD>
int launch_dim(const Args<KT>& a, dim3 grid, cudaStream_t stream) {
  if (a.D == kD) return launch_fast<KT, kD, true, false>(a, grid, stream);
  if (a.D * static_cast<int>(sizeof(KT)) % 16 == 0)
    return launch_fast<KT, kD, false, false>(a, grid, stream);
  return launch_fast<KT, kD, false, true>(a, grid, stream);
}

template <typename KT>
int launch(const Args<KT>& a, int B, cudaStream_t stream) {
  const dim3 grid(a.splits, a.Hkv, B);
  int err = 0;
  if (a.D > kFastHeadDim)
    generic_kernel<KT><<<grid, kThreads, 0, stream>>>(a);
  else if (a.D <= 32)        // D rounded up to the next built head dim
    err = launch_dim<KT, 32>(a, grid, stream);
  else if (a.D <= 64)
    err = launch_dim<KT, 64>(a, grid, stream);
  else if (a.D <= 128)
    err = launch_dim<KT, 128>(a, grid, stream);
  else
    err = launch_dim<KT, 256>(a, grid, stream);
  if (err) return err;
  if (a.splits > 1) {     // behind the splits without a launch's gap
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.H / a.Hkv, a.Hkv, B);
    cfg.blockDim = dim3(kFoldThreads);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, fold_kernel<KT>, a);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename KT>
int typed(const void* pos, const void* q, const void* k, const void* v,
          const void* stamps, const void* ks, const void* vs, void* out,
          void* ws_acc, void* ws_ml, int B, int S, int s_pad, int H,
          int Hkv, int D, int q_bf16, int chunk, int splits, float scale,
          int window, cudaStream_t stream) {
  Args<KT> a;
  a.pos = static_cast<const int32_t*>(pos);
  a.q = q;
  a.k = static_cast<const KT*>(k);
  a.v = static_cast<const KT*>(v);
  a.stamps = static_cast<const int32_t*>(stamps);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.out = out;
  a.ws_acc = static_cast<float*>(ws_acc);
  a.ws_ml = static_cast<float*>(ws_ml);
  a.S = S;
  a.s_pad = s_pad;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.chunk = chunk;
  a.splits = splits;
  a.window = window;
  a.q_bf16 = q_bf16;
  a.scale = scale * kLog2e;
  return launch(a, B, stream);
}

}  // namespace

// q_type: 0 f32, 1 bf16 (out has q's type); kv_type: 0 f32, 1 bf16, 2 int8
// (then ks/vs are the scales); D ≥ 1; window < 0: no window; s_pad ≥ S:
// the slot count a lane with no valid slot divides by; the plan: splits
// ranges of `chunk` slots (a multiple of 32, at most 1024) over S, at most
// ws_acc/ws_ml the workspace of a plan with several splits.
extern "C" int decode_attention_launch(
    const void* pos, const void* q, const void* k, const void* v,
    const void* stamps, const void* ks, const void* vs, void* out,
    void* ws_acc, void* ws_ml, int B, int S, int s_pad, int H, int Hkv,
    int D, int q_type, int kv_type, int chunk, int splits, float scale,
    int window, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_pad < S || D < 1 || Hkv < 1 || H % Hkv || chunk < 1
      || chunk % 32 || chunk > kMaxChunk || splits < 1
      || static_cast<long>(chunk) * splits < S
      || static_cast<long>(chunk) * (splits - 1) >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_type != 0 && q_type != 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define TYPED(KT)                                                           \
  return typed<KT>(pos, q, k, v, stamps, ks, vs, out, ws_acc, ws_ml, B, S,  \
                   s_pad, H, Hkv, D, q_type, chunk, splits, scale, window, st)
  if (kv_type == 0) TYPED(float);
  if (kv_type == 1) TYPED(__nv_bfloat16);
  if (kv_type == 2) TYPED(int8_t);
#undef TYPED
  return static_cast<int>(cudaErrorInvalidValue);
}
