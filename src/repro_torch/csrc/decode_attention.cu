// B4 decode_attention — replaces the TPU kernel `decode_attention_pallas` /
// `_decode_kernel` (src/repro/kernels/decode_attention/kernel.py): one
// query token per lane against a position-stamped KV cache, bf16 or int8
// with per-(token, head) scales, softmax with a running max and
// denominator.
//
// Bound. Bytes: every call must read the lane's cache once, K and V of
// S slots × Hkv heads × D, plus the stamps and, for int8, the scales.
// llama2-7b at its full context (B = 4 lanes, S = 4096, 32 heads of 128)
// reads 134 MB per layer from an int8 cache (40 µs at 3.35 TB/s) and
// 268 MB from a bf16 one; its 4·B·H·S·D f32 operations take 4 µs at
// 67 TFLOP/s.
//
// Design for that bound. The raw cache is read once, 16 bytes a thread, and
// widened (and, for int8, scaled) in registers: no dequantized copy ever
// reaches device memory, which is the point of the TPU kernel too. One
// block per (query head, lane) reads its KV head h / (H / Hkv) in place
// (no GQA repeat) and masks the ragged end of the cache (no padding copy).
// A slot is read by a group of L lanes that split its D elements, so a warp
// covers 32 / L slots per load; each warp keeps four such loads of K and V
// in flight. Each lane group keeps its own running (max, denominator,
// accumulator); the groups merge with shuffles, then the warps through
// shared memory, in place of the TPU's sequential grid axis.
//
// Head dims. The kernel is built for kD ∈ {32, 64, 128, 256} and takes
// the true head dim D ≤ kD at run time: elements at d ≥ D are neither
// loaded nor stored and count as 0 in q·k. D = kD runs with D known at
// compile time (`kExact`, the built sizes' code unchanged). A D whose K/V
// row is a whole number of 16-byte loads keeps them (a load lies wholly
// below D or wholly past it); any other D takes element-wide loads packed
// into the same registers (`kNarrow`), in the same kernel body.
//
// A slot that fails the mask is not read when the lane has any valid slot:
// its weight exp(NEG_INF − max) is exactly 0, as in the reference. A lane
// with no valid slot reads every slot: each weighs exp(NEG_INF − NEG_INF)
// = 1, and the result is the mean of v, as in the reference, which uses
// the same finite NEG_INF (not −∞, which would give NaN). The JAX wrapper
// pads the cache to a multiple of its block, and its padding slots weigh 1
// there too with v = 0, so such a lane divides by the padded slot count
// `s_pad` (≥ S), which the wrapper passes.
//
// The launch function returns cudaGetLastError() after the launch; the
// Python wrapper raises on anything but 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;   // the reference's NEG_INF
constexpr int kWarps = 16;
constexpr int kUnroll = 4;     // loads of K and V in flight per lane
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHeadDim = 256;   // the largest built head dim

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
    } else {                                      // int8, sign-extended
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[4 * i + j] = static_cast<float>(
            static_cast<int32_t>(w[i] << (24 - 8 * j)) >> 24);
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ bool slot_ok(int stamp, int pos, int window) {
  return stamp >= 0 && stamp <= pos && (window < 0 || pos - stamp < window);
}

// pos (B,); q (B, H, D); k/v (B, S, Hkv, D); stamps (B, S); ks/vs
// (B, S, Hkv) f32 or null (float cache); out (B, H, D). Grid (H, B).
// Built for head dim kD; D ≤ kD at run time. kExact: D = kD, known at
// compile time. kNarrow: D·sizeof(KT) is not a multiple of 16 bytes, and
// K/V are read element by element.
template <typename QT, typename KT, int kD, bool kExact, bool kNarrow>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const int32_t* __restrict__ pos, const QT* __restrict__ q,
              const KT* __restrict__ k, const KT* __restrict__ v,
              const int32_t* __restrict__ stamps,
              const float* __restrict__ ks, const float* __restrict__ vs,
              QT* __restrict__ out, int S, int s_pad, int H, int Hkv,
              int d_run, float scale, int window) {
  const int D = kExact ? kD : d_run;
  constexpr int E = Elems<KT>::value;          // elements per 16-byte load
  constexpr int L = kD / E < 32 ? kD / E : 32; // lanes per slot
  constexpr int NV = kD / (E * L);             // loads per lane per slot
  constexpr int G = 32 / L;                    // slots per warp load
  constexpr bool kInt8 = sizeof(KT) == 1;
  static_assert(kD % (E * L) == 0 && 32 % L == 0, "head dim");
  __shared__ float s_m[kWarps], s_l[kWarps], s_acc[kWarps][kD];
  const float kMinusInf = __int_as_float(0xff800000);   // -inf

  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % L, grp = lane / L;
  const int p = pos[b];
  const long row = static_cast<long>(Hkv) * D;       // elements per slot
  const long base = static_cast<long>(b) * S * row + static_cast<long>(hk)
                    * D;
  const KT* kp = k + base;
  const KT* vp = v + base;
  const int32_t* st = stamps + static_cast<long>(b) * S;
  const long sbase = static_cast<long>(b) * S * Hkv + hk;

  // does the lane have any valid slot? (decides whether masked slots are
  // read at all)
  int any = 0;
  for (int t = threadIdx.x; t < S; t += blockDim.x)
    any |= slot_ok(st[t], p, window);
  any = __syncthreads_or(any);

  float qv[NV][E], acc[NV][E];
  const QT* qp = q + (static_cast<long>(b) * H + h) * D;
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = (n * L + sub) * E + e;
      qv[n][e] = d < D ? to_float(qp[d]) : 0.f;
      acc[n][e] = 0.f;
    }
  float m = kNegInf, l = 0.f;

  constexpr int kStep = kWarps * G;                  // slots per block load
  for (int t0 = warp * G; t0 < S; t0 += kStep * kUnroll) {
    uint4 kr[kUnroll][NV], vr[kUnroll][NV];
    float ksc[kUnroll], vsc[kUnroll];
    bool live[kUnroll], ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kStep + grp;
      live[u] = t < S;
      ok[u] = live[u] && slot_ok(st[t], p, window);
      const bool read = live[u] && (ok[u] || !any);
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        // this lane's E elements of the slot's head: d0 .. d0 + E − 1
        const int d0 = (n * L + sub) * E;
        const long off = static_cast<long>(t) * row + d0;
        kr[u][n] = vr[u][n] = make_uint4(0, 0, 0, 0);
        if (read && d0 < D) {
          if constexpr (kNarrow) {
            kr[u][n] = load_narrow(kp + off, D - d0);
            vr[u][n] = load_narrow(vp + off, D - d0);
          } else {             // D·sizeof(KT) % 16 == 0: whole loads
            kr[u][n] = *reinterpret_cast<const uint4*>(kp + off);
            vr[u][n] = *reinterpret_cast<const uint4*>(vp + off);
          }
        }
      }
      ksc[u] = 1.f;
      vsc[u] = 1.f;
      if (kInt8 && read) {
        ksc[u] = ks[sbase + static_cast<long>(t) * Hkv];
        vsc[u] = vs[sbase + static_cast<long>(t) * Hkv];
      }
    }
    float sc[kUnroll];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float kf[E];
        widen<KT>(kr[u][n], kf);
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qv[n][e], kf[e], dot);
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(kFull, dot, off);
      // slots past the cache's end weigh nothing; masked slots NEG_INF
      sc[u] = !live[u] ? kMinusInf
                       : (ok[u] ? dot * ksc[u] * scale : kNegInf);
      m_new = fmaxf(m_new, sc[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[n][e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float pu = expf(sc[u] - m_new);
      l += pu;
      const float pv = pu * vsc[u];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float vf[E];
        widen<KT>(vr[u][n], vf);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[n][e] = fmaf(pv, vf[e], acc[n][e]);
      }
    }
    m = m_new;
  }

  // merge the warp's lane groups (lanes sub, sub + L, ... hold one D slice)
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
    const float m_o = __shfl_xor_sync(kFull, m, off);
    const float l_o = __shfl_xor_sync(kFull, l, off);
    const float m_n = fmaxf(m, m_o);
    const float fa = expf(m - m_n), fb = expf(m_o - m_n);
    l = l * fa + l_o * fb;
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float a_o = __shfl_xor_sync(kFull, acc[n][e], off);
        acc[n][e] = acc[n][e] * fa + a_o * fb;
      }
    m = m_n;
  }
  if (grp == 0) {
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int e = 0; e < E; ++e)
        s_acc[warp][(n * L + sub) * E + e] = acc[n][e];
    if (sub == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
  }
  __syncthreads();
  // merge the warps, one thread per output element
  for (int d = threadIdx.x; d < D; d += blockDim.x) {   // d < D only
    float mg = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mg = fmaxf(mg, s_m[w]);
    // an empty lane also counts the JAX wrapper's padding slots
    float lg = any ? 0.f : static_cast<float>(s_pad - S), ag = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(s_m[w] - mg);
      lg = fmaf(s_l[w], f, lg);
      ag = fmaf(s_acc[w][d], f, ag);
    }
    store(out + (static_cast<long>(b) * H + h) * D + d,
          ag / fmaxf(lg, 1e-30f));
  }
}

template <typename QT, typename KT, int kD>
int launch(const void* pos, const void* q, const void* k, const void* v,
           const void* stamps, const void* ks, const void* vs, void* out,
           int B, int S, int s_pad, int H, int Hkv, int D, float scale,
           int window, cudaStream_t stream) {
#define DECODE_LAUNCH(EXACT, NARROW)                                        \
  decode_kernel<QT, KT, kD, EXACT, NARROW>                                  \
      <<<dim3(H, B), kWarps * 32, 0, stream>>>(                             \
      static_cast<const int32_t*>(pos), static_cast<const QT*>(q),          \
      static_cast<const KT*>(k), static_cast<const KT*>(v),                 \
      static_cast<const int32_t*>(stamps), static_cast<const float*>(ks),   \
      static_cast<const float*>(vs), static_cast<QT*>(out), S, s_pad, H,    \
      Hkv, D, scale, window)
  if (D == kD)
    DECODE_LAUNCH(true, false);
  else if (D * static_cast<int>(sizeof(KT)) % 16 == 0)
    DECODE_LAUNCH(false, false);
  else
    DECODE_LAUNCH(false, true);
#undef DECODE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// D rounded up to the next built head dim kD ∈ {32, 64, 128, 256}
template <typename QT, typename KT>
int by_dim(int D, const void* pos, const void* q, const void* k,
           const void* v, const void* stamps, const void* ks, const void* vs,
           void* out, int B, int S, int s_pad, int H, int Hkv, float scale,
           int window, cudaStream_t stream) {
  if (D < 1 || D > kMaxHeadDim)
    return static_cast<int>(cudaErrorInvalidValue);
#define BY_DIM(KD)                                                          \
  if (D <= KD)                                                              \
    return launch<QT, KT, KD>(pos, q, k, v, stamps, ks, vs, out, B, S,      \
                              s_pad, H, Hkv, D, scale, window, stream);
  BY_DIM(32) BY_DIM(64) BY_DIM(128) BY_DIM(256)
#undef BY_DIM
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename QT>
int by_kv(int kv_type, int D, const void* pos, const void* q, const void* k,
          const void* v, const void* stamps, const void* ks, const void* vs,
          void* out, int B, int S, int s_pad, int H, int Hkv, float scale,
          int window, cudaStream_t stream) {
  switch (kv_type) {
    case 0:
      return by_dim<QT, float>(D, pos, q, k, v, stamps, ks, vs, out, B, S,
                               s_pad, H, Hkv, scale, window, stream);
    case 1:
      return by_dim<QT, __nv_bfloat16>(D, pos, q, k, v, stamps, ks, vs, out,
                                       B, S, s_pad, H, Hkv, scale, window,
                                       stream);
    case 2:
      return by_dim<QT, int8_t>(D, pos, q, k, v, stamps, ks, vs, out, B, S,
                                s_pad, H, Hkv, scale, window, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q_type: 0 f32, 1 bf16 (out has q's type); kv_type: 0 f32, 1 bf16, 2 int8
// (then ks/vs are the scales); 1 ≤ D ≤ 256; window < 0: no window;
// s_pad ≥ S: the slot count a lane with no valid slot divides by.
extern "C" int decode_attention_launch(const void* pos, const void* q,
                                       const void* k, const void* v,
                                       const void* stamps, const void* ks,
                                       const void* vs, void* out, int B,
                                       int S, int s_pad, int H, int Hkv,
                                       int D, int q_type, int kv_type,
                                       float scale, int window,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_pad < S) return static_cast<int>(cudaErrorInvalidValue);
  if (q_type == 0)
    return by_kv<float>(kv_type, D, pos, q, k, v, stamps, ks, vs, out, B, S,
                        s_pad, H, Hkv, scale, window, st);
  if (q_type == 1)
    return by_kv<__nv_bfloat16>(kv_type, D, pos, q, k, v, stamps, ks, vs,
                                out, B, S, s_pad, H, Hkv, scale, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
