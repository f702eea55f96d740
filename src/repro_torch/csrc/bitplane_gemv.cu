// Bit-plane GeMV kernels for Hopper (sm_90a).
//
// B1 gemv_bs      — replaces the TPU kernel `gemv_bs_pallas` /
//   `_gemv_bs_kernel` (src/repro/kernels/bitplane_gemv/kernel.py): integer
//   activation codes × packed weight planes, per-tile zero-point
//   correction, f32 scaling.
// B2 program_gemv — replaces `program_gemv` / `_program_kernel`
//   (src/repro/kernels/bitplane_gemv/program.py): B1 over the members of a
//   whole concurrency group (q/k/v, up/gate) in one launch.
// B3 gemv_f       — replaces `gemv_f_pallas` / `_gemv_f_kernel`
//   (kernel.py): float activations × packed weight planes; and, over a
//   stack of experts in one launch (`experts_kernel`, f32 stacks), the JAX
//   package's `jax.vmap` of it over the routed experts
//   (src/repro/models/moe.py, `_expert_mm`). bf16 stacks, the MoE path's,
//   run on the tensor cores (`experts_mma.cu`).
//
// Bound. At decode (B = 4 rows) B1 and B2 are bound by bytes: each call
// must read the packed planes once, q·N·M/8 bytes (4 MiB for a 4096×4096
// q2 layer, 12.6 MB for q/k/v, 22.5 MB for up/gate, 32.8 MB for the
// 4096→32000 lm_head), and little else. B3's 2·B·N·M f32 multiply-adds on
// CUDA cores (67 TFLOP/s) take longer than its bytes. Either way the time
// goes to memory round trips unless many loads are in flight, and then to
// unpacking bits and to multiply-adds. B3 over an expert stack (qwen2-moe:
// 64 experts, 8 capacity rows each, 2048→1408 and 1408→2048, q4) has
// 2·8·64·2048·1408 = 2.95 GFLOP at 67 TFLOP/s (0.044 ms) against 92 MB of
// planes (0.028 ms) at full capacity; at decode only the experts that
// received tokens (≤ 16 of 64 at 4 lanes, top-4) need their planes read.
//
// Design.
//  * Members. A launch works on a table of members, one weight matrix
//    each (`Member`): where its activations, planes, tile scales and
//    output lie, with its own strides, q, p, zero points, bn and tile
//    count. B1 and B3 launch one member (`leaf_kernel`, the member a
//    by-value parameter). B2 (`group_kernel`) launches a group: grid.x
//    walks the members' 128-column strips, and a block finds its member by
//    the strip where each begins. A leaf's (q, W, M) planes are read in
//    place, unpadded; a slot of the JAX package's slot-major envelope is a
//    member too, with tile, plane and word strides and the envelope's BN
//    as its bn. The table of at most kMaxMembers members is a by-value
//    kernel parameter; a longer one (the slot-major entry's 48–86 slots,
//    or a whole decode block's leaves) lies in device memory. Every
//    member runs the same block body (`gemv_block`), so B2 gives B1's
//    bits for each of its members.
//  * Work items. A lane owns 4 neighbouring output columns and loads a
//    plane word of them as one 16-byte int4 (a warp reads 512 contiguous
//    bytes per plane word); a warp covers a strip of 128 columns. A work
//    item is a unit of U = max(1, 4/q) words of one reduction tile of the
//    strip: the warp issues all q·U plane loads of the unit, and loads its
//    activations, before any arithmetic. A block of 8 warps owns one strip,
//    4 batch rows (grid.z) and `tiles_per_block` consecutive tiles (grid.y
//    splits the tiles); its warps take the items of those tiles in turn.
//    The split is the wrapper's plan (kernel.py `split_plan`, over all the
//    strips of the launch), chosen so that every shape runs several blocks
//    per SM.
//  * B3: folded codes. Per weight the q plane bits are assembled into the
//    code c in a register, and c − zero becomes a float without a
//    conversion instruction: as_float(0x4B000000 | c) − (2^23 + zero). Each
//    weight then costs one f32 FMA per batch row against activations that
//    the warp stages once per unit in shared memory as float4s of 4 batch
//    rows (one broadcast load per reduction row). With the zero point
//    inside the product, Σ a·(c − zero) over a tile is its correction
//    acc − zero·Σa; each unit's sum is multiplied by its tile's scale at
//    once (the sum order is free within rtol 1e-5).
//  * B1/B2: byte dot products. The unit's codes (masked to p bits) are
//    staged as bytes, 4 reduction rows to a word per batch row; the weight
//    codes of 4 rows are spread into the bytes of a word (nibble ·
//    0x00204081 puts bit k at bit 8k, one multiply per plane) and one dp4a
//    per batch row adds 4 products. A unit's correction is then the exact
//    integer Σ (a − z_a)(w − z_w) = Σaw − z_w·Σa − z_a·Σw + rows·z_a·z_w
//    (Σa by a warp reduction, Σw by popcounts), added into its tile's
//    correction in shared memory: integer adds, so any order gives the
//    same integer. Over a tile it is exactly the reference's acc −
//    z_a·col_sum − z_w·Σa + bn·z_a·z_w, padding included (a padded row has
//    a = z_a, w = 0). A member of lower q than the launch's Q reads only
//    its own planes.
//  * Experts. `experts_kernel` runs the same block body over a stack of
//    E matrices of one shape: grid.z walks expert × group of 4 rows, and
//    a block offsets its member's activations, planes, scales and output
//    by its expert's strides (no table, no copy of the planes). Given
//    counts (device memory), expert e's rows at and past counts[e] are
//    taken as zero: they are not loaded, their outputs are written as
//    zero, and a block whose 4 rows are all past it reads no planes.
//  * Fold. With one split (no workspace given) a block owns every tile of
//    its strip and writes the output: B3 the sum of its warps' partials in
//    warp order, B1/B2 the epilogue out = fma(f32(corr_t), scale_t, out) in
//    ascending tile order, bitwise the plain version's. Given a workspace,
//    the blocks write to it (B3 each split's partial, (splits, B, M); B1/B2
//    each tile's correction, (tiles, B, ΣM)) and a second small launch
//    folds it in the same fixed order: deterministic, no atomics on floats.
//    The wrapper passes one exactly when the plan has several splits.
//  * Ragged edges. Words past a member's last one are zero bits and are
//    not read; columns past its M load as zero and are not stored; batch
//    rows past B are not stored. M not a multiple of 4 (or planes not
//    16-byte aligned) takes scalar loads.
//
// Launch functions return cudaGetLastError() after their launches; the
// Python wrapper raises on anything but 0.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

#include "gemv_common.cuh"

namespace {

constexpr int kRows = 4;             // batch rows per block (grid.z)
constexpr int kOut = kRows * kStrip; // outputs of a block's strip
constexpr int kMaxUnit = 4;          // words per work item
constexpr int kMaxMembers = 8;       // members of a by-value table
constexpr float kMagic = 8388608.f;  // as_float(0x4B000000 | c) = 2^23 + c

__host__ __device__ constexpr int unit_words(int q) {
  return q >= 4 ? 1 : 4 / q;
}

// One weight matrix of a launch. Element (plane i, tile t, word j of the
// tile, column c) of the planes lies at planes[i·plane_stride +
// t·tile_stride + j·word_stride + c]; the codes (floats for B3) of batch
// row r, tile t, reduction row k of the tile at a[r·a_row + t·a_tile + k];
// tile t's scale of column c at scales[t·scale_stride + c]; output (r, c)
// at out[r·out_row + c], and, split, at workspace column col + c. Words
// t·(bn/32) + j ≥ words are zero bits and are not read. `kernel.Member`
// (ctypes) mirrors it field for field.
struct Member {
  const void* a;
  const int32_t* planes;
  const float* scales;
  float* out;
  long long a_row, a_tile, plane_stride, tile_stride;
  int word_stride, scale_stride, out_row, col;
  int m, words, tiles, bn;
  int q;         // weight planes
  int mask;      // (1 << p) − 1 (B1/B2)
  int z_a;       // activation zero point (B1/B2)
  int zero;      // weight zero point
  int strip0;    // the member's first strip in the launch's grid.x
  int vec;       // 16-byte loads: m % 4 == 0, planes and scales aligned
  int pad0, pad1;
};
static_assert(sizeof(Member) == 128, "kernel.Member mirrors this layout");

struct Table {
  Member m[kMaxMembers];
  int n, pad;
};

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

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename V>
__device__ __forceinline__ uint32_t geti(const V& v, int i) {
  return static_cast<uint32_t>(i == 0 ? v.x : i == 1 ? v.y
                                                     : i == 2 ? v.z : v.w);
}

// One block's work on member mb: strip `strip` of its 128-column strips,
// tiles [t_begin, t_begin + nt) with t_begin = split·tiles_per_block,
// batch rows row0 + [0, 4) of B. Rows at and past `live_rows` (≤ B) are
// taken as zero: not loaded, and with row0 ≥ live_rows no plane is read.
// q ≤ Q: the member's own planes. ws: null when the block owns every tile
// of its strip (one split) and writes the output, else B3 (splits, B,
// ws_cols) f32 and B1/B2 (tiles, B, ws_cols) int32.
template <int Q, bool kInt>
__device__ __forceinline__ void gemv_block(const Member& mb, int q,
                                           int strip, int split, int row0,
                                           int B, int live_rows, void* ws,
                                           int ws_cols, int tiles_per_block,
                                           Smem& sm) {
  constexpr int U = unit_words(Q);
  static_assert(U <= kMaxUnit, "unit too wide for the staging buffer");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int M = mb.m;
  const int m0 = strip * kStrip;                    // the strip's column 0
  const int m = m0 + lane * kCols;
  const int wpt = mb.bn >> 5;                       // words per tile
  const int upt = (wpt + U - 1) / U;                // items per tile
  const int t_begin = split * tiles_per_block;
  const int nt = min(tiles_per_block, mb.tiles - t_begin);
  if (nt <= 0) return;                              // block-uniform
  const bool vec = mb.vec != 0;

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

  const int items = row0 < live_rows ? nt * upt : 0;  // else rows all 0
  for (int it = warp; it < items; it += kWarps) {
    const int tl = it / upt;
    const int t = t_begin + tl;
    const int j0 = (it - tl * upt) * U;             // first word in the tile
    const int w0 = t * wpt + j0;
    const int live = min(min(U, wpt - j0), mb.words - w0);
    if (live <= 0) continue;                        // padding words only
    // every load of the unit first: q·U plane words, then activations
    const int32_t* pw = mb.planes + t * mb.tile_stride
                        + static_cast<long long>(j0) * mb.word_stride + m;
    uint32_t wd[U][Q][kCols];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        int4 v = make_int4(0, 0, 0, 0);
        if (u < live && i < q)
          v = load4(pw + i * mb.plane_stride
                        + static_cast<long long>(u) * mb.word_stride,
                    m, M, vec);
#pragma unroll
        for (int c = 0; c < kCols; ++c) wd[u][i][c] = geti(v, c);
      }
    // B3: the tile's scales, loaded beside the planes
    const float4 sc = kInt ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : load4f(mb.scales + t * static_cast<long long>(
                                        mb.scale_stride) + m, m, M, vec);
    // B1 the codes, B3 the floats of reduction row 32(j0 + u) + lane
    using Act = std::conditional_t<kInt, int, float>;
    Act av[U][kRows];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        av[u][r] = 0;
        const int row = row0 + r;
        if (u < live && row < live_rows) {
          const long long at = row * mb.a_row + t * mb.a_tile
                               + (j0 + u) * 32 + lane;
          if constexpr (kInt)
            av[u][r] = static_cast<const uint8_t*>(mb.a)[at] & mb.mask;
          else
            av[u][r] = static_cast<const float*>(mb.a)[at];
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
      const int z_a = mb.z_a, z_w = mb.zero;
      const int rows_zz = 32 * live * z_a * z_w;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          atomicAdd(&corr[tl * kOut + r * kStrip + lane * kCols + c],
                    static_cast<int>(acc[r][c]) - z_w * sum_a[r]
                        - z_a * sum_w[c] + rows_zz);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
        act_f[u * 32 + lane] =
            make_float4(av[u][0], av[u][1], av[u][2], av[u][3]);
      __syncwarp();
      const float bias = kMagic + static_cast<float>(mb.zero);
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
    const int row = row0 + r, mc = m0 + col;
    if (row >= B || mc >= M) continue;
    const long long at = static_cast<long long>(row) * ws_cols + mb.col + mc;
    if constexpr (kInt) {
      if (whole) {
        float y = 0.f;
        for (int tl = 0; tl < nt; ++tl)
          y = __fmaf_rn(__int2float_rn(corr[tl * kOut + o]),
                        mb.scales[static_cast<long long>(t_begin + tl)
                                      * mb.scale_stride + mc], y);
        mb.out[static_cast<long long>(row) * mb.out_row + mc] = y;
      } else {
        for (int tl = 0; tl < nt; ++tl)
          static_cast<int*>(ws)[static_cast<long long>(t_begin + tl) * B
                                    * ws_cols + at] = corr[tl * kOut + o];
      }
    } else {
      float y = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) y += sm.part[w][o];
      if (whole)
        mb.out[static_cast<long long>(row) * mb.out_row + mc] = y;
      else
        static_cast<float*>(ws)[static_cast<long long>(split) * B * ws_cols
                                + at] = y;
    }
  }
}

// B1 and B3: one member, a by-value parameter.
template <int Q, bool kInt>
__global__ void __launch_bounds__(kThreads)
leaf_kernel(const Member mb, void* __restrict__ ws, int B,
            int tiles_per_block) {
  __shared__ Smem sm;
  gemv_block<Q, kInt>(mb, Q, blockIdx.x, blockIdx.y, blockIdx.z * kRows, B,
                      B, ws, mb.m, tiles_per_block, sm);
}

// B3 over a stack of experts of one shape: grid.z = expert × row group;
// mb describes expert 0, and expert e's activations, planes, scales and
// output lie a_expert, plane_expert, scale_expert and R·M elements
// further (its workspace slice splits·R·M). counts: null, or (E,) rows
// with data per expert.
template <int Q>
__global__ void __launch_bounds__(kThreads)
experts_kernel(const Member mb, long long a_expert, long long plane_expert,
               long long scale_expert, const int* __restrict__ counts,
               float* __restrict__ ws, int R, int row_groups,
               int tiles_per_block, int splits) {
  __shared__ Smem sm;
  const int e = blockIdx.z / row_groups;
  const int row0 = (blockIdx.z - e * row_groups) * kRows;
  const long long rm = static_cast<long long>(R) * mb.m;
  Member me = mb;
  me.a = static_cast<const float*>(mb.a) + e * a_expert;
  me.planes = mb.planes + e * plane_expert;
  me.scales = mb.scales + e * scale_expert;
  me.out = mb.out + e * rm;
  const int live = counts == nullptr ? R : max(0, min(counts[e], R));
  gemv_block<Q, false>(me, Q, blockIdx.x, blockIdx.y, row0, R, live,
                       ws == nullptr ? nullptr : ws + e * splits * rm,
                       mb.m, tiles_per_block, sm);
}

// The member whose strips hold grid column `strip` into dst (shared
// memory), from the by-value table, or from gtab[0, n) in device memory
// when gtab is not null. Members' strip0 ascend. Warp 0 only.
__device__ __forceinline__ void select_member(const Table& tab,
                                              const Member* gtab, int n,
                                              int strip, Member& dst) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  if (gtab != nullptr) {
    int best = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const unsigned le = __ballot_sync(kFull,
                                        i < n && gtab[i].strip0 <= strip);
      if (le) best = base + 31 - __clz(le);
    }
    constexpr int kWords = sizeof(Member) / 4;
    const int* src = reinterpret_cast<const int*>(gtab + best);
    int* d = reinterpret_cast<int*>(&dst);
    for (int k = lane; k < kWords; k += 32) d[k] = src[k];
  } else if (lane == 0) {
    // static indices only: a by-value parameter is never indexed at run
    // time
    Member pick = tab.m[0];
#pragma unroll
    for (int i = 1; i < kMaxMembers; ++i)
      if (i < tab.n && tab.m[i].strip0 <= strip) pick = tab.m[i];
    dst = pick;
  }
}

// B2: the members of a group, grid.x over all their strips; Q the largest
// q of the members.
template <int Q>
__global__ void __launch_bounds__(kThreads)
group_kernel(const Table tab, const Member* __restrict__ gtab, int n,
             void* __restrict__ ws, int ws_cols, int B,
             int tiles_per_block) {
  __shared__ Smem sm;
  __shared__ Member mb;
  select_member(tab, gtab, n, blockIdx.x, mb);
  __syncthreads();
  gemv_block<Q, true>(mb, mb.q, blockIdx.x - mb.strip0, blockIdx.y,
                      blockIdx.z * kRows, B, B, ws, ws_cols, tiles_per_block,
                      sm);
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

// B2's epilogue over the workspace, the same per member: block x folds
// strip x of the launch, every batch row. ws (tiles, B, ws_cols) int32.
__global__ void __launch_bounds__(kThreads)
fold_group_kernel(const Table tab, const Member* __restrict__ gtab, int n,
                  const int* __restrict__ ws, int ws_cols, int B) {
  __shared__ Member mb;
  select_member(tab, gtab, n, blockIdx.x, mb);
  __syncthreads();
  const int c = (blockIdx.x - mb.strip0) * kStrip + threadIdx.x % kStrip;
  if (c >= mb.m) return;
  for (int row = threadIdx.x / kStrip; row < B;
       row += kThreads / kStrip) {
    float y = 0.f;
    for (int t = 0; t < mb.tiles; ++t)
      y = __fmaf_rn(
          __int2float_rn(ws[(static_cast<long long>(t) * B + row) * ws_cols
                            + mb.col + c]),
          mb.scales[static_cast<long long>(t) * mb.scale_stride + c], y);
    mb.out[static_cast<long long>(row) * mb.out_row + c] = y;
  }
}

// B3's fold: out = Σ_s part_s in split order. part (E, splits, B, M)
// f32 (E = 1 for one matrix), out (E, B, M); BM = B·M, total = E·B·M.
__global__ void fold_float_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, long BM,
                                  long total, int splits) {
  const long o = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const long e = o / BM, i = o - e * BM;
  float y = 0.f;
  for (int s = 0; s < splits; ++s) y += part[(e * splits + s) * BM + i];
  out[o] = y;
}

// The checks of a one-matrix launch and its split; true if valid.
bool plan_ok(int q, int bn, int n_pad, int tiles_per_block, int splits,
             const void* ws) {
  const int tiles = bn > 0 ? n_pad / bn : 0;
  return !(q < 1 || q > 8 || bn % 32 || bn <= 0 || n_pad % bn
           || tiles_per_block < 1 || tiles_per_block > kMaxTiles
           || splits != (tiles + tiles_per_block - 1) / tiles_per_block
           || (splits > 1 && ws == nullptr));
}

// The member of one (B, n_pad) × (q, n_words, M) matrix, its tile scales
// (n_pad/bn, M) a scale_stride apart.
Member leaf_member(const void* a, const void* planes, const void* scales,
                   void* out, int n_pad, int n_words, int M, int q, int bn,
                   int mask, int z_a, int zero, int scale_stride) {
  Member mb{};
  mb.a = a;
  mb.planes = static_cast<const int32_t*>(planes);
  mb.scales = static_cast<const float*>(scales);
  mb.out = static_cast<float*>(out);
  mb.a_row = n_pad;
  mb.a_tile = bn;
  mb.plane_stride = static_cast<long long>(n_words) * M;
  mb.tile_stride = static_cast<long long>(bn / 32) * M;
  mb.word_stride = M;
  mb.scale_stride = scale_stride;
  mb.out_row = M;
  mb.m = M;
  mb.words = n_words;
  mb.tiles = n_pad / bn;
  mb.bn = bn;
  mb.q = q;
  mb.mask = mask;
  mb.z_a = z_a;
  mb.zero = zero;
  mb.vec = M % kCols == 0 && scale_stride % kCols == 0 && aligned16(planes)
           && aligned16(scales);
  return mb;
}

template <bool kInt>
int launch(const void* a, const void* planes, const void* scales, void* out,
           void* ws, int B, int n_pad, int n_words, int M, int q, int bn,
           int mask, int z_a, int zero, int tiles_per_block, int splits,
           cudaStream_t stream) {
  if (!plan_ok(q, bn, n_pad, tiles_per_block, splits, ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const Member mb = leaf_member(a, planes, scales, out, n_pad, n_words, M, q,
                                bn, mask, z_a, zero, M);
  const int tiles = mb.tiles;
  const dim3 grid((M + kStrip - 1) / kStrip, splits, (B + kRows - 1) / kRows);
#define LEAF_CASE(QQ)                                                       \
  case QQ:                                                                  \
    leaf_kernel<QQ, kInt><<<grid, kThreads, 0, stream>>>(                   \
        mb, ws, B, tiles_per_block);                                        \
    break;
  switch (q) {
    LEAF_CASE(1) LEAF_CASE(2) LEAF_CASE(3) LEAF_CASE(4)
    LEAF_CASE(5) LEAF_CASE(6) LEAF_CASE(7) LEAF_CASE(8)
  }
#undef LEAF_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return static_cast<int>(err);
  const long bm = static_cast<long>(B) * M;
  const int blocks = static_cast<int>((bm + 255) / 256);
  if (kInt)
    fold_int_kernel<<<blocks, 256, 0, stream>>>(
        static_cast<const int*>(ws), mb.scales, mb.out, B, M, tiles);
  else
    fold_float_kernel<<<blocks, 256, 0, stream>>>(
        static_cast<const float*>(ws), mb.out, bm, bm, splits);
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

// B3 over E experts: a (E, R, n_pad) f32 padded with 0; planes (E, q,
// n_words, M) int32; scales: expert e's tile t at scales[e·scale_expert +
// t·scale_tile] (scale_tile 0: per-channel scales read for every tile);
// counts null or (E,) int32 → out (E, R, M) f32. ws: (E, splits, R, M)
// f32, or null with one split.
extern "C" int gemv_f_experts_launch(const void* a, const void* planes,
                                     const void* scales, void* out,
                                     void* ws, const void* counts, int E,
                                     int R, int n_pad, int n_words, int M,
                                     int q, int zero, int bn,
                                     int scale_expert, int scale_tile,
                                     int tiles_per_block, int splits,
                                     void* stream) {
  const int row_groups = (R + kRows - 1) / kRows;
  if (!plan_ok(q, bn, n_pad, tiles_per_block, splits, ws) || E < 1
      || R < 1 || static_cast<long>(E) * row_groups > 65535
      || scale_expert < 0 || scale_tile < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Member mb = leaf_member(a, planes, scales, out, n_pad, n_words, M, q, bn,
                          0, 0, zero, scale_tile);
  mb.vec = mb.vec && scale_expert % kCols == 0;
  const long long a_expert = static_cast<long long>(R) * n_pad;
  const long long plane_expert = static_cast<long long>(q) * n_words * M;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + kStrip - 1) / kStrip, splits, E * row_groups);
  const int* cnt = static_cast<const int*>(counts);
  float* wsf = splits > 1 ? static_cast<float*>(ws) : nullptr;
#define EXPERTS_CASE(QQ)                                                    \
  case QQ:                                                                  \
    experts_kernel<QQ><<<grid, kThreads, 0, st>>>(                          \
        mb, a_expert, plane_expert, scale_expert, cnt, wsf, R, row_groups,  \
        tiles_per_block, splits);                                           \
    break;
  switch (q) {
    EXPERTS_CASE(1) EXPERTS_CASE(2) EXPERTS_CASE(3) EXPERTS_CASE(4)
    EXPERTS_CASE(5) EXPERTS_CASE(6) EXPERTS_CASE(7) EXPERTS_CASE(8)
  }
#undef EXPERTS_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || wsf == nullptr) return static_cast<int>(err);
  const long rm = static_cast<long>(R) * M, total = rm * E;
  fold_float_kernel<<<static_cast<int>((total + 255) / 256), 256, 0, st>>>(
      wsf, static_cast<float*>(out), rm, total, splits);
  return static_cast<int>(cudaGetLastError());
}

// B2 over a group: the members in *tab (tab->n ≤ 8), or, when gtab is not
// null, the n members at gtab in device memory (tab then unread). strips:
// Σ ceil(m / 128) over the members, whose strip0 ascend from 0; q_max the
// members' largest q; each member's tiles ≤ splits·tiles_per_block. ws:
// (max tiles, B, ws_cols) int32, or null with one split.
extern "C" int gemv_group_launch(const void* tab, const void* gtab, int n,
                                 int strips, void* ws, int ws_cols, int B,
                                 int q_max, int tiles_per_block, int splits,
                                 void* stream) {
  if (q_max < 1 || q_max > 8 || n < 1 || strips < 1 || B < 1
      || tiles_per_block < 1 || tiles_per_block > kMaxTiles || splits < 1
      || (gtab == nullptr && (tab == nullptr
                              || static_cast<const Table*>(tab)->n != n
                              || n > kMaxMembers))
      || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  if (gtab == nullptr) t = *static_cast<const Table*>(tab);
  const auto* g = static_cast<const Member*>(gtab);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(strips, splits, (B + kRows - 1) / kRows);
  void* one = splits > 1 ? ws : nullptr;
#define GROUP_CASE(QQ)                                                      \
  case QQ:                                                                  \
    group_kernel<QQ><<<grid, kThreads, 0, st>>>(                            \
        t, g, n, one, ws_cols, B, tiles_per_block);                          \
    break;
  switch (q_max) {
    GROUP_CASE(1) GROUP_CASE(2) GROUP_CASE(3) GROUP_CASE(4)
    GROUP_CASE(5) GROUP_CASE(6) GROUP_CASE(7) GROUP_CASE(8)
  }
#undef GROUP_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  fold_group_kernel<<<strips, kThreads, 0, st>>>(
      t, g, n, static_cast<const int*>(ws), ws_cols, B);
  return static_cast<int>(cudaGetLastError());
}

// A member table in device memory (more members than a by-value Table
// holds: a whole decode block) keeps its static fields from one upload;
// each call rewrites only the first five fields of every member (a,
// planes, scales, out, a_row: the codes and output of that call) with one
// strided host-to-device copy on the launch's stream, so the previous
// launch has read the table before it changes. `rows` is n rows of
// kPerCall bytes, in pageable memory: the copy stages it before
// returning.
constexpr size_t kPerCall = 5 * sizeof(long long);
static_assert(offsetof(Member, a_tile) == kPerCall,
              "the per-call fields lead every Member");

extern "C" int gemv_table_pointers(void* gtab, const void* rows, int n,
                                   void* stream) {
  if (gtab == nullptr || rows == nullptr || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpy2DAsync(
      gtab, sizeof(Member), rows, kPerCall, kPerCall, n,
      cudaMemcpyHostToDevice, static_cast<cudaStream_t>(stream)));
}
