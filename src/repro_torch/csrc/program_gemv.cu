// B2 program_gemv — replaces the TPU kernel `program_gemv` /
// `_program_kernel` (src/repro/kernels/bitplane_gemv/program.py): B1's
// integer core over the many layers of one concurrency group (q/k/v,
// up/gate) in a single launch.
//
// Inputs are the JAX package's slot-major packing: every (slot, reduction
// tile) cell holds a fixed (BN, BM) block padded up to the group's envelope
// with exactness-preserving values (zero plane bits, codes padded with the
// layer's z_a, and the epilogue's bn·z_a·z_w term on the padded BN), plus
// per-cell params [z_a, z_w, valid, layer]. Fully padded cells carry zero
// codes, planes, zero points and scales and contribute exactly 0.
//
// Bound. At decode it is bound by bytes: the packed planes of every member,
// q·N·M/8 per layer (12.6 MB for q/k/v, 22.5 MB for up/gate of llama2-7b
// at q = 2), read once.
//
// Design for that bound: the same as B1 (bitplane_gemv.cu), with the slot
// as a second grid axis. A block owns 32 columns of one slot; its 8 warps
// take the slot's reduction tiles in rounds; each round folds into the
// output in ascending tile order, one fused multiply-add per tile.

#include "bitplane_tile.cuh"

using namespace bitplane;

__global__ void __launch_bounds__(kWarps * 32)
program_gemv_kernel(const int32_t* __restrict__ params,
                    const uint8_t* __restrict__ codes,
                    const int32_t* __restrict__ planes,
                    const float* __restrict__ scales,
                    float* __restrict__ out, int NT, int B, int BN, int BM,
                    int q_max, int p_max) {
  __shared__ IntTileSmem sm;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long s = blockIdx.y;
  const int m = blockIdx.x * 32 + lane;
  const int row0 = blockIdx.z * kRows;
  const int rows = min(kRows, B - row0);
  const int words = BN >> 5;
  const long plane_stride = static_cast<long>(words) * BM;
  float acc = 0.f;
  for (int t0 = 0; t0 < NT; t0 += kWarps) {
    const int t = t0 + warp;
    if (t < NT) {
      const long cell = s * NT + t;
      const int32_t* prm = params + cell * 4;
      int_tile(codes + (cell * B + row0) * BN, BN, rows,
               planes + cell * q_max * plane_stride + m, plane_stride, BM,
               words, words, true, q_max, p_max, prm[0], prm[1], BN, sm, warp,
               lane);
    }
    __syncthreads();
    if (warp < rows)
      acc = int_epilogue(sm, min(kWarps, NT - t0),
                         scales + (s * NT + t0) * BM + m, BM, warp, lane,
                         acc);
    __syncthreads();
  }
  if (warp < rows) out[(s * B + row0 + warp) * BM + m] = acc;
}

extern "C" int program_gemv_launch(const void* params, const void* codes,
                                   const void* planes, const void* scales,
                                   void* out, int S, int NT, int B, int BN,
                                   int BM, int q_max, int p_max,
                                   void* stream) {
  const dim3 grid(BM / 32, S, (B + kRows - 1) / kRows);
  program_gemv_kernel<<<grid, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(params),
      static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(planes),
      static_cast<const float*>(scales), static_cast<float*>(out), NT, B, BN,
      BM, q_max, p_max);
  return static_cast<int>(cudaGetLastError());
}
