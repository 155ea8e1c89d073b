// block_diagdot: fused u8 decode + per-query dot for the block-search
// estimate stage, written for Hopper (sm_90a).
//
//   out[b, k] = sum_d (codes[b, k, d] - 128) * qs[b, d]
//   codes u8 [B, K, Dp], qs bf16 [B, Dp] -> out f32 [B, K]
//
// Replaces the TPU kernel alayalite_tpu/ops/pallas_block.py:46
// (_diagdot_kernel, launched through _diagdot_call / block_diagdot). That
// kernel builds a [BT*K, BT] MXU product and keeps its block diagonal, a
// trick for the TPU's matrix unit; here each query's rows are a plain
// per-row dot on the CUDA cores.
//
// Bound: memory. Every code byte is read once and used in one
// multiply-add, so at the main-path shape (B=4096, K=256, Dp=128) the
// kernel moves 134.2 MB of codes + 1.0 MB of qs + 4.2 MB of output,
// ~139.5 MB, i.e. ~42 us at 3.35 TB/s; its 0.27 GFLOP are nothing to the
// card. The design therefore only has to stream the codes at full width:
//   - one block per (query b, tile of kRowsPerBlock rows of K);
//   - qs[b] is staged once per block in shared memory as f32;
//   - 8 lanes share a row and each lane loads 16 contiguous code bytes
//     (uint4) per step, so a warp reads 4 whole 128-byte rows at once;
//     when Dp % 16 != 0 (or the base is not 16-byte aligned) a scalar
//     loop reads one byte per lane per step instead;
//   - the 8 partial sums of a row meet in a warp-shuffle reduction.
// (c - 128) is exact in bf16 and every bf16 x bf16 product is exact in
// f32, so results differ from the plain PyTorch version only in the order
// of the f32 sums.
//
// Plain C entry point for ctypes; returns cudaGetLastError() after launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerRow = 8;
constexpr int kRowsPerPass = kThreads / kLanesPerRow;  // 32
constexpr int kRowsPerBlock = 64;
constexpr int kPasses = kRowsPerBlock / kRowsPerPass;  // 2

__device__ __forceinline__ float dot16(uint4 v, const float* q) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const float4* q4 = reinterpret_cast<const float4*>(q);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 qq = q4[i];
    const float qv[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = static_cast<int>((w[i] >> (8 * j)) & 0xFFu) - 128;
      acc = fmaf(static_cast<float>(c), qv[j], acc);
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
block_diagdot_kernel(const uint8_t* __restrict__ codes,
                     const __nv_bfloat16* __restrict__ qs,
                     float* __restrict__ out, long long K, int Dp, int vec) {
  extern __shared__ float q_s[];
  const long long b = blockIdx.x;
  const __nv_bfloat16* qb = qs + b * Dp;
  for (int d = threadIdx.x; d < Dp; d += kThreads) {
    q_s[d] = __bfloat162float(qb[d]);
  }
  __syncthreads();

  const int lane = threadIdx.x % kLanesPerRow;
  const int grp = threadIdx.x / kLanesPerRow;
  const long long k0 = static_cast<long long>(blockIdx.y) * kRowsPerBlock;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const long long k = k0 + p * kRowsPerPass + grp;
    float acc = 0.f;
    if (k < K) {
      const uint8_t* row = codes + (b * K + k) * Dp;
      if (vec) {
        for (int d0 = lane * 16; d0 < Dp; d0 += kLanesPerRow * 16) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + d0));
          acc += dot16(v, q_s + d0);
        }
      } else {
        for (int d = lane; d < Dp; d += kLanesPerRow) {
          const int c = static_cast<int>(__ldg(row + d)) - 128;
          acc = fmaf(static_cast<float>(c), q_s[d], acc);
        }
      }
    }
    // every lane of the warp reaches the shuffles (rows past K add 0)
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off, kLanesPerRow);
    }
    if (lane == 0 && k < K) {
      out[b * K + k] = acc;
    }
  }
}

}  // namespace

extern "C" int alaya_block_diagdot(const void* codes, const void* qs,
                                   void* out, long long B, long long K,
                                   long long Dp, int vec, void* stream) {
  if (B == 0 || K == 0) {
    return 0;
  }
  const size_t smem = static_cast<size_t>(Dp) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        block_diagdot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const dim3 grid(static_cast<unsigned>(B),
                  static_cast<unsigned>((K + kRowsPerBlock - 1) / kRowsPerBlock));
  block_diagdot_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(qs), static_cast<float*>(out), K,
      static_cast<int>(Dp), vec);
  return static_cast<int>(cudaGetLastError());
}
