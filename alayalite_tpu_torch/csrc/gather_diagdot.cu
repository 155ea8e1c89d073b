// gather_diagdot: the block hop's estimate stage with the neighbor-block
// gather inside the kernel, written for Hopper (sm_90a).
//
//   out[b, m*R + r] = sum_d (codes[u[b, m], r, d] - 128) * qs[b, d]
//   codes u8 [C, R, Dp], u i32 [B, M] in [0, C), qs bf16 [B, Dp]
//   -> out f32 [B, M*R]
//
// Two entry points, one per TPU kernel replaced:
//   direct  scripts/proto_dma_gather.py:48  (kernel -> dma_diagdot): every
//           popped node's block is copied by DMA into scratch, then one
//           product is taken;
//   staged  scripts/proto_dma_gather2.py:48 (kernel -> dma2_diagdot): the
//           same with two buffers, the next tile's copies in flight while
//           this tile computes.
// Neither is carried over tile by tile. The TPU kernels batch 32 queries
// so that their decoded blocks fill one MXU product whose block diagonal is
// kept; on Hopper that product is wasted work and each row is a plain dot
// on the CUDA cores, as in diagdot.cu.
//
// Bound: memory. Every code byte is read once and used in one multiply-add:
// at the main-path shape (B=4096, M=8, R=32, Dp=128) the kernel must move
// 134.2 MB of codes + 1.0 MB of qs + 4.2 MB of output + 0.1 MB of ids,
// 139.6 MB, ~42 us at 3.35 TB/s. A gather outside the kernel (index_select
// into a [B, M*R, Dp] tensor that block_diagdot reads back) moves the code
// bytes three times. A node's block is R*Dp contiguous bytes (4 KB here),
// addressed as u * R * Dp in 64 bits: the offset passes 2^31 at 1M nodes.
//
//   direct: one block per (query b, popped node m). qs[b] is staged in
//     shared memory as f32; 8 lanes share a code row and each lane loads 16
//     contiguous bytes straight from the node's block in device memory, so
//     a warp reads 4 whole 128-byte rows per step; the 8 partial sums meet
//     in a warp shuffle.
//   staged: a block walks a contiguous run of (b, m) pairs with two
//     shared-memory stages. While it computes pair i from one stage, the
//     16-byte cp.async copies of pair i+1's block are in flight into the
//     other (commit_group / wait_group take the place of the TPU's DMA
//     semaphores); qs[b] is staged again only when b changes.
// Both fall back to byte loads where 16-byte accesses are not possible
// (Dp % 16 != 0, R*Dp % 16 != 0, or a base that is not 16-byte aligned).
// (c - 128) is exact in bf16 and every bf16 x bf16 product is exact in f32,
// so results differ from the plain PyTorch version only in the order of the
// f32 sums.
//
// Plain C entry points for ctypes; each returns cudaGetLastError() after
// the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanesPerRow = 8;
constexpr int kRowsPerPass = kThreads / kLanesPerRow;  // 32
constexpr int kBlocksPerSM = 8;  // staged: resident blocks that share an SM
constexpr size_t kMaxSmem = 227 * 1024;

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

// kGlobal: the block lies in device memory (read-only path); else in shared.
template <bool kGlobal>
__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  if (kGlobal) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  return *reinterpret_cast<const uint4*>(p);
}

template <bool kGlobal>
__device__ __forceinline__ int load1(const uint8_t* p) {
  return static_cast<int>(kGlobal ? __ldg(p) : *p);
}

// The R dots of one node's block `blk` [R, Dp] against q_s, written to
// out_row[0..R). Every thread of the block calls it.
template <bool kGlobal>
__device__ __forceinline__ void block_rows(const uint8_t* blk,
                                           const float* q_s, float* out_row,
                                           int R, int Dp, int vec) {
  const int lane = threadIdx.x % kLanesPerRow;
  const int grp = threadIdx.x / kLanesPerRow;
  for (int r0 = 0; r0 < R; r0 += kRowsPerPass) {
    const int r = r0 + grp;
    float acc = 0.f;
    if (r < R) {
      const uint8_t* row = blk + static_cast<long long>(r) * Dp;
      if (vec) {
        for (int d0 = lane * 16; d0 < Dp; d0 += kLanesPerRow * 16) {
          acc += dot16(load16<kGlobal>(row + d0), q_s + d0);
        }
      } else {
        for (int d = lane; d < Dp; d += kLanesPerRow) {
          acc = fmaf(static_cast<float>(load1<kGlobal>(row + d) - 128),
                     q_s[d], acc);
        }
      }
    }
    // every lane of the warp reaches the shuffles (rows past R add 0)
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off, kLanesPerRow);
    }
    if (lane == 0 && r < R) {
      out_row[r] = acc;
    }
  }
}

__device__ __forceinline__ void stage_q(float* q_s,
                                        const __nv_bfloat16* qb, int Dp) {
  for (int d = threadIdx.x; d < Dp; d += kThreads) {
    q_s[d] = __bfloat162float(qb[d]);
  }
}

__global__ void __launch_bounds__(kThreads)
gather_diagdot_direct_kernel(const uint8_t* __restrict__ codes,
                             const int* __restrict__ u,
                             const __nv_bfloat16* __restrict__ qs,
                             float* __restrict__ out, int M, int R, int Dp,
                             int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  const long long b = blockIdx.x;
  const long long pair = b * M + blockIdx.y;
  stage_q(q_s, qs + b * Dp, Dp);
  __syncthreads();
  const long long node = __ldg(u + pair);
  const uint8_t* blk = codes + node * R * Dp;
  block_rows<true>(blk, q_s, out + pair * R, R, Dp, vec);
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__global__ void __launch_bounds__(kThreads)
gather_diagdot_staged_kernel(const uint8_t* __restrict__ codes,
                             const int* __restrict__ u,
                             const __nv_bfloat16* __restrict__ qs,
                             float* __restrict__ out, long long pairs,
                             long long per_block, int M, int R, int Dp,
                             int q_bytes, int stage_bytes, int vec_copy,
                             int vec_dot) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  uint8_t* stages = smem + q_bytes;
  const long long p0 = blockIdx.x * per_block;
  const long long p1 = p0 + per_block < pairs ? p0 + per_block : pairs;
  if (p0 >= p1) {
    return;
  }
  const long long blk_bytes = static_cast<long long>(R) * Dp;

  // start the copy of pair p's block into `dst`; one commit group per pair
  auto start_copy = [&](long long p, uint8_t* dst) {
    const long long node = __ldg(u + p);
    const uint8_t* src = codes + node * blk_bytes;
    if (vec_copy) {
      for (long long c = threadIdx.x * 16LL; c < blk_bytes;
           c += kThreads * 16LL) {
        cp_async16(dst + c, src + c);
      }
    } else {
      for (long long c = threadIdx.x; c < blk_bytes; c += kThreads) {
        dst[c] = __ldg(src + c);
      }
    }
    cp_async_commit();
  };

  start_copy(p0, stages);
  long long staged_b = -1;
  for (long long p = p0; p < p1; ++p) {
    const int slot = static_cast<int>((p - p0) & 1);
    const bool more = p + 1 < p1;
    if (more) {
      // the other stage was last read before the barrier that ended the
      // previous step
      start_copy(p + 1, stages + (slot ^ 1) * stage_bytes);
    }
    const long long b = p / M;
    if (b != staged_b) {
      stage_q(q_s, qs + b * Dp, Dp);
      staged_b = b;
    }
    if (more) {
      cp_async_wait<1>();  // this pair's group landed; the next may fly
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    block_rows<false>(stages + slot * stage_bytes, q_s, out + p * R, R, Dp,
                      vec_dot);
    __syncthreads();
  }
}

int raise_smem_limit(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  }
  return 0;
}

size_t round16(size_t n) { return (n + 15) / 16 * 16; }

}  // namespace

extern "C" int alaya_gather_diagdot_direct(const void* codes, const void* u,
                                           const void* qs, void* out,
                                           long long B, long long M,
                                           long long R, long long Dp, int vec,
                                           void* stream) {
  if (B == 0 || M == 0 || R == 0) {
    return 0;
  }
  const size_t smem = round16(static_cast<size_t>(Dp) * sizeof(float));
  const int err = raise_smem_limit(
      reinterpret_cast<const void*>(gather_diagdot_direct_kernel), smem);
  if (err != 0) {
    return err;
  }
  const dim3 grid(static_cast<unsigned>(B), static_cast<unsigned>(M));
  gather_diagdot_direct_kernel<<<grid, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int*>(u),
      static_cast<const __nv_bfloat16*>(qs), static_cast<float*>(out),
      static_cast<int>(M), static_cast<int>(R), static_cast<int>(Dp), vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int alaya_gather_diagdot_staged(const void* codes, const void* u,
                                           const void* qs, void* out,
                                           long long B, long long M,
                                           long long R, long long Dp,
                                           int vec_copy, int vec_dot,
                                           void* stream) {
  if (B == 0 || M == 0 || R == 0) {
    return 0;
  }
  const size_t q_bytes = round16(static_cast<size_t>(Dp) * sizeof(float));
  const size_t stage_bytes = round16(static_cast<size_t>(R) * Dp);
  const size_t smem = q_bytes + 2 * stage_bytes;
  int err = raise_smem_limit(
      reinterpret_cast<const void*>(gather_diagdot_staged_kernel), smem);
  if (err != 0) {
    return err;
  }
  int device = 0, sms = 0;
  err = static_cast<int>(cudaGetDevice(&device));
  if (err == 0) {
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device));
  }
  if (err != 0) {
    return err;
  }
  const long long pairs = B * M;
  const long long blocks = static_cast<long long>(sms) * kBlocksPerSM;
  const long long per_block = (pairs + blocks - 1) / blocks;
  const long long grid = (pairs + per_block - 1) / per_block;
  gather_diagdot_staged_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int*>(u),
      static_cast<const __nv_bfloat16*>(qs), static_cast<float*>(out), pairs,
      per_block, static_cast<int>(M), static_cast<int>(R),
      static_cast<int>(Dp), static_cast<int>(q_bytes),
      static_cast<int>(stage_bytes), vec_copy, vec_dot);
  return static_cast<int>(cudaGetLastError());
}
