// roll_n: n circular shifts of each row of x [B, K] f32, the j-th by
// 1 + (j mod 7), one after the other, written for Hopper (sm_90a). Replaces
// the TPU kernel scripts/opt_hop2.py:120 (roll_kernel_n, launched at :132),
// a calibration: its time / n / B is the cost of one exchange step of a
// sort. So each shift stays a real exchange, never one shift by the sum.
//
// Two kernels, routed by width (ops/pool_sort.roll_n_route):
//   warp    K = 32 W words, W <= 16: a row lives in one warp's registers,
//           lane l holding words l*W .. l*W + W - 1 (pool_merge's warp
//           layout). A shift by s moves word p to p + s: the W - s words
//           that stay in the lane are register renames, and each of the
//           min(s, W) words that cross a lane boundary is one __shfl_sync
//           from the lane below (the row wraps from lane 31 to lane 0).
//           The shifts 1..7 are unrolled, so s and every register index is
//           known to the compiler: a step of shift s costs min(s, W)
//           shuffles, 4 on average at W = 8 against 8 for a layout that
//           strides a row across the lanes word by word. Loads and stores
//           are 16-byte vectors where W % 4 == 0 (a warp covers 128 W
//           contiguous bytes), words otherwise.
//   shared  any other K (to pool_sort's 16,384): every shift is one partner
//           read in shared memory and one barrier.
// Bound: memory, each word read once and written once; the exchanges
// (n x K a row) stay below it only in registers: the shared kernel pays a
// round trip and a barrier per step.
//
// Plain C entry points for ctypes; each returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kRowsPerBlock = kBlock / 32;   // warp route: a row per warp

// one shift by S of the row held as v[i] = word lane*W + i
template <int W, int S>
__device__ __forceinline__ void shift(float (&v)[W], int lane) {
  float nv[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const int src = i - S;                 // the word's old register ...
    if (src >= 0) {
      nv[i] = v[src];
    } else {                               // ... in a lane below
      const int back = (W - 1 - src) / W;
      nv[i] = __shfl_sync(0xffffffffu, v[src + back * W], (lane - back) & 31);
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    v[i] = nv[i];
  }
}

template <int W>
__global__ void __launch_bounds__(kBlock)
roll_n_warp_kernel(const float* __restrict__ x, float* __restrict__ out,
                   long long B, int n) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= B) {
    return;   // the whole warp: the shuffles below need all 32 lanes
  }
  const long long first = row * (32 * W) + lane * W;
  const bool vec = W % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  float v[W];
  if (vec) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(x + first + i));
      v[i] = t.x;
      v[(i + 1) % W] = t.y;
      v[(i + 2) % W] = t.z;
      v[(i + 3) % W] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      v[i] = __ldg(x + first + i);
    }
  }
  int j = 0;
  for (; j + 7 <= n; j += 7) {
    shift<W, 1>(v, lane);
    shift<W, 2>(v, lane);
    shift<W, 3>(v, lane);
    shift<W, 4>(v, lane);
    shift<W, 5>(v, lane);
    shift<W, 6>(v, lane);
    shift<W, 7>(v, lane);
  }
  const int rest = n - j;                  // shifts 1 .. rest, rest < 7
  if (rest > 0) shift<W, 1>(v, lane);
  if (rest > 1) shift<W, 2>(v, lane);
  if (rest > 2) shift<W, 3>(v, lane);
  if (rest > 3) shift<W, 4>(v, lane);
  if (rest > 4) shift<W, 5>(v, lane);
  if (rest > 5) shift<W, 6>(v, lane);
  if (vec) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      *reinterpret_cast<float4*>(out + first + i) =
          make_float4(v[i], v[(i + 1) % W], v[(i + 2) % W], v[(i + 3) % W]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      out[first + i] = v[i];
    }
  }
}

__global__ void __launch_bounds__(kBlock)
roll_n_shared_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int K, int n) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = cur + K;
  const long long base = static_cast<long long>(blockIdx.x) * K;
  for (int idx = threadIdx.x; idx < K; idx += kBlock) {
    cur[idx] = __ldg(x + base + idx);
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const int shift = (1 + j % 7) % K;
    for (int idx = threadIdx.x; idx < K; idx += kBlock) {
      const int src = idx - shift;
      nxt[idx] = cur[src < 0 ? src + K : src];
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int idx = threadIdx.x; idx < K; idx += kBlock) {
    out[base + idx] = cur[idx];
  }
}

template <int W>
int launch_warp(const void* x, void* out, long long B, int n,
                cudaStream_t stream) {
  const long long grid = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  roll_n_warp_kernel<W><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), B, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K must be 32 W with 1 <= W <= 16
extern "C" int alaya_roll_n_warp(const void* x, void* out, long long B, int K,
                                 int n, void* stream) {
  if (B == 0) {
    return 0;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
#define ALAYA_ROLL_CASE(W) \
  case 32 * W:             \
    return launch_warp<W>(x, out, B, n, s);
    ALAYA_ROLL_CASE(1)
    ALAYA_ROLL_CASE(2)
    ALAYA_ROLL_CASE(3)
    ALAYA_ROLL_CASE(4)
    ALAYA_ROLL_CASE(5)
    ALAYA_ROLL_CASE(6)
    ALAYA_ROLL_CASE(7)
    ALAYA_ROLL_CASE(8)
    ALAYA_ROLL_CASE(9)
    ALAYA_ROLL_CASE(10)
    ALAYA_ROLL_CASE(11)
    ALAYA_ROLL_CASE(12)
    ALAYA_ROLL_CASE(13)
    ALAYA_ROLL_CASE(14)
    ALAYA_ROLL_CASE(15)
    ALAYA_ROLL_CASE(16)
#undef ALAYA_ROLL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int alaya_roll_n_shared(const void* x, void* out, long long B,
                                   int K, int n, void* stream) {
  if (B == 0 || K == 0) {
    return 0;
  }
  const size_t smem = static_cast<size_t>(2) * K * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        roll_n_shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  roll_n_shared_kernel<<<static_cast<unsigned>(B), kBlock, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), K, n);
  return static_cast<int>(cudaGetLastError());
}
