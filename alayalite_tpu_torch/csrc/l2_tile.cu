// l2_tile: a [Q, N] tile of squared L2 distances with the norm epilogue
// fused into the product, written for Hopper (sm_90a).
//
//   out[i, j] = max(|q_i|^2 + |x_j|^2 - 2 * q_i . x_j, 0)
//   q f32 [Q, D], x f32 [N, D] (both row-major) -> out f32 [Q, N]
//
// Replaces the TPU kernel alayalite_tpu/ops/pallas_distance.py:43
// (_l2_tile_kernel, launched through pairwise_l2_pallas). Like that kernel
// it computes both norms from the tiles it holds and takes no side inputs;
// its (256, 512) VMEM blocks and multiple-of-128 shapes are not carried
// over: this kernel takes any Q, N and D, masks the ragged edges and walks
// D in slices.
//
// Bound: operations. The product is 2*Q*N*D float32 operations on the CUDA
// cores (exact mode asks for full f32, so no TF32 tensor cores): at the
// flat scan's tile (Q=4096, N=16384, D=128) 17.18 GFLOP, 0.256 ms at
// 67 TFLOP/s, against 278.9 MB of traffic (the [Q, N] output dominates),
// 0.083 ms at 3.35 TB/s. The design is therefore a register-tiled product
// that keeps the FMA units fed and writes the output once:
//   - one block of 256 threads per 128 x 128 output tile;
//   - each step stages a 16-wide slice of D for the block's 128 q rows and
//     128 x rows in shared memory, transposed so that a thread reads its
//     operands as float4; the next slice is loaded into registers while
//     the current one is multiplied;
//   - each thread holds an 8 x 8 micro-tile of sums in registers;
//   - the thread that loads a row also sums its squares, so both norms
//     come from the staged values at no extra memory traffic; two lanes
//     share a row and meet in one shuffle;
//   - the epilogue clamps at 0 and writes each output element once, as
//     float4 where N % 4 == 0.
// Results differ from the plain PyTorch version only in the order of the
// float32 sums.
//
// Plain C entry point for ctypes; returns cudaGetLastError() after launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;                // rows of q and of x per block
constexpr int kStep = 16;                 // slice of D staged per step
constexpr int kLd = kTile + 4;            // shared row stride, 16-byte multiple
constexpr int kPerThread = kStep / 2;     // elements of one row a thread loads

template <bool kVec>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         bool ok, int d0, int D,
                                         float (&r)[kPerThread]) {
  if (kVec) {
    // D % 4 == 0 and 16-byte aligned rows: a float4 is wholly in or out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = d0 + 4 * h;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok && d < D) {
        v = __ldg(reinterpret_cast<const float4*>(row + d));
      }
      r[4 * h] = v.x;
      r[4 * h + 1] = v.y;
      r[4 * h + 2] = v.z;
      r[4 * h + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int d = d0 + e;
      r[e] = (ok && d < D) ? __ldg(row + d) : 0.f;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
l2_tile_kernel(const float* __restrict__ q, const float* __restrict__ x,
               float* __restrict__ out, long long Q, long long N, int D,
               int vec_out) {
  __shared__ __align__(16) float as[kStep][kLd];
  __shared__ __align__(16) float bs[kStep][kLd];
  __shared__ float qn_s[kTile];
  __shared__ float xn_s[kTile];

  const int tid = threadIdx.x;
  const long long i0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long j0 = static_cast<long long>(blockIdx.x) * kTile;

  // loader role: row lr of both tiles, columns [lc, lc + 8) of each slice
  const int lr = tid >> 1;
  const int lc = (tid & 1) * kPerThread;
  const bool qok = i0 + lr < Q;
  const bool xok = j0 + lr < N;
  const float* qrow = q + (qok ? i0 + lr : 0) * D;
  const float* xrow = x + (xok ? j0 + lr : 0) * D;

  // compute role: rows {ty*4 + i, 64 + ty*4 + i}, columns likewise with tx
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float ra[kPerThread], rb[kPerThread];
  float qn = 0.f, xn = 0.f;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.f;
    }
  }

  load_row<kVec>(qrow, qok, lc, D, ra);
  load_row<kVec>(xrow, xok, lc, D, rb);
  for (int k0 = 0; k0 < D; k0 += kStep) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      as[lc + e][lr] = ra[e];
      bs[lc + e][lr] = rb[e];
      qn = fmaf(ra[e], ra[e], qn);
      xn = fmaf(rb[e], rb[e], xn);
    }
    __syncthreads();
    if (k0 + kStep < D) {
      load_row<kVec>(qrow, qok, k0 + kStep + lc, D, ra);
      load_row<kVec>(xrow, xok, k0 + kStep + lc, D, rb);
    }
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // the two lanes that loaded a row hold its two half-sums
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  xn += __shfl_xor_sync(0xffffffffu, xn, 1);
  if ((tid & 1) == 0) {
    qn_s[lr] = qn;
    xn_s[lr] = xn;
  }
  __syncthreads();

  float xnc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    xnc[j] = xn_s[(j < 4 ? 0 : 64) + tx * 4 + (j & 3)];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    const long long row = i0 + r;
    if (row >= Q) {
      continue;
    }
    const float qni = qn_s[r];
    float* orow = out + row * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long col = j0 + h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = fmaxf(qni + xnc[4 * h + j] - 2.f * acc[i][4 * h + j], 0.f);
      }
      if (vec_out && col + 3 < N) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j < N) {
            orow[col + j] = v[j];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int alaya_l2_tile(const void* q, const void* x, void* out,
                             long long Q, long long N, long long D, int vec_in,
                             void* stream) {
  if (Q == 0 || N == 0) {
    return 0;
  }
  const dim3 grid(static_cast<unsigned>((N + kTile - 1) / kTile),
                  static_cast<unsigned>((Q + kTile - 1) / kTile));
  const int vec_out =
      (N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) ? 1 : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (vec_in) {
    l2_tile_kernel<true><<<grid, kThreads, 0, s>>>(qf, xf, of, Q, N,
                                                   static_cast<int>(D),
                                                   vec_out);
  } else {
    l2_tile_kernel<false><<<grid, kThreads, 0, s>>>(qf, xf, of, Q, N,
                                                    static_cast<int>(D),
                                                    vec_out);
  }
  return static_cast<int>(cudaGetLastError());
}
