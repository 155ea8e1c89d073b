// sq8_tile: a [Q, N] tile of asymmetric squared L2 distances from f32
// queries to SQ8 codes, with the decode fused into the product, written for
// Hopper (sm_90a).
//
//   qs    = bf16(q * scale)            cf   = c - 128 (exact in bf16)
//   shift = dmin + 128 * scale
//   dot[i, j]  = sum_d qs[i, d] * cf[j, d]            (f32 sums)
//   qconst[i]  = sum_d q[i, d]^2 - 2 q[i, d] shift[d]
//   xsq[j]     = sum_d (cf[j, d] * scale[d] + shift[d])^2
//   out[i, j]  = max(qconst[i] - 2 dot[i, j] + xsq[j], 0)
//   q f32 [Q, D], codes u8 [N, D], dmin / scale f32 [D] -> out f32 [Q, N]
//
// Replaces the TPU kernel alayalite_tpu/ops/pallas_distance.py:91
// (_sq8_tile_kernel, launched through sq8_pairwise_pallas), and computes
// what it computes: a bf16 x bf16 product is exact in f32, so the f32 FMAs
// here give the TPU's products and only the order of the sums differs. Its
// (256, 512) blocks and multiple-of-128 shapes are not carried over: any
// Q, N and D, ragged edges masked, D walked in slices.
//
// Bound: bytes. At (Q=4096, N=65536, D=128) the kernel must move 1,084 MB
// (the [Q, N] f32 output is 1,074 MB of it; the codes are a quarter of
// f32 rows), 0.324 ms at 3.35 TB/s, against 68.7 GFLOP that the bf16
// tensor cores would do in 0.070 ms. This first version is the l2_tile
// skeleton on the CUDA cores (same 2*Q*N*D operations at 67 TFLOP/s, about
// 1.0 ms), so it sits above that bound; a wgmma product is later work.
//   - one block of 256 threads per 128 x 128 output tile;
//   - each step stages a 16-wide slice of D: the q rows as bf16(q * scale)
//     and the code rows decoded to (c - 128), both as f32 in shared memory,
//     the next slice loaded into registers while the current one is used;
//   - an 8 x 8 register micro-tile of sums per thread;
//   - the thread that loads a row also sums its qconst or xsq terms from
//     the values it holds, so xsq is computed once per code row per block;
//   - the epilogue clamps at 0 and writes each output once (float4 where
//     N % 4 == 0).
//
// Plain C entry point for ctypes; returns cudaGetLastError() after launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;                // rows of q and of codes per block
constexpr int kStep = 16;                 // slice of D staged per step
constexpr int kLd = kTile + 4;            // shared row stride, 16-byte multiple
constexpr int kPerThread = kStep / 2;     // elements of one row a thread loads

template <bool kVec>
__device__ __forceinline__ void load_q(const float* __restrict__ row, bool ok,
                                       int d0, int D,
                                       float (&r)[kPerThread]) {
  if (kVec) {
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

// eight code bytes packed little-endian in two words
template <bool kVec>
__device__ __forceinline__ uint2 load_codes(const uint8_t* __restrict__ row,
                                            bool ok, int d0, int D) {
  uint2 v = make_uint2(0u, 0u);
  if (kVec) {
    // D % 8 == 0 and 8-byte aligned rows: eight bytes wholly in or out
    if (ok && d0 < D) {
      v = __ldg(reinterpret_cast<const uint2*>(row + d0));
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int d = d0 + e;
      const uint32_t c = (ok && d < D) ? __ldg(row + d) : 0u;
      if (e < 4) {
        v.x |= c << (8 * e);
      } else {
        v.y |= c << (8 * (e - 4));
      }
    }
  }
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
sq8_tile_kernel(const float* __restrict__ q, const uint8_t* __restrict__ codes,
                const float* __restrict__ dmin,
                const float* __restrict__ scale, float* __restrict__ out,
                long long Q, long long N, int D, int vec_out) {
  __shared__ __align__(16) float as[kStep][kLd];
  __shared__ __align__(16) float bs[kStep][kLd];
  __shared__ float qc_s[kTile];
  __shared__ float xs_s[kTile];

  const int tid = threadIdx.x;
  const long long i0 = static_cast<long long>(blockIdx.y) * kTile;
  const long long j0 = static_cast<long long>(blockIdx.x) * kTile;

  // loader role: row lr of both tiles, columns [lc, lc + 8) of each slice
  const int lr = tid >> 1;
  const int lc = (tid & 1) * kPerThread;
  const bool qok = i0 + lr < Q;
  const bool xok = j0 + lr < N;
  const float* qrow = q + (qok ? i0 + lr : 0) * D;
  const uint8_t* crow = codes + (xok ? j0 + lr : 0) * D;

  // compute role: rows {ty*4 + i, 64 + ty*4 + i}, columns likewise with tx
  const int tx = tid & 15;
  const int ty = tid >> 4;

  float ra[kPerThread];
  uint2 rc;
  float qc = 0.f, xs = 0.f;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] = 0.f;
    }
  }

  load_q<kVec>(qrow, qok, lc, D, ra);
  rc = load_codes<kVec>(crow, xok, lc, D);
  for (int k0 = 0; k0 < D; k0 += kStep) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int d = k0 + lc + e;
      const bool in = d < D;
      const float s = in ? __ldg(scale + d) : 0.f;
      const float sh = in ? __ldg(dmin + d) + 128.f * s : 0.f;
      const float qv = ra[e];
      const uint32_t word = e < 4 ? rc.x : rc.y;
      const float cf =
          in ? static_cast<float>(static_cast<int>((word >> (8 * (e & 3))) &
                                                   0xFFu) - 128)
             : 0.f;
      as[lc + e][lr] = __bfloat162float(__float2bfloat16_rn(qv * s));
      bs[lc + e][lr] = cf;
      qc += qv * qv - 2.f * qv * sh;
      const float xh = cf * s + sh;
      xs = fmaf(xh, xh, xs);
    }
    __syncthreads();
    if (k0 + kStep < D) {
      load_q<kVec>(qrow, qok, k0 + kStep + lc, D, ra);
      rc = load_codes<kVec>(crow, xok, k0 + kStep + lc, D);
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
  qc += __shfl_xor_sync(0xffffffffu, qc, 1);
  xs += __shfl_xor_sync(0xffffffffu, xs, 1);
  if ((tid & 1) == 0) {
    qc_s[lr] = qc;
    xs_s[lr] = xs;
  }
  __syncthreads();

  float xsc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    xsc[j] = xs_s[(j < 4 ? 0 : 64) + tx * 4 + (j & 3)];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    const long long row = i0 + r;
    if (row >= Q) {
      continue;
    }
    const float qci = qc_s[r];
    float* orow = out + row * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long col = j0 + h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = fmaxf(qci - 2.f * acc[i][4 * h + j] + xsc[4 * h + j], 0.f);
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

extern "C" int alaya_sq8_tile(const void* q, const void* codes,
                              const void* dmin, const void* scale, void* out,
                              long long Q, long long N, long long D,
                              int vec_in, void* stream) {
  if (Q == 0 || N == 0) {
    return 0;
  }
  const dim3 grid(static_cast<unsigned>((N + kTile - 1) / kTile),
                  static_cast<unsigned>((Q + kTile - 1) / kTile));
  const int vec_out =
      (N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) ? 1 : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const uint8_t* cb = static_cast<const uint8_t*>(codes);
  const float* mf = static_cast<const float*>(dmin);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  if (vec_in) {
    sq8_tile_kernel<true><<<grid, kThreads, 0, s>>>(
        qf, cb, mf, sf, of, Q, N, static_cast<int>(D), vec_out);
  } else {
    sq8_tile_kernel<false><<<grid, kThreads, 0, s>>>(
        qf, cb, mf, sf, of, Q, N, static_cast<int>(D), vec_out);
  }
  return static_cast<int>(cudaGetLastError());
}
