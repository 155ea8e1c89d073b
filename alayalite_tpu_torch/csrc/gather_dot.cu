// gather_dot: exact f32 distances from each query to stored rows named by
// id, with the row gather inside the kernel, written for Hopper (sm_90a).
//
//   dot[b, k] = sum_d data[clamp(ids[b, k], 0, C - 1), d] * q[b, d]
//   data f32 [C, D], ids i32 | i64 [B, K], q f32 [B, D] -> out f32 [B, K]
//   L2 (q_sq f32 [B] and x_sq f32 [C] given):
//     out = max((q_sq[b] + x_sq[id]) - 2 * dot, 0)
//   IP (neither given): out = dot
//
// The L2 epilogue runs in that f32 order (__fadd_rn, __fmul_rn, __fsub_rn:
// no FMA), as the spaces' PyTorch epilogue does; a NaN stays NaN, as
// torch.clamp leaves it.
//
// It replaces no TPU kernel: the JAX package leaves the gather and the
// product of the exact re-scoring (`gather_dists` of spaces/raw.py,
// spaces/bqg.py, spaces/rabitq.py) to XLA. In the port the same work was
// three PyTorch kernels over a gathered copy: index_select wrote a
// [B*K, D] f32 copy of the rows, ops.distance.row_dots multiplied it by the
// query in place and summed it, so each row's bytes crossed device memory
// about five times, and each 4,096-query slice of the 1-bit search's final
// re-score allocated a 1.07 GB copy.
//
// Bound: memory. Each row byte is used in one multiply-add (2 flops a
// 4-byte word). At the 1-bit search's final re-score (B 4096, K 512, D 128
// over 1M rows) the rows are 1.07 GB if every (query, row) pair came from
// device memory, ~0.32 ms at 3.35 TB/s; rows that several queries of a
// slice share may come from L2, so the time can undercut that.
//
// Design. The unit of work is a row. G lanes (a power of two, the largest
// <= min(ceil(D / 4), 32)) share a row; lane gl always takes the 16-byte
// column slices gl, gl + G, gl + 2G, ... A group owns kU consecutive rows
// of one query (kU * slices a lane = kInFlight 16-byte loads a thread): it
// loads their ids, starts every row load (ld.global.nc of float4), loads
// its slices of q[b], then multiplies and adds. No shared memory, no
// barrier, no intermediate tensor. D past 1024 takes several passes of 8
// slices a lane, q read again each pass.
//
// The order of the sums depends on D alone. Each lane keeps one f32
// accumulator a word of a slice and adds its slices' products in turn
// (products and sums rounded apart: __fmul_rn, __fadd_rn, no FMA), then
// adds its four accumulators in word order, then a shuffle butterfly over
// the G lanes, the widest offset first, leaves the same bits in every
// lane. That is the order of PyTorch's CUDA sum over a contiguous last
// axis of D = 128 words (32 lanes a 16-byte slice each, four accumulators,
// the shuffle tree from offset 16 down), so at D = 128 the kernel gives
// the bits of the chain it replaced, and a fit or a search reads what it
// read before (bits checked against the plain version on the card). One
// (query, row) pair gets the same bits whatever B, K, its position in the
// batch, the ids' type, or whether the 16-byte loads were taken: the 1-bit
// search gathers a popped node's distance in the hop and again in the
// final re-score, and keeps the first copy of an id.
// Where D % 4 != 0 or a base is not 16-byte aligned, the same slices are
// read a word at a time.
//
// Plain C entry point for ctypes; it returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 8;   // 16-byte row loads a thread starts first
constexpr int kMaxLanesLog = 5;

template <typename Id>
__device__ __forceinline__ long long clamp_id(Id id, long long C) {
  const long long n = static_cast<long long>(id);
  return n < 0 ? 0 : (n >= C ? C - 1 : n);
}

// the 4 words of slice `chunk` at p: one 16-byte load, or word by word
// (the words past D read 0 and are never added)
template <bool kVec>
__device__ __forceinline__ float4 load_slice(const float* __restrict__ p,
                                             int chunk, int D) {
  if (kVec) {
    return __ldg(reinterpret_cast<const float4*>(p) + chunk);
  }
  const int d = chunk * 4;
  float4 v;
  v.x = __ldg(p + d);
  v.y = d + 1 < D ? __ldg(p + d + 1) : 0.f;
  v.z = d + 2 < D ? __ldg(p + d + 2) : 0.f;
  v.w = d + 3 < D ? __ldg(p + d + 3) : 0.f;
  return v;
}

// the products of one slice added to their words' accumulators
__device__ __forceinline__ void add4(float4 x, float4 q, int words,
                                     float4* acc) {
  acc->x = __fadd_rn(acc->x, __fmul_rn(x.x, q.x));
  if (words > 1) acc->y = __fadd_rn(acc->y, __fmul_rn(x.y, q.y));
  if (words > 2) acc->z = __fadd_rn(acc->z, __fmul_rn(x.z, q.z));
  if (words > 3) acc->w = __fadd_rn(acc->w, __fmul_rn(x.w, q.w));
}

// one slice's products summed in word order, from +0: where a lane takes
// one slice (D <= 128), the bits of its four accumulators summed in word
// order (no partial sum from +0 is -0), in fewer registers
__device__ __forceinline__ float sum4(float4 x, float4 q, int words) {
  float s = __fadd_rn(0.f, __fmul_rn(x.x, q.x));
  if (words > 1) s = __fadd_rn(s, __fmul_rn(x.y, q.y));
  if (words > 2) s = __fadd_rn(s, __fmul_rn(x.z, q.z));
  if (words > 3) s = __fadd_rn(s, __fmul_rn(x.w, q.w));
  return s;
}

// grid: groups of G lanes, `slots` groups a query, each owning kU rows
template <int kC, bool kVec, typename Id>
__global__ void __launch_bounds__(kThreads)
gather_dot_kernel(const float* __restrict__ data, const Id* __restrict__ ids,
                  const float* __restrict__ q,
                  const float* __restrict__ q_sq,
                  const float* __restrict__ x_sq, float* __restrict__ out,
                  long long C, long long B, int K, int D, int lg_g,
                  int slots) {
  constexpr int kU = kInFlight / kC;
  const int G = 1 << lg_g;
  const int gl = threadIdx.x & (G - 1);
  const long long grp =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> lg_g) +
      (threadIdx.x >> lg_g);
  const long long b = grp / slots;
  const int k0 = static_cast<int>(grp - b * slots) * kU;
  const bool live = b < B;   // a group past the end still joins the shuffles
  const int nchunks = (D + 3) >> 2;
  const int per_lane = (nchunks + G - 1) >> lg_g;
  const long long base = b * K + k0;
  // ids, then the rows' 64-bit addresses; the storing lane's x_sq
  const float* row[kU];
  unsigned valid = 0;
  float xs[kU];
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    row[k] = data;
    xs[k] = 0.f;
    if (live && k0 + k < K) {
      const long long node = clamp_id(__ldg(ids + base + k), C);
      row[k] = data + node * D;
      valid |= 1u << k;
      if (x_sq != nullptr && (k & (G - 1)) == gl) {
        xs[k] = __ldg(x_sq + node);
      }
    }
  }
  const float* qb = q + (live ? b : 0) * D;
  float4 acc4[kU];
  float acc1[kU];
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    acc4[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc1[k] = 0.f;
  }
  for (int p0 = 0; p0 < per_lane; p0 += kC) {
    // every row load of the pass first, then q, then the products
    float4 v[kU][kC];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int chunk = gl + (p0 + c) * G;
        v[k][c] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (((valid >> k) & 1u) && chunk < nchunks) {
          v[k][c] = load_slice<kVec>(row[k], chunk, D);
        }
      }
    }
    float4 qv[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int chunk = gl + (p0 + c) * G;
      qv[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && chunk < nchunks) {
        qv[c] = load_slice<kVec>(qb, chunk, D);
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int chunk = gl + (p0 + c) * G;
      if (chunk < nchunks) {
        const int words = kVec ? 4 : D - chunk * 4;
#pragma unroll
        for (int k = 0; k < kU; ++k) {
          if ((valid >> k) & 1u) {
            if constexpr (kC == 1) {
              acc1[k] = sum4(v[k][c], qv[c], words);
            } else {
              add4(v[k][c], qv[c], words, &acc4[k]);
            }
          }
        }
      }
    }
  }
  float acc[kU];
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    if constexpr (kC == 1) {
      acc[k] = acc1[k];
    } else {
      acc[k] = __fadd_rn(__fadd_rn(__fadd_rn(acc4[k].x, acc4[k].y),
                                   acc4[k].z), acc4[k].w);
    }
  }
  for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], off));
    }
  }
  const float qs = (live && q_sq != nullptr) ? __ldg(q_sq + b) : 0.f;
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    if ((k & (G - 1)) == gl && ((valid >> k) & 1u)) {
      float e = acc[k];
      if (x_sq != nullptr) {
        e = __fsub_rn(__fadd_rn(qs, xs[k]), __fmul_rn(2.f, acc[k]));
        if (e < 0.f) {
          e = 0.f;
        }
      }
      out[base + k] = e;
    }
  }
}

// lanes a row (log2) and 16-byte slices a lane a pass, from D alone
void plan(long long D, int* lg_g, int* kc) {
  const long long chunks = (D + 3) / 4;
  int lg = 0;
  while (lg < kMaxLanesLog && (2LL << lg) <= chunks) {
    ++lg;
  }
  const long long per_lane = (chunks + (1LL << lg) - 1) >> lg;
  *lg_g = lg;
  *kc = per_lane <= 1 ? 1 : per_lane <= 2 ? 2 : per_lane <= 4 ? 4 : 8;
}

template <int kC, bool kVec, typename Id>
int launch(const float* data, const void* ids, const float* q,
           const float* q_sq, const float* x_sq, float* out, long long C,
           long long B, long long K, long long D, int lg_g,
           cudaStream_t stream) {
  constexpr int kU = kInFlight / kC;
  const long long slots = (K + kU - 1) / kU;
  const long long groups = B * slots;
  long long threads = ((groups << lg_g) + 31) / 32 * 32;
  threads = threads > kThreads ? kThreads : threads;
  const long long per_cta = threads >> lg_g;
  const long long grid = (groups + per_cta - 1) / per_cta;
  if (grid > 0x7fffffffLL || slots > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  gather_dot_kernel<kC, kVec, Id>
      <<<static_cast<unsigned>(grid), static_cast<unsigned>(threads), 0,
         stream>>>(data, static_cast<const Id*>(ids), q, q_sq, x_sq, out, C,
                   B, static_cast<int>(K), static_cast<int>(D), lg_g,
                   static_cast<int>(slots));
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec, typename Id>
int dispatch(const float* data, const void* ids, const float* q,
             const float* q_sq, const float* x_sq, float* out, long long C,
             long long B, long long K, long long D, cudaStream_t stream) {
  int lg_g = 0, kc = 0;
  plan(D, &lg_g, &kc);
#define ALAYA_GATHER_DOT_CASE(N)                                            \
  case N:                                                                   \
    return launch<N, kVec, Id>(data, ids, q, q_sq, x_sq, out, C, B, K, D,   \
                               lg_g, stream);
  switch (kc) {
    ALAYA_GATHER_DOT_CASE(1)
    ALAYA_GATHER_DOT_CASE(2)
    ALAYA_GATHER_DOT_CASE(4)
    ALAYA_GATHER_DOT_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ALAYA_GATHER_DOT_CASE
}

}  // namespace

// out [B, K]: the dots, or (q_sq and x_sq given) the clamped L2 distances;
// ids64: ids are int64, else int32; vec: D % 4 == 0 and 16-byte aligned
// data and q
extern "C" int alaya_gather_dot(const void* data, const void* ids, int ids64,
                                const void* q, const void* q_sq,
                                const void* x_sq, void* out, long long C,
                                long long B, long long K, long long D, int vec,
                                void* stream) {
  if (B == 0 || K == 0) {
    return 0;
  }
  if (C <= 0 || D < 0 || K > 0x7fffffffLL || D > 0x7fffffffLL ||
      (q_sq == nullptr) != (x_sq == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* d = static_cast<const float*>(data);
  const float* qf = static_cast<const float*>(q);
  const float* qs = static_cast<const float*>(q_sq);
  const float* xs = static_cast<const float*>(x_sq);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    return ids64 ? dispatch<true, long long>(d, ids, qf, qs, xs, o, C, B, K,
                                             D, st)
                 : dispatch<true, int>(d, ids, qf, qs, xs, o, C, B, K, D, st);
  }
  return ids64 ? dispatch<false, long long>(d, ids, qf, qs, xs, o, C, B, K, D,
                                            st)
               : dispatch<false, int>(d, ids, qf, qs, xs, o, C, B, K, D, st);
}
