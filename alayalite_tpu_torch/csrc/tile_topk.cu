// tile_topk: the flat scan's per-tile selection, merged into the running
// best, written for Hopper (sm_90a).
//
//   d f32 [Q, n] (row-major), best_d f32 [Q, k] ascending, best_i i32 [Q, k]
//   -> best_d, best_i (in place): the k smallest of
//      best ∪ {(d[q, j], lo + j)}, ascending by (distance, then an entry of
//      the running best before one of the tile, then the lower column)
//
// -0.0 equals +0.0 and every NaN sorts after +inf, as in a stable
// torch.sort; a value comes out with the bits it went in with. best_i is -1
// wherever best_d is not finite.
//
// It replaces no Pallas kernel: the JAX package leaves the per-tile top k
// and the merge with the running best to XLA (lax.top_k twice in the body
// of alayalite_tpu/ops/distance.py _exact_topk_device). In the port they
// were torch.topk's multi-block radix select over the tile (several passes
// a row), two sorts and two gathers of its unordered result, and a merge
// with the running best: about a dozen launches a tile, 62% of the exact flat scan's device time.
//
// Bound: memory. The tile is read once (at the flat scan's [4096, 16384]
// 268 MB, 0.080 ms at 3.35 TB/s); the running best is k words a row. The
// design reads each element once and, for almost all of them, does one
// compare:
//   - one warp a row, four rows a block, no shared memory (a row of the
//     tile would cap residency at three rows an SM);
//   - lanes stream the row with coalesced 16-byte loads (4-byte loads where
//     n % 4 != 0), U of them a lane in flight;
//   - the running best lives in the warp's registers, entry e in lane
//     e % 32, slot e / 32 (S = ceil(k / 32) slots), sorted by (key, tag):
//     key the distance's bits as an ordered unsigned integer, tag 0 for an
//     entry of the running best and column + 1 for a tile entry;
//   - the threshold is the k-th entry's distance. An element greater than
//     it can never enter, so it costs one compare; an element equal to it
//     may (a lower column of the same tile wins a tie), so equals go on to
//     the exact (key, tag) test. Since the threshold starts at the running
//     best's k-th distance, from the second tile on almost every step of
//     the warp ends after one vote;
//   - where any lane holds a survivor, the warp takes them one at a time:
//     the exact test, then an insertion (a ballot for the place, a shift up
//     by shuffles), after which the threshold tightens and each lane drops
//     its own survivors above it.
// Lanes meet a row's columns out of order; the (key, tag) order makes the
// result independent of that order, so it equals a stable sort's.
//
// Plain C entry point for ctypes; returns cudaGetLastError() after launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                  // rows a block, one warp each
constexpr int kMaxK = 256;                 // ops/tile_topk.py MAX_K
constexpr uint32_t kKeyNaN = 0xFFFFFFFEu;  // any NaN: after +inf
constexpr uint32_t kKeyGone = 0xFFFFFFFFu; // slots past k
constexpr float kInf = __builtin_huge_valf();  // past the row's end

__device__ __forceinline__ uint32_t order_key(float x) {
  if (x != x) {
    return kKeyNaN;
  }
  if (x == 0.0f) {
    return 0x80000000u;  // -0.0 as +0.0
  }
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The running best, entry e = s * 32 + lane in slot s of that lane.
template <int S>
struct Best {
  uint32_t key[S];
  uint32_t tag[S];
  float val[S];
  int id[S];
};

// Entry k - 1's key, tag and value, in every lane.
template <int S>
__device__ __forceinline__ void kth(const Best<S>& b, int k, uint32_t& tk,
                                    uint32_t& tt, float& tv) {
  const int ts = (k - 1) >> 5;
  uint32_t key = b.key[0], tag = b.tag[0];
  float val = b.val[0];
#pragma unroll
  for (int s = 1; s < S; ++s) {
    if (s == ts) {
      key = b.key[s];
      tag = b.tag[s];
      val = b.val[s];
    }
  }
  const int tl = (k - 1) & 31;
  tk = __shfl_sync(kFull, key, tl);
  tt = __shfl_sync(kFull, tag, tl);
  tv = __shfl_sync(kFull, val, tl);
}

// Insert (ck, ct) at its place; the entries after it move up one, and the
// last one (past k, or a slot past k) drops.
template <int S>
__device__ __forceinline__ void insert(Best<S>& b, uint32_t ck, uint32_t ct,
                                       float cv, int cid, int lane) {
  int pos = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    pos += __popc(__ballot_sync(
        kFull, b.key[s] < ck || (b.key[s] == ck && b.tag[s] < ct)));
  }
#pragma unroll
  for (int s = S - 1; s >= 0; --s) {
    uint32_t uk = __shfl_up_sync(kFull, b.key[s], 1);
    uint32_t ut = __shfl_up_sync(kFull, b.tag[s], 1);
    float uv = __shfl_up_sync(kFull, b.val[s], 1);
    int ui = __shfl_up_sync(kFull, b.id[s], 1);
    if (s > 0) {  // lane 0 takes the previous slot's last entry
      const uint32_t pk = __shfl_sync(kFull, b.key[s - 1], 31);
      const uint32_t pt = __shfl_sync(kFull, b.tag[s - 1], 31);
      const float pv = __shfl_sync(kFull, b.val[s - 1], 31);
      const int pi = __shfl_sync(kFull, b.id[s - 1], 31);
      if (lane == 0) {
        uk = pk;
        ut = pt;
        uv = pv;
        ui = pi;
      }
    }
    const int e = s * 32 + lane;
    if (e == pos) {
      b.key[s] = ck;
      b.tag[s] = ct;
      b.val[s] = cv;
      b.id[s] = cid;
    } else if (e > pos) {
      b.key[s] = uk;
      b.tag[s] = ut;
      b.val[s] = uv;
      b.id[s] = ui;
    }
  }
}

// The column of a lane's element e (of 4 * U) in the step at column base.
template <bool kVec>
__device__ __forceinline__ int column(int base, int e, int lane) {
  return kVec ? base + ((e >> 2) * 32 + lane) * 4 + (e & 3)
              : base + e * 32 + lane;
}

template <int S, int U, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
tile_topk_kernel(const float* __restrict__ d, long long Q, int n, int lo,
                 float* __restrict__ best_d, int* __restrict__ best_i,
                 int k) {
  constexpr int kPer = 4 * U;       // elements a lane holds a step
  constexpr int kStep = 32 * kPer;  // columns a step
  const int lane = threadIdx.x & 31;
  const long long q =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (q >= Q) {
    return;  // the whole warp: no warp-wide call below waits on it
  }
  const float* row = d + q * n;
  float* bd = best_d + q * k;
  int* bi = best_i + q * k;

  Best<S> b;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = s * 32 + lane;
    if (e < k) {
      b.val[s] = bd[e];
      b.id[s] = bi[e];
      b.key[s] = order_key(b.val[s]);
      b.tag[s] = 0;
    } else {
      b.val[s] = 0.0f;
      b.id[s] = -1;
      b.key[s] = kKeyGone;
      b.tag[s] = kKeyGone;
    }
  }
  uint32_t tk, tt;
  float tv;
  kth(b, k, tk, tt, tv);

  for (int base = 0; base < n; base += kStep) {
    float x[kPer];
    if (kVec) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = base + (u * 32 + lane) * 4;
        float4 v = make_float4(kInf, kInf, kInf, kInf);
        if (c < n) {  // n % 4 == 0: the whole vector is in the row
          v = __ldg(reinterpret_cast<const float4*>(row + c));
        }
        x[4 * u] = v.x;
        x[4 * u + 1] = v.y;
        x[4 * u + 2] = v.z;
        x[4 * u + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int c = base + e * 32 + lane;
        x[e] = c < n ? __ldg(row + c) : kInf;
      }
    }
    // !(x > tv): every element that could enter (equals, NaN where the
    // threshold is NaN), and NaN elements, which the exact test drops
    bool any = false;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      any |= !(x[e] > tv);
    }
    if (!__any_sync(kFull, any)) {
      continue;
    }
    uint32_t mask = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (!(x[e] > tv) && column<kVec>(base, e, lane) < n) {
        mask |= 1u << e;
      }
    }
    for (;;) {
      const uint32_t has = __ballot_sync(kFull, mask != 0);
      if (has == 0) {
        break;
      }
      const int src = __ffs(has) - 1;
      const int j = __ffs(__shfl_sync(kFull, mask, src)) - 1;
      float mine = x[0];
#pragma unroll
      for (int e = 1; e < kPer; ++e) {
        if (e == j) {
          mine = x[e];
        }
      }
      const float cv = __shfl_sync(kFull, mine, src);
      if (lane == src) {
        mask &= mask - 1;
      }
      const int c = column<kVec>(base, j, src);
      const uint32_t ck = order_key(cv);
      const uint32_t ct = static_cast<uint32_t>(c) + 1;
      if (ck < tk || (ck == tk && ct < tt)) {
        insert(b, ck, ct, cv, lo + c, lane);
        kth(b, k, tk, tt, tv);
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          if (x[e] > tv) {
            mask &= ~(1u << e);
          }
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = s * 32 + lane;
    if (e < k) {
      bd[e] = b.val[s];
      bi[e] = isfinite(b.val[s]) ? b.id[s] : -1;
    }
  }
}

template <int S, int U>
cudaError_t launch(const float* d, long long Q, int n, int lo, float* best_d,
                   int* best_i, int k, bool vec, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((Q + kWarps - 1) / kWarps);
  if (vec) {
    tile_topk_kernel<S, U, true><<<grid, kWarps * 32, 0, stream>>>(
        d, Q, n, lo, best_d, best_i, k);
  } else {
    tile_topk_kernel<S, U, false><<<grid, kWarps * 32, 0, stream>>>(
        d, Q, n, lo, best_d, best_i, k);
  }
  return cudaGetLastError();
}

}  // namespace

// 1 <= k <= 256; lo + n - 1 must fit an int32 id. Updates best_d and best_i
// in place.
extern "C" int alaya_tile_topk(const void* d, long long Q, int n, int lo,
                               void* best_d, void* best_i, int k,
                               void* stream) {
  if (k < 1 || k > kMaxK || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Q == 0) {
    return 0;
  }
  const float* dp = static_cast<const float*>(d);
  float* bd = static_cast<float*>(best_d);
  int* bi = static_cast<int*>(best_i);
  const bool vec =
      n % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= 32) {
    err = launch<1, 8>(dp, Q, n, lo, bd, bi, k, vec, s);
  } else if (k <= 64) {
    err = launch<2, 8>(dp, Q, n, lo, bd, bi, k, vec, s);
  } else if (k <= 128) {
    err = launch<4, 4>(dp, Q, n, lo, bd, bi, k, vec, s);
  } else {
    err = launch<8, 4>(dp, Q, n, lo, bd, bi, k, vec, s);
  }
  return static_cast<int>(err);
}
