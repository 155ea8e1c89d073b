// ring_probe: row-wise membership test of the block hop's stale check,
// written for Hopper (sm_90a).
//
//   out[b, k] = nids[b, k] is among seen[b, :] or among seen2[b, :]
//   nids i32 [B, K], seen i32 [B, S], seen2 i32 [B, S2] (optional, S2 = 0)
//   -> out u8 [B, K] (0 or 1)
//
// Replaces the TPU kernel scripts/proto_pallas_sort2.py:105
// (ring_probe_kernel). That kernel holds the ids as [K, BT] and the ring as
// [RING, BT] so the query index rides the TPU's lanes; the layout is not
// part of the function, and here both operands are row-major per query.
// The second seen operand lets the hop pass its pop ring and its pool as
// they are, where it would otherwise concatenate them before every call.
// -1 equals -1, as in the broadcast compare this replaces; the callers mask
// nids >= 0 afterwards. Every int32 is an id: INT_MIN and INT_MAX too.
//
// Bound: memory, by the bytes that must move (nids and both seen rows read
// once, one byte written per id): at the search's shape (B 4096, K 256,
// S + S2 = 96 + 64) that is 7.9 MB, ~2.4 us at 3.35 TB/s. Two kernels, one
// function; the wrapper picks by the seen width (ops/ring_probe.py):
//
// "hash" (S + S2 <= 2048, every path shape): one warp per query, several
// queries a block. The warp's table of T = pow2(2 (S + S2)) slots (at
// least 128) sits in shared memory: 2 KB at the search's 160 seen ids.
//   - the first 256 of the row's ids are loaded before the table is built,
//     so their latency hides behind the build;
//   - build: the warp clears its table and inserts the seen ids of both
//     rows, up to 8 a lane per batch of loads, by atomicCAS with linear
//     probing from a multiplicative hash; a slot that already holds the id
//     ends the insert; the load stays at most one half, so a probe ends
//     after ~1.5 slots on average;
//   - the empty slot is INT_MIN; a seen INT_MIN is not inserted but sets a
//     flag of the warp, which is the answer for an id INT_MIN; so does -1,
//     the pad of the pop ring and of the pool (96 copies in a fresh ring),
//     whose inserts would otherwise all queue on one slot's atomics;
//   - probe: a lane looks up 4 consecutive ids (one int4 load where the
//     row is 16-byte aligned and K % 4 == 0) and stores their 4 answers as
//     one 32-bit word.
//   That is O(K + S) work a query, where the scan's is O(K S).
//
// "scan" (any width up to the shared memory a block has): one block per
// (query, tile of 256 ids); both seen rows are staged once per block in
// shared memory (int4 loads where a row is 16-byte aligned), padded to a
// multiple of 4 with the union's first entry, which cannot change the
// answer; each thread compares its one id against every staged entry, all
// threads of a warp reading the same word (a broadcast).
//
// Plain C entry points for ctypes; each returns cudaGetLastError() after
// launch.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ scan
constexpr int kThreads = 256;

__device__ __forceinline__ void stage_row(int* dst, const int* __restrict__ row,
                                          int n, int vec) {
  if (vec) {  // n % 4 == 0, a 16-byte aligned source and destination
    const int4* row4 = reinterpret_cast<const int4*>(row);
    int4* dst4 = reinterpret_cast<int4*>(dst);
    for (int j = threadIdx.x; j < n / 4; j += kThreads) {
      dst4[j] = __ldg(row4 + j);
    }
  } else {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      dst[j] = __ldg(row + j);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ring_probe_kernel(const int* __restrict__ nids, const int* __restrict__ seen,
                  const int* __restrict__ seen2, uint8_t* __restrict__ out,
                  long long K, int S, int S2, int S4, int vec, int vec2) {
  extern __shared__ __align__(16) int seen_s[];
  const long long b = blockIdx.x;
  const int* row = seen + b * S;
  const int* row2 = seen2 + b * S2;
  stage_row(seen_s, row, S, vec);
  if (S2 > 0) {
    stage_row(seen_s + S, row2, S2, vec2);
  }
  // pad to a multiple of 4 with a value that is in the union already
  if (threadIdx.x < S4 - S - S2) {
    seen_s[S + S2 + threadIdx.x] = __ldg(S > 0 ? row : row2);
  }
  __syncthreads();

  const long long k = static_cast<long long>(blockIdx.y) * kThreads + threadIdx.x;
  if (k >= K) {
    return;
  }
  const int id = __ldg(nids + b * K + k);
  const int4* s4 = reinterpret_cast<const int4*>(seen_s);
  int hit = 0;
  for (int j = 0; j < S4 / 4; ++j) {
    const int4 v = s4[j];
    hit |= (v.x == id) | (v.y == id) | (v.z == id) | (v.w == id);
  }
  out[b * K + k] = static_cast<uint8_t>(hit);
}

// ------------------------------------------------------------------ hash
constexpr int kHashWarps = 8;        // queries a block (one warp each)
constexpr int kEmpty = INT_MIN;      // the empty slot
constexpr int kPad = -1;             // the pad of a pop ring or a pool
constexpr int kInsertBatch = 8;      // seen ids a lane loads per batch
constexpr int kStepIds = 128;        // ids a warp probes per step (4 a lane)

__device__ __forceinline__ uint32_t hash_slot(int id, int shift) {
  return (static_cast<uint32_t>(id) * 0x9E3779B1u) >> shift;
}

__device__ __forceinline__ void insert(int* tab, int id, uint32_t mask,
                                       int shift) {
  uint32_t s = hash_slot(id, shift);
  while (true) {
    const int old = atomicCAS(tab + s, kEmpty, id);
    if (old == kEmpty || old == id) {
      return;
    }
    s = (s + 1) & mask;
  }
}

__device__ __forceinline__ uint32_t lookup(const int* tab, int id,
                                           uint32_t mask, int shift,
                                           bool has_min, bool has_pad) {
  if (id == kEmpty) {
    return has_min;
  }
  if (id == kPad) {
    return has_pad;
  }
  uint32_t s = hash_slot(id, shift);
  while (true) {
    const int t = tab[s];
    if (t == id) {
      return 1u;
    }
    if (t == kEmpty) {
      return 0u;
    }
    s = (s + 1) & mask;
  }
}

// the 4 ids lane ``lane`` probes in step ``step``: ids step*128 + 4 lane ..
// + 3 (vec) or step*128 + 32 t + lane, t = 0 .. 3
__device__ __forceinline__ void load_step(const int* __restrict__ q, int K,
                                          int step, int lane, int vec,
                                          int (&v)[4]) {
  const int k0 = step * kStepIds;
  if (vec) {
    const int k = k0 + lane * 4;
    if (k < K) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(q + k));
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int k = k0 + t * 32 + lane;
      v[t] = k < K ? __ldg(q + k) : 0;
    }
  }
}

__device__ __forceinline__ void probe_step(const int* tab, uint8_t* o, int K,
                                           int step, int lane, int vec,
                                           const int (&v)[4], uint32_t mask,
                                           int shift, bool has_min,
                                           bool has_pad) {
  const int k0 = step * kStepIds;
  if (vec) {
    const int k = k0 + lane * 4;
    if (k < K) {
      uint32_t packed = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        packed |= lookup(tab, v[t], mask, shift, has_min, has_pad)
                  << (8 * t);
      }
      *reinterpret_cast<uint32_t*>(o + k) = packed;
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int k = k0 + t * 32 + lane;
      if (k < K) {
        o[k] = static_cast<uint8_t>(
            lookup(tab, v[t], mask, shift, has_min, has_pad));
      }
    }
  }
}

__global__ void __launch_bounds__(kHashWarps * 32)
ring_probe_hash_kernel(const int* __restrict__ nids,
                       const int* __restrict__ seen,
                       const int* __restrict__ seen2,
                       uint8_t* __restrict__ out, long long B, int K, int S,
                       int S2, int log2t, int vec) {
  extern __shared__ __align__(16) int tabs[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kHashWarps + warp;
  if (b >= B) {
    return;  // the whole warp: no warp-wide call below waits on it
  }
  const int T = 1 << log2t;
  const uint32_t mask = static_cast<uint32_t>(T - 1);
  const int shift = 32 - log2t;
  int* tab = tabs + static_cast<size_t>(warp) * T;
  const int* q = nids + b * K;
  uint8_t* o = out + b * K;
  const int steps = (K + kStepIds - 1) / kStepIds;

  // the first two steps' ids in flight while the table is built
  int v0[4] = {0, 0, 0, 0};
  int v1[4] = {0, 0, 0, 0};
  load_step(q, K, 0, lane, vec, v0);
  if (steps > 1) {
    load_step(q, K, 1, lane, vec, v1);
  }

  int4* tab4 = reinterpret_cast<int4*>(tab);
  for (int i = lane; i < T / 4; i += 32) {
    tab4[i] = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  }
  __syncwarp();

  // both rows as one sequence j in [0, S + S2)
  const int* r1 = seen + b * S;
  const int* r2 = seen2 + b * S2;
  const int n = S + S2;
  bool has_min = false;
  bool has_pad = false;
  for (int base = 0; base < n; base += 32 * kInsertBatch) {
    int v[kInsertBatch];
#pragma unroll
    for (int t = 0; t < kInsertBatch; ++t) {
      const int j = base + t * 32 + lane;
      v[t] = j < S ? __ldg(r1 + j) : (j < n ? __ldg(r2 + j - S) : 0);
    }
#pragma unroll
    for (int t = 0; t < kInsertBatch; ++t) {
      if (base + t * 32 + lane < n) {
        if (v[t] == kEmpty) {
          has_min = true;
        } else if (v[t] == kPad) {
          has_pad = true;
        } else {
          insert(tab, v[t], mask, shift);
        }
      }
    }
  }
  __syncwarp();
  has_min = __any_sync(0xffffffffu, has_min);
  has_pad = __any_sync(0xffffffffu, has_pad);

  probe_step(tab, o, K, 0, lane, vec, v0, mask, shift, has_min, has_pad);
  if (steps > 1) {
    probe_step(tab, o, K, 1, lane, vec, v1, mask, shift, has_min, has_pad);
  }
  for (int step = 2; step < steps; step += 2) {
    load_step(q, K, step, lane, vec, v0);
    if (step + 1 < steps) {
      load_step(q, K, step + 1, lane, vec, v1);
    }
    probe_step(tab, o, K, step, lane, vec, v0, mask, shift, has_min,
               has_pad);
    if (step + 1 < steps) {
      probe_step(tab, o, K, step + 1, lane, vec, v1, mask, shift, has_min,
                 has_pad);
    }
  }
}

}  // namespace

// The scan route. vec: S % 4 == 0 and a 16-byte aligned seen; vec2: the
// same of seen2, with S % 4 == 0 too (its stage starts at entry S).
extern "C" int alaya_ring_probe(const void* nids, const void* seen,
                                const void* seen2, void* out, long long B,
                                long long K, long long S, long long S2,
                                int vec, int vec2, void* stream) {
  if (B == 0 || K == 0) {
    return 0;
  }
  const int S4 = static_cast<int>((S + S2 + 3) / 4 * 4);
  const size_t smem = static_cast<size_t>(S4 > 4 ? S4 : 4) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ring_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const dim3 grid(static_cast<unsigned>(B),
                  static_cast<unsigned>((K + kThreads - 1) / kThreads));
  ring_probe_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nids), static_cast<const int*>(seen),
      static_cast<const int*>(seen2), static_cast<uint8_t*>(out), K,
      static_cast<int>(S), static_cast<int>(S2), S4, vec, vec2);
  return static_cast<int>(cudaGetLastError());
}

// The hash route; the caller picks it for S + S2 <= 2048 (a table of at
// most 4096 slots, 16 KB a warp; returns cudaErrorInvalidValue past that).
// vec: K % 4 == 0 and a 16-byte aligned nids.
extern "C" int alaya_ring_probe_hash(const void* nids, const void* seen,
                                     const void* seen2, void* out,
                                     long long B, int K, int S, int S2,
                                     int vec, void* stream) {
  if (B == 0 || K == 0) {
    return 0;
  }
  int log2t = 7;  // at least 128 slots: the clear is one int4 a lane
  while ((1 << log2t) < 2 * (S + S2)) {
    ++log2t;
  }
  if (log2t > 12) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kHashWarps) * (1u << log2t) *
                      sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ring_probe_hash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const unsigned grid = static_cast<unsigned>((B + kHashWarps - 1) /
                                              kHashWarps);
  ring_probe_hash_kernel<<<grid, kHashWarps * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nids), static_cast<const int*>(seen),
      static_cast<const int*>(seen2), static_cast<uint8_t*>(out), B, K, S,
      S2, log2t, vec);
  return static_cast<int>(cudaGetLastError());
}
