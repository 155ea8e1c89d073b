// unique_topk: the block search's final selection, written for Hopper
// (sm_90a).
//
//   d f32 [B, W], ids i32 [B, W], valid u8 [C] (optional), k <= W
//   -> out_d f32 [B, k], out_i i32 [B, k]
//
// An entry of a row is out where its id is < 0, where valid[min(id, C - 1)]
// is 0, or where an equal id stands in a lower column of the row. The k
// least of the rest come out ascending by (d, column); an entry that is out
// reads +inf and sorts among the +inf entries by its column. -0.0 equals
// +0.0 and every NaN sorts after +inf, as in a stable torch.sort; a value
// comes out with the bits it went in with. out_i is -1 wherever out_d is
// not finite.
//
// It replaces no Pallas kernel: the JAX package leaves the same duplicate
// net and top k to XLA (alayalite_tpu/index/search.py:407-420, the end of
// _block_beam_search). In the port they were three passes over a
// [B, W, W] bool tensor (==, & the lower triangle, any), a mask, a sort of
// the row and gathers: at the 1-bit search's (4096, 522) a third of its
// device time.
//
// Bound: memory, by the bytes that must move: d and ids read once, the
// valid byte of each live id, the k outputs written; at (4096, 522, 10)
// ~18 MB, ~5.5 us at 3.35 TB/s. No [W, W] compare is made, and a copy is
// looked for only where it could matter, among the entries the selection
// reaches:
//   - one warp a row, several rows a block; the row's ids and its keys sit
//     in the warp's shared memory (8 bytes a column);
//   - the row goes in 32 columns a lane, 8 batches of loads in flight: each
//     lane reads its column's id and d, and a live id its valid byte; the
//     key is d's bits as an ordered unsigned integer, +inf where the entry
//     is out; each lane keeps the least (key, column) of its own columns in
//     registers;
//   - each round takes the warp's least key (__reduce_min_sync), then the
//     least column holding it (a second reduction). A winner keyed below
//     +inf is a first copy unless its id stands in a lower column: the warp
//     compares the lower columns, c / 32 ids a lane, and a later copy is
//     keyed +inf in its place and the round taken again. A copy keyed NaN
//     would sort after the +inf entries it must join, so NaN entries are
//     settled before the rounds (only where a row has one). Only the lane
//     that owns the winner's column scans its own keys again (ceil(W / 32)
//     of them);
//   - k rounds plus one for each later copy the selection reaches (the
//     1-bit search's result pool holds copies of pool entries); the
//     winners' columns go to shared memory and the warp writes the outputs,
//     k words a row, coalesced.
// A hash table of the row's ids (ring_probe.cu's), tried first, settles
// every copy up front but costs a shared-memory atomic a column: 0.078 ms
// against 0.041 at (4096, 522, 10) on the H100 at 700 W. One route for
// every (W, k) the paths use, k = 10 of 522 as k = W = ef.
//
// Plain C entry point for ctypes; returns cudaGetLastError() after launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 4;               // rows a block, one warp each
constexpr int kBatches = 8;                // 32-column batches in flight
constexpr uint32_t kKeyInf = 0xFF800000u;  // +inf, and every entry that is out
constexpr uint32_t kKeyNaN = 0xFFFFFFFEu;  // any NaN: after +inf
constexpr uint32_t kKeyGone = 0xFFFFFFFFu; // taken, or past the row's end
constexpr int kInfBit = 1 << 30;           // a winner keyed +inf
constexpr int kSmemLimit = 227 * 1024;

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

__global__ void __launch_bounds__(kMaxWarps * 32)
unique_topk_kernel(const float* __restrict__ d, const int* __restrict__ ids,
                   const uint8_t* __restrict__ valid, long long C,
                   float* __restrict__ out_d, int* __restrict__ out_i,
                   long long B, int W, int k) {
  extern __shared__ __align__(16) int smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * warps + warp;
  if (b >= B) {
    return;  // the whole warp: no warp-wide call below waits on it
  }
  const int Wp = (W + 31) & ~31;
  int* row = smem + static_cast<size_t>(warp) * (2 * Wp + k);
  uint32_t* keys = reinterpret_cast<uint32_t*>(row + Wp);
  int* won = row + 2 * Wp;
  const float* dr = d + b * W;
  const int* ir = ids + b * W;

  uint32_t best = kKeyGone;  // the least (key, column) of this lane's columns
  int best_col = lane;
  bool has_nan = false;
  for (int base = 0; base < Wp; base += 32 * kBatches) {
    int id[kBatches];
    float x[kBatches];
#pragma unroll
    for (int t = 0; t < kBatches; ++t) {
      const int col = base + t * 32 + lane;
      id[t] = col < W ? __ldg(ir + col) : -1;
      x[t] = col < W ? __ldg(dr + col) : 0.0f;
    }
    bool live[kBatches];
#pragma unroll
    for (int t = 0; t < kBatches; ++t) {
      live[t] = id[t] >= 0;
      if (live[t] && valid != nullptr) {
        const long long v = id[t] < C ? id[t] : C - 1;
        live[t] = __ldg(valid + v) != 0;
      }
    }
#pragma unroll
    for (int t = 0; t < kBatches; ++t) {
      const int col = base + t * 32 + lane;
      if (col < Wp) {
        const uint32_t key = col >= W ? kKeyGone
                                      : (live[t] ? order_key(x[t]) : kKeyInf);
        row[col] = id[t];
        keys[col] = key;
        has_nan |= key == kKeyNaN;
        if (key < best) {
          best = key;
          best_col = col;
        }
      }
    }
  }
  __syncwarp();
  // a NaN sorts after +inf, so a later copy keyed NaN must read +inf before
  // the rounds reach the +inf entries: settle those copies now
  if (__any_sync(0xffffffffu, has_nan)) {
    for (int col = lane; col < W; col += 32) {
      if (keys[col] == kKeyNaN) {
        const int id = row[col];
        for (int j = 0; j < col; ++j) {
          if (row[j] == id) {
            keys[col] = kKeyInf;
            if (kKeyInf < best || (kKeyInf == best && col < best_col)) {
              best = kKeyInf;
              best_col = col;
            }
            break;
          }
        }
      }
    }
  }

  for (int r = 0; r < k;) {
    const uint32_t m = __reduce_min_sync(0xffffffffu, best);
    const int c = static_cast<int>(__reduce_min_sync(
        0xffffffffu, best == m ? static_cast<uint32_t>(best_col) : kKeyGone));
    bool first = true;
    if (m < kKeyInf) {  // a live entry: is its id in a lower column?
      const int id = row[c];
      bool seen = false;
#pragma unroll 4
      for (int j = lane; j < c; j += 32) {
        seen |= row[j] == id;
      }
      first = !__any_sync(0xffffffffu, seen);
    }
    if (first) {
      if (lane == 0) {
        won[r] = c | (m == kKeyInf ? kInfBit : 0);
      }
      ++r;
    }
    if (lane == (c & 31)) {
      keys[c] = first ? kKeyGone : kKeyInf;  // a later copy reads +inf
      best = kKeyGone;
      best_col = lane;
#pragma unroll 4
      for (int j = lane; j < Wp; j += 32) {
        const uint32_t v = keys[j];
        if (v < best) {
          best = v;
          best_col = j;
        }
      }
    }
  }
  __syncwarp();

  float* od = out_d + b * k;
  int* oi = out_i + b * k;
  for (int r = lane; r < k; r += 32) {
    const int w = won[r];
    const int c = w & (kInfBit - 1);
    const float v = (w & kInfBit) ? __int_as_float(0x7f800000)
                                  : __ldg(dr + c);
    od[r] = v;
    oi[r] = isfinite(v) ? row[c] : -1;
  }
}

}  // namespace

// valid may be null (no mask, C ignored); k <= W <= 16384 (the widest row
// whose ids, keys and winners fit one block's shared memory).
extern "C" int alaya_unique_topk(const void* d, const void* ids,
                                 const void* valid, long long C, void* out_d,
                                 void* out_i, long long B, int W, int k,
                                 void* stream) {
  if (B == 0 || k == 0) {
    return 0;
  }
  if (k > W || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long row = (2LL * ((W + 31) & ~31) + k) * 4;
  if (row > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int warps = kMaxWarps;
  while (warps > 1 && warps * row > kSmemLimit) {
    --warps;
  }
  const size_t smem = static_cast<size_t>(warps * row);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        unique_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const unsigned grid = static_cast<unsigned>((B + warps - 1) / warps);
  unique_topk_kernel<<<grid, warps * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const int*>(ids),
      static_cast<const uint8_t*>(valid), C, static_cast<float*>(out_d),
      static_cast<int*>(out_i), B, W, k);
  return static_cast<int>(cudaGetLastError());
}
