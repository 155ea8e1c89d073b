// pool_sort: the sort and merge of a beam search's candidate pool, written
// for Hopper (sm_90a). Two functions over one compare-exchange, each with a
// warp route beside the shared-memory network (roll_n, the exchange's
// calibration, is in roll_n.cu):
//
//   sort_kv     each list of f32 keys ascending, with an optional i32 payload
//               and the source positions; lists along rows [B, K] or along
//               columns [K, B] (strides); the first kout entries are written
//   pool_merge  the hop's whole merge in one launch: the concatenation
//               [B, L1] ‖ [B, L2] of (distance, id, flag) sorted ascending,
//               the first kout kept, the later of two adjacent equal
//               (distance, id, flag) entries turned into (inf, -1, true)
//
// Replaces the TPU kernels scripts/proto_pallas_sort.py:111 (sort_kernel)
// and :117 (merge_kernel) and scripts/proto_pallas_sort2.py:81, :87, :92
// (sort_sub_kernel, sort_sub_pack_kernel, sort_lane_pack_kernel: layouts of
// the same sort, with and without payload). Those hold 32 or 128 lists as
// one [BT, K] or [K, BT] tile and reach a lane's partner with two circular
// rolls per stage; neither the tile nor the roll is part of the function.
// Here a list lives in shared memory and a thread reads its partner there;
// pool_merge, the one that runs in every hop, and sort_kv along rows keep
// each list in one warp's registers instead (the warp routes below) and use
// the shared-memory network only for lists longer than a warp holds (and
// sort_kv for lists along columns).
//
// The order is total. Every entry is one 64-bit word: the key's bits made
// monotone (-0 and +0 equal, NaN after +inf) in the high half, the entry's
// position in the input in the low half. All words differ, so the network,
// which is not stable by itself, returns exactly what a stable sort by key
// returns: among equal keys the earlier input position first (in pool_merge:
// the first operand first). Keys and payloads are written from
// the inputs at the sorted positions, so their bits pass through untouched.
// Slots that pad a list to a power of two hold the largest word.
//
// Bound: memory, by the bytes that must move (each input read once, each
// output written once); the compare-exchanges, log2(P)(log2(P)+1)/2 stages
// of P/2 each on the CUDA cores, stay below it on paper and above it in
// practice, since every stage of the network is a shared-memory round
// trip. The network's design
// keeps a list on chip from load to store: one thread block holds 256 / T
// lists of T = min(P/2, 256) threads each, so short lists share a block;
// stages whose partner distance is at most 32 touch only words the same
// warp wrote, and are fenced with __syncwarp instead of a block barrier.
//
// Plain C entry points for ctypes; each returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kBlock = 256;
constexpr u64 kPadHi = 0xFFFFFFFFull << 32;

// f32 bits -> u32 whose unsigned order is the float order, -0 == +0, every
// NaN after +inf
__device__ __forceinline__ uint32_t orderable(float f) {
  uint32_t b = __float_as_uint(f);
  if ((b & 0x7FFFFFFFu) > 0x7F800000u) {
    return 0xFFFFFFFFu;
  }
  if (b == 0x80000000u) {
    b = 0u;
  }
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ u64 compose(float key, int pos) {
  return (static_cast<u64>(orderable(key)) << 32) | static_cast<uint32_t>(pos);
}

__device__ __forceinline__ int position(u64 word) {
  return static_cast<int>(static_cast<uint32_t>(word));
}

// the one compare-exchange: s[i] and s[i + j] in order (ascending if up)
__device__ __forceinline__ void cmpex(u64* s, int i, int j, bool up) {
  const u64 a = s[i];
  const u64 b = s[i + j];
  if ((a > b) == up) {
    s[i] = b;
    s[i + j] = a;
  }
}

// Between two stages: a stage of distance <= 32 reads and writes only words
// of the 64-word span its own warp owns, so a warp fence is enough when the
// stage before it was such a stage too.
__device__ __forceinline__ void stage_fence(int j_before, int j) {
  if (j_before > 32 || j > 32) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// one stage of distance j over the P words of a list; pair e of P/2 sits at
// i = e with a zero bit inserted at j
__device__ __forceinline__ void stage(u64* s, int P, int lane, int T, int j,
                                      int size) {
  for (int e = lane; e < (P >> 1); e += T) {
    const int i = 2 * e - (e & (j - 1));
    cmpex(s, i, j, (i & size) == 0);
  }
}

// Full bitonic sort of s[0, P) ascending, P a power of two. Every thread of
// the block calls it (the barriers are block-wide).
__device__ void bitonic_sort(u64* s, int P, int lane, int T) {
  int j_before = 64;  // the words were stored block-wide
  for (int size = 2; size <= P; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      stage_fence(j_before, j);
      stage(s, P, lane, T, j, size);
      j_before = j;
    }
  }
  __syncthreads();
}

struct Slot {
  u64* s;        // this list's words
  long long b;   // list index
  int lane;      // thread within the list
  bool active;   // b < B
};

__device__ __forceinline__ Slot slot_of(u64* smem, long long B, int P, int T) {
  const int g = threadIdx.x / T;
  Slot sl;
  sl.s = smem + static_cast<size_t>(g) * P;
  sl.b = static_cast<long long>(blockIdx.x) * (kBlock / T) + g;
  sl.lane = threadIdx.x % T;
  sl.active = sl.b < B;
  return sl;
}

__global__ void __launch_bounds__(kBlock)
sort_kv_kernel(const float* __restrict__ keys, const int* __restrict__ pay,
               float* __restrict__ okeys, int* __restrict__ opay,
               long long* __restrict__ oidx, long long B, int K, int kout,
               long long ls, long long is, long long ols, long long ois,
               int P, int T) {
  extern __shared__ u64 smem[];
  const Slot sl = slot_of(smem, B, P, T);
  const long long base = sl.b * ls;
  for (int idx = sl.lane; idx < P; idx += T) {
    u64 w = kPadHi | static_cast<uint32_t>(idx);
    if (sl.active && idx < K) {
      w = compose(__ldg(keys + base + idx * is), idx);
    }
    sl.s[idx] = w;
  }
  bitonic_sort(sl.s, P, sl.lane, T);
  if (!sl.active) {
    return;
  }
  const long long obase = sl.b * ols;
  for (int o = sl.lane; o < kout; o += T) {
    const int pos = position(sl.s[o]);
    okeys[obase + o * ois] = __ldg(keys + base + pos * is);
    if (opay != nullptr) {
      opay[obase + o * ois] = __ldg(pay + base + pos * is);
    }
    if (oidx != nullptr) {
      oidx[obase + o * ois] = pos;
    }
  }
}

struct Entry {
  float d;
  int id;
  int flag;
};

// the input entry a sorted word names: rows a (first operand) and b
__device__ __forceinline__ Entry entry_at(u64 word, const float* da,
                                          const int* ia, const uint8_t* fa,
                                          const float* db, const int* ib,
                                          const uint8_t* fb, int L1) {
  int pos = position(word);
  const bool first = pos < L1;
  if (!first) {
    pos -= L1;
  }
  const uint8_t* f = first ? fa : fb;
  Entry e;
  e.d = __ldg((first ? da : db) + pos);
  e.id = __ldg((first ? ia : ib) + pos);
  e.flag = f != nullptr ? (__ldg(f + pos) != 0) : 0;
  return e;
}

__global__ void __launch_bounds__(kBlock)
pool_merge_kernel(const float* __restrict__ d1, const int* __restrict__ i1,
                  const uint8_t* __restrict__ f1,
                  const float* __restrict__ d2, const int* __restrict__ i2,
                  const uint8_t* __restrict__ f2, float* __restrict__ od,
                  int* __restrict__ oi, uint8_t* __restrict__ of,
                  long long B, int L1, int L2, int kout, int dedup, int P,
                  int T) {
  extern __shared__ u64 smem[];
  const Slot sl = slot_of(smem, B, P, T);
  const long long r1 = sl.b * L1;
  const long long r2 = sl.b * L2;
  for (int idx = sl.lane; idx < P; idx += T) {
    u64 w = kPadHi | static_cast<uint32_t>(idx);
    if (sl.active && idx < L1) {
      w = compose(__ldg(d1 + r1 + idx), idx);
    } else if (sl.active && idx < L1 + L2) {
      w = compose(__ldg(d2 + r2 + idx - L1), idx);
    }
    sl.s[idx] = w;
  }
  bitonic_sort(sl.s, P, sl.lane, T);
  if (!sl.active) {
    return;
  }
  for (int o = sl.lane; o < kout; o += T) {
    Entry e = entry_at(sl.s[o], d1 + r1, i1 + r1, f1 != nullptr ? f1 + r1 : nullptr,
                       d2 + r2, i2 + r2, f2 != nullptr ? f2 + r2 : nullptr, L1);
    if (dedup && o > 0 && e.id >= 0 && isfinite(e.d)) {
      const Entry p = entry_at(sl.s[o - 1], d1 + r1, i1 + r1,
                               f1 != nullptr ? f1 + r1 : nullptr, d2 + r2,
                               i2 + r2, f2 != nullptr ? f2 + r2 : nullptr,
                               L1);
      if (p.id == e.id && p.flag == e.flag) {
        e.d = __int_as_float(0x7F800000);  // +inf
        e.id = -1;
        e.flag = 1;
      }
    }
    od[sl.b * kout + o] = e.d;
    oi[sl.b * kout + o] = e.id;
    if (of != nullptr) {
      of[sl.b * kout + o] = static_cast<uint8_t>(e.flag);
    }
  }
}

// ------------------------------------------------------------------------
// pool_merge, the warp route: one warp per list, the words in registers.
//
// A list of P = 32 R words (P a power of two, R = 1 .. 16) lives in one
// warp, lane l holding the words l R .. l R + R - 1 of the list in w[0, R).
// A stage of partner distance j < R is a compare-exchange between two of a
// lane's own registers; a wider stage exchanges w[r] with lane l ^ (j / R)
// through __shfl_xor_sync (two 32-bit shuffles per word), each lane keeping
// the smaller or the larger word by its place in the pair and the
// direction of the stage. No stage touches shared memory or a barrier.
//
// The hop's merge is three such pieces rather than one sort of the padded
// concatenation:
//   1. the L2 candidates are sorted alone (P2 = 256 at the hop: 36 stages;
//      512 at the fusion index's hop, whose rows are twice as wide);
//   2. the pool (L1 words) is sorted only if it is not ascending. It is the
//      previous merge's output, ascending except where the dedup left an
//      (inf, -1) hole; one __all_sync over the lanes decides;
//   3. the first M = pow2(kout) words of each sorted list meet in a
//      per-warp slot of shared memory; lane l takes C[i] = min(A[i],
//      B[M - 1 - i]) for its i, the M smallest of both lists as a bitonic
//      sequence, and one bitonic merge of M words (log2 M stages) sorts it.
//      That slot is the one shared-memory round trip, between the sorts and
//      the merge; no stage goes through it.
// All words differ, so the first kout of C are exactly the first kout of
// the stable sort of the concatenation: what pool_merge_kernel above
// returns, bit for bit. Slots past a list's end hold ~0, above every real
// word (a NaN key's word has a real position in its low half).
//
// Bound: as above, the bytes (6.6 MB at [4096, 64 + 256], 64 out); the
// compare-exchanges are ~1,700 instructions per warp at the hop's shape.

constexpr u64 kPadWord = ~0ull;
constexpr int kWarpRoute = 512;   // longest list (and pow2(kout)) in a warp
constexpr int kWarpBlock = 128;   // four lists per block

// One stage (partner distance j, bitonic block size) of the warp's sort. A
// shuffle stage (j >= R) takes its direction from the lane alone: size > j
// >= R, so r never carries into the size bit. One 64-bit compare decides an
// exchange: the words differ, and two equal pads are the same either way.
template <int R>
__device__ __forceinline__ void warp_stage(u64 (&w)[R], int lane, int size,
                                           int j) {
  if (j >= R) {
    const int lj = j / R;
    const bool keep_min = ((lane & lj) == 0) == (((lane * R) & size) == 0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const u64 other = __shfl_xor_sync(0xffffffffu, w[r], lj);
      w[r] = ((other < w[r]) == keep_min) ? other : w[r];
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((r & j) == 0) {
        const bool up = size >= R ? ((lane * R) & size) == 0
                                  : (r & size) == 0;
        const u64 a = w[r];
        const u64 b = w[r | j];
        const bool swap = (a > b) == up;
        w[r] = swap ? b : a;
        w[r | j] = swap ? a : b;
      }
    }
  }
}

// bitonic sort of the warp's 32 R words, ascending
template <int R>
__device__ __forceinline__ void warp_sort(u64 (&w)[R], int lane) {
  constexpr int kLog = (R >= 32 ? 5 : R >= 16 ? 4 : R >= 8 ? 3
                        : R >= 4 ? 2 : R >= 2 ? 1 : 0) + 5;
#pragma unroll
  for (int ls = 1; ls <= kLog; ++ls) {
#pragma unroll
    for (int lj = ls - 1; lj >= 0; --lj) {
      warp_stage<R>(w, lane, 1 << ls, 1 << lj);
    }
  }
}

// Load one list of n keys (positions pos0 + idx) into the warp's registers,
// sort it (the pool only if it is not ascending), and write its first m
// words to s[0, m).
template <int R>
__device__ void warp_list(const float* __restrict__ keys, int n, int pos0,
                          bool skip_if_ascending, u64* s, int m, int lane) {
  u64 w[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = lane * R + r;
    w[r] = idx < n ? compose(__ldg(keys + idx), pos0 + idx) : kPadWord;
  }
  bool sorted = false;
  if (skip_if_ascending) {
    bool up = true;
#pragma unroll
    for (int r = 1; r < R; ++r) {
      up = up && (w[r - 1] < w[r] || w[r] == kPadWord);
    }
    const u64 before = __shfl_up_sync(0xffffffffu, w[R - 1], 1);
    up = up && (lane == 0 || before < w[0] || w[0] == kPadWord);
    sorted = __all_sync(0xffffffffu, up);
  }
  if (!sorted) {
    warp_sort<R>(w, lane);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int idx = lane * R + r;
    if (idx < m) {
      s[idx] = w[r];
    }
  }
}

// C[i] = min(A[i], B[m - 1 - i]) from the slot, sorted; entries out
template <int R>
__device__ void warp_merge_out(const u64* sa, const u64* sb, int pa, int pb,
                               const float* d1, const int* i1,
                               const uint8_t* f1, const float* d2,
                               const int* i2, const uint8_t* f2, float* od,
                               int* oi, uint8_t* of, int L1, int kout,
                               int dedup, int lane) {
  constexpr int m = 32 * R;
  u64 w[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = lane * R + r;
    const u64 a = i < pa ? sa[i] : kPadWord;
    const u64 b = m - 1 - i < pb ? sb[m - 1 - i] : kPadWord;
    w[r] = a < b ? a : b;
  }
#pragma unroll
  for (int lj = (R >= 32 ? 5 : R >= 16 ? 4 : R >= 8 ? 3 : R >= 4 ? 2
                 : R >= 2 ? 1 : 0) + 4; lj >= 0; --lj) {
    warp_stage<R>(w, lane, m, 1 << lj);
  }
  Entry e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane * R + r < kout) {
      e[r] = entry_at(w[r], d1, i1, f1, d2, i2, f2, L1);
    } else {
      e[r].d = 0.f;
      e[r].id = -2;
      e[r].flag = 0;
    }
  }
  // the entry before this lane's first: the last of the lane below
  const int prev_id = __shfl_up_sync(0xffffffffu, e[R - 1].id, 1);
  const int prev_flag = __shfl_up_sync(0xffffffffu, e[R - 1].flag, 1);
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int o = lane * R + r;
    if (o >= kout) {
      continue;
    }
    Entry x = e[r];
    if (dedup && o > 0 && x.id >= 0 && isfinite(x.d)) {
      const int pid = r > 0 ? e[r > 0 ? r - 1 : 0].id : prev_id;
      const int pfl = r > 0 ? e[r > 0 ? r - 1 : 0].flag : prev_flag;
      if (pid == x.id && pfl == x.flag) {
        x.d = __int_as_float(0x7F800000);  // +inf
        x.id = -1;
        x.flag = 1;
      }
    }
    od[o] = x.d;
    oi[o] = x.id;
    if (of != nullptr) {
      of[o] = static_cast<uint8_t>(x.flag);
    }
  }
}

// R is 1, 2, 4, 8 or (kRMax 16) 16
template <int kRMax>
__device__ __forceinline__ void warp_list_r(int R, const float* keys, int n,
                                            int pos0, bool skip, u64* s,
                                            int m, int lane) {
  switch (R) {
    case 1: warp_list<1>(keys, n, pos0, skip, s, m, lane); break;
    case 2: warp_list<2>(keys, n, pos0, skip, s, m, lane); break;
    case 4: warp_list<4>(keys, n, pos0, skip, s, m, lane); break;
    case 8: warp_list<8>(keys, n, pos0, skip, s, m, lane); break;
    default: warp_list<kRMax>(keys, n, pos0, skip, s, m, lane); break;
  }
}

// Lists and kout up to kWarpRoute = 512 words: the hops of every search
// and build pool (ef up to 200 against 256 candidates, and the fusion
// index's 512). Two instances: up to 8 words a lane (256), the hnsw and nsg
// hops, and up to 16, so the wider lists' registers do not lower the
// occupancy of the narrower ones. Longer lists take the network: a class of
// 32 words a lane tripled the time chip_smoke.py spends building the
// kernels, for merges that only the tests launch.
template <int kRMax>
__global__ void __launch_bounds__(kWarpBlock)
pool_merge_warp_kernel(const float* __restrict__ d1, const int* __restrict__ i1,
                       const uint8_t* __restrict__ f1,
                       const float* __restrict__ d2,
                       const int* __restrict__ i2,
                       const uint8_t* __restrict__ f2, float* __restrict__ od,
                       int* __restrict__ oi, uint8_t* __restrict__ of,
                       long long B, int L1, int L2, int kout, int dedup,
                       int R1, int R2, int RM) {
  extern __shared__ u64 smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * (kWarpBlock / 32)
                      + warp;
  if (b >= B) {
    return;  // the whole warp: no shuffle below waits on it
  }
  const int m = 32 * RM;
  u64* sa = smem + static_cast<size_t>(warp) * 2 * m;
  u64* sb = sa + m;
  const long long r1 = b * L1;
  const long long r2 = b * L2;
  const int pa = 32 * R1 < m ? 32 * R1 : m;
  const int pb = 32 * R2 < m ? 32 * R2 : m;
  warp_list_r<kRMax>(R2, d2 + r2, L2, L1, false, sb, pb, lane);
  warp_list_r<kRMax>(R1, d1 + r1, L1, 0, true, sa, pa, lane);
  __syncwarp();
  const uint8_t* g1 = f1 != nullptr ? f1 + r1 : nullptr;
  const uint8_t* g2 = f2 != nullptr ? f2 + r2 : nullptr;
  uint8_t* go = of != nullptr ? of + b * kout : nullptr;
  float* o_d = od + b * kout;
  int* o_i = oi + b * kout;
#define ALAYA_MERGE_OUT(RR)                                                   \
  warp_merge_out<RR>(sa, sb, pa, pb, d1 + r1, i1 + r1, g1, d2 + r2, i2 + r2, \
                     g2, o_d, o_i, go, L1, kout, dedup, lane)
  switch (RM) {
    case 1: ALAYA_MERGE_OUT(1); break;
    case 2: ALAYA_MERGE_OUT(2); break;
    case 4: ALAYA_MERGE_OUT(4); break;
    case 8: ALAYA_MERGE_OUT(8); break;
    default: ALAYA_MERGE_OUT(kRMax); break;
  }
#undef ALAYA_MERGE_OUT
}

// ------------------------------------------------------------------------
// sort_kv, the warp route: lists along rows of up to kWarpRoute keys.
//
// One warp per list, its P = 32 R words in registers (lane l holds words
// l R .. l R + R - 1), sorted by warp_sort<R>, the network pool_merge's
// warp route runs: stages of distance < R inside a lane's registers, wider
// ones by __shfl_xor_sync; no barrier. The words are the
// same as the network's (compose: monotone key bits, position), so the
// first kout come out as the stable sort's, bit for bit what
// sort_kv_kernel above returns. A lane loads its R consecutive keys as
// float4 where the row allows (K % 4 == 0, a 16-byte aligned base, R >= 4);
// the first kout sorted positions pass through shared memory, lane l then
// writing outputs l, l + 32, ... (coalesced) with keys and payloads taken
// from the input at those positions. Slots past K hold ~0, above every real
// word.
//
// Bound: the bytes, as above (at [4096, 256] with a payload, 8.4 MB in and
// 8.4 MB out: 5.0 us at 3.35 TB/s). The network spends a shared-memory
// round trip on each of its 36 stages at that width, and a block barrier on
// each stage wider than 32; here the 21 stages of distance < 8 (R = 8)
// stay in a lane's registers and the other 15 are one shuffle pair a word.
template <int R>
__global__ void __launch_bounds__(kWarpBlock)
sort_kv_warp_kernel(const float* __restrict__ keys, const int* __restrict__ pay,
                    float* __restrict__ okeys, int* __restrict__ opay,
                    long long* __restrict__ oidx, long long B, int K,
                    int kout, int vec) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * (kWarpBlock / 32)
                      + warp;
  if (b >= B) {
    return;  // the whole warp: no shuffle below waits on it
  }
  const float* row = keys + b * K;
  const int i0 = lane * R;
  u64 w[R];
  bool loaded = false;
  if constexpr (R >= 4) {
    if (vec) {
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const int idx = i0 + r;
        if (idx < K) {  // K % 4 == 0: the four are all in the row or all out
          const float4 x = __ldg(reinterpret_cast<const float4*>(row + idx));
          w[r] = compose(x.x, idx);
          w[r + 1] = compose(x.y, idx + 1);
          w[r + 2] = compose(x.z, idx + 2);
          w[r + 3] = compose(x.w, idx + 3);
        } else {
          w[r] = w[r + 1] = w[r + 2] = w[r + 3] = kPadWord;
        }
      }
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int idx = i0 + r;
      w[r] = idx < K ? compose(__ldg(row + idx), idx) : kPadWord;
    }
  }
  warp_sort<R>(w, lane);
  // the sorted positions through shared memory, so that lane l writes
  // outputs l, l + 32, ...: coalesced stores (a row of R + 1 words a lane
  // keeps the writes free of bank conflicts)
  __shared__ int spos[kWarpBlock / 32][32 * (R + 1)];
  int* sp = spos[warp];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (i0 + r < kout) {
      sp[lane * (R + 1) + r] = position(w[r]);
    }
  }
  __syncwarp();
  const long long ob = b * kout;
  for (int o = lane; o < kout; o += 32) {
    const int pos = sp[(o / R) * (R + 1) + o % R];
    okeys[ob + o] = __ldg(row + pos);
    if (opay != nullptr) {
      opay[ob + o] = __ldg(pay + b * K + pos);
    }
    if (oidx != nullptr) {
      oidx[ob + o] = pos;
    }
  }
}

// words per lane for a list of n entries: pow2(n) / 32, at least 1
int lane_words(long long n) {
  int p = 32;
  while (p < n) {
    p <<= 1;
  }
  return p / 32;
}

struct Plan {
  int P;          // list length padded to a power of two
  int T;          // threads per list
  unsigned grid;  // blocks
  size_t smem;    // bytes of dynamic shared memory
};

Plan plan_for(long long B, long long n) {
  Plan p;
  p.P = 1;
  while (p.P < n) {
    p.P <<= 1;
  }
  p.T = p.P / 2 < 1 ? 1 : (p.P / 2 > kBlock ? kBlock : p.P / 2);
  const int lists = kBlock / p.T;
  p.grid = static_cast<unsigned>((B + lists - 1) / lists);
  p.smem = static_cast<size_t>(lists) * p.P * sizeof(u64);
  return p;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) {
    return cudaSuccess;
  }
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" int alaya_sort_kv(const void* keys, const void* pay, void* okeys,
                             void* opay, void* oidx, long long B, int K,
                             int kout, long long ls, long long is,
                             long long ols, long long ois, void* stream) {
  if (B == 0 || K == 0 || kout == 0) {
    return 0;
  }
  const Plan p = plan_for(B, K);
  cudaError_t err = allow_smem(sort_kv_kernel, p.smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  sort_kv_kernel<<<p.grid, kBlock, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(keys), static_cast<const int*>(pay),
      static_cast<float*>(okeys), static_cast<int*>(opay),
      static_cast<long long*>(oidx), B, K, kout, ls, is, ols, ois, p.P, p.T);
  return static_cast<int>(cudaGetLastError());
}

// sort_kv through the warp route, lists along rows; the caller picks it
// for K <= kWarpRoute (returns cudaErrorInvalidValue past that). vec: K % 4
// == 0 and a 16-byte aligned keys.
extern "C" int alaya_sort_kv_warp(const void* keys, const void* pay,
                                  void* okeys, void* opay, void* oidx,
                                  long long B, int K, int kout, int vec,
                                  void* stream) {
  if (B == 0 || K == 0 || kout == 0) {
    return 0;
  }
  const int R = lane_words(K);
  if (R * 32 > kWarpRoute || kout > K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>(
      (B + kWarpBlock / 32 - 1) / (kWarpBlock / 32));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ALAYA_SORT_WARP(RR)                                                  \
  sort_kv_warp_kernel<RR><<<grid, kWarpBlock, 0, s>>>(                       \
      static_cast<const float*>(keys), static_cast<const int*>(pay),         \
      static_cast<float*>(okeys), static_cast<int*>(opay),                   \
      static_cast<long long*>(oidx), B, K, kout, vec)
  switch (R) {
    case 1: ALAYA_SORT_WARP(1); break;
    case 2: ALAYA_SORT_WARP(2); break;
    case 4: ALAYA_SORT_WARP(4); break;
    case 8: ALAYA_SORT_WARP(8); break;
    default: ALAYA_SORT_WARP(16); break;
  }
#undef ALAYA_SORT_WARP
  return static_cast<int>(cudaGetLastError());
}

extern "C" int alaya_pool_merge(const void* d1, const void* i1, const void* f1,
                                const void* d2, const void* i2, const void* f2,
                                void* od, void* oi, void* of, long long B,
                                int L1, int L2, int kout, int dedup,
                                void* stream) {
  if (B == 0 || kout == 0) {
    return 0;
  }
  const Plan p = plan_for(B, static_cast<long long>(L1) + L2);
  cudaError_t err = allow_smem(pool_merge_kernel, p.smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  pool_merge_kernel<<<p.grid, kBlock, p.smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d1), static_cast<const int*>(i1),
      static_cast<const uint8_t*>(f1), static_cast<const float*>(d2),
      static_cast<const int*>(i2), static_cast<const uint8_t*>(f2),
      static_cast<float*>(od), static_cast<int*>(oi),
      static_cast<uint8_t*>(of), B, L1, L2, kout, dedup, p.P, p.T);
  return static_cast<int>(cudaGetLastError());
}

// The same function through the warp route; the caller picks it for lists
// and kout of at most kWarpRoute (returns cudaErrorInvalidValue past that).
extern "C" int alaya_pool_merge_warp(const void* d1, const void* i1,
                                     const void* f1, const void* d2,
                                     const void* i2, const void* f2, void* od,
                                     void* oi, void* of, long long B, int L1,
                                     int L2, int kout, int dedup,
                                     void* stream) {
  if (B == 0 || kout == 0) {
    return 0;
  }
  const int R1 = lane_words(L1);
  const int R2 = lane_words(L2);
  const int RM = lane_words(kout);
  const int rmax = R1 > R2 ? (R1 > RM ? R1 : RM) : (R2 > RM ? R2 : RM);
  if (rmax * 32 > kWarpRoute) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(kWarpBlock / 32) * 2 * 32 * RM *
                      sizeof(u64);
  const unsigned grid = static_cast<unsigned>(
      (B + kWarpBlock / 32 - 1) / (kWarpBlock / 32));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = rmax <= 8 ? pool_merge_warp_kernel<8>
                                : pool_merge_warp_kernel<16>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  kernel<<<grid, kWarpBlock, smem, s>>>(
      static_cast<const float*>(d1), static_cast<const int*>(i1),
      static_cast<const uint8_t*>(f1), static_cast<const float*>(d2),
      static_cast<const int*>(i2), static_cast<const uint8_t*>(f2),
      static_cast<float*>(od), static_cast<int*>(oi),
      static_cast<uint8_t*>(of), B, L1, L2, kout, dedup, R1, R2, RM);
  return static_cast<int>(cudaGetLastError());
}
