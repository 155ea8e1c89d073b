// pool_sort: the sort and merge of a beam search's candidate pool, written
// for Hopper (sm_90a). Four kernels over one compare-exchange:
//
//   sort_kv     each list of f32 keys ascending, with an optional i32 payload
//               and the source positions; lists along rows [B, K] or along
//               columns [K, B] (strides); the first kout entries are written
//   merge_kv    two ascending lists [B, L1], [B, L2] with i32 payloads ->
//               the first kout entries of the ascending merge
//   pool_merge  the hop's whole merge in one launch: the concatenation
//               [B, L1] ‖ [B, L2] of (distance, id, flag) sorted ascending,
//               the first kout kept, the later of two adjacent equal
//               (distance, id, flag) entries turned into (inf, -1, true)
//   roll_n      n circular shifts of each row, one after the other
//
// Replaces the TPU kernels scripts/proto_pallas_sort.py:111 (sort_kernel)
// and :117 (merge_kernel), scripts/proto_pallas_sort2.py:81, :87, :92
// (sort_sub_kernel, sort_sub_pack_kernel, sort_lane_pack_kernel: layouts of
// the same sort, with and without payload) and scripts/opt_hop2.py:120
// (roll_kernel_n). Those hold 32 or 128 lists as one [BT, K] or [K, BT] tile
// and reach a lane's partner with two circular rolls per stage; neither the
// tile nor the roll is part of the function. Here a list lives in shared
// memory and a thread reads its partner there.
//
// The order is total. Every entry is one 64-bit word: the key's bits made
// monotone (-0 and +0 equal, NaN after +inf) in the high half, the entry's
// position in the input in the low half. All words differ, so the network,
// which is not stable by itself, returns exactly what a stable sort by key
// returns: among equal keys the earlier input position first (in pool_merge
// and merge_kv: the first operand first). Keys and payloads are written from
// the inputs at the sorted positions, so their bits pass through untouched.
// Slots that pad a list to a power of two hold the largest word.
//
// Bound: memory, by the bytes that must move (each input read once, each
// output written once); the compare-exchanges, log2(P)(log2(P)+1)/2 stages
// of P/2 each on the CUDA cores, stay below it on paper and above it in
// practice, since every stage is a shared-memory round trip. The design
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

// Bitonic merge of s[0, P) ascending: s rises and then falls on entry.
__device__ void bitonic_merge(u64* s, int P, int lane, int T) {
  int j_before = 64;
  for (int j = P >> 1; j > 0; j >>= 1) {
    stage_fence(j_before, j);
    stage(s, P, lane, T, j, P);
    j_before = j;
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

__global__ void __launch_bounds__(kBlock)
merge_kv_kernel(const float* __restrict__ ka, const int* __restrict__ pa,
                const float* __restrict__ kb, const int* __restrict__ pb,
                float* __restrict__ okeys, int* __restrict__ opay,
                long long B, int L1, int L2, int kout, int P, int T) {
  extern __shared__ u64 smem[];
  const Slot sl = slot_of(smem, B, P, T);
  const float* a = ka + sl.b * L1;
  const float* b = kb + sl.b * L2;
  // a rising, padding rising, b reversed: the words rise and then fall
  for (int idx = sl.lane; idx < P; idx += T) {
    u64 w = kPadHi | static_cast<uint32_t>(L2 + idx);
    if (sl.active && idx < L1) {
      w = compose(__ldg(a + idx), idx);
    } else if (sl.active && idx >= P - L2) {
      const int j = P - 1 - idx;
      w = compose(__ldg(b + j), L1 + j);
    }
    sl.s[idx] = w;
  }
  bitonic_merge(sl.s, P, sl.lane, T);
  if (!sl.active) {
    return;
  }
  for (int o = sl.lane; o < kout; o += T) {
    const int pos = position(sl.s[o]);
    const bool first = pos < L1;
    okeys[sl.b * kout + o] = first ? __ldg(a + pos) : __ldg(b + pos - L1);
    opay[sl.b * kout + o] = first ? __ldg(pa + sl.b * L1 + pos)
                                  : __ldg(pb + sl.b * L2 + pos - L1);
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

// n circular shifts by 1 + (j mod 7), one after the other: every shift is
// one partner read in shared memory and one barrier, the exchange a sort
// stage is made of.
__global__ void __launch_bounds__(kBlock)
roll_n_kernel(const float* __restrict__ x, float* __restrict__ out, int K,
              int n) {
  extern __shared__ u64 smem[];
  float* cur = reinterpret_cast<float*>(smem);
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

extern "C" int alaya_merge_kv(const void* ka, const void* pa, const void* kb,
                              const void* pb, void* okeys, void* opay,
                              long long B, int L1, int L2, int kout,
                              void* stream) {
  if (B == 0 || kout == 0) {
    return 0;
  }
  const Plan p = plan_for(B, static_cast<long long>(L1) + L2);
  cudaError_t err = allow_smem(merge_kv_kernel, p.smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  merge_kv_kernel<<<p.grid, kBlock, p.smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ka), static_cast<const int*>(pa),
      static_cast<const float*>(kb), static_cast<const int*>(pb),
      static_cast<float*>(okeys), static_cast<int*>(opay), B, L1, L2, kout,
      p.P, p.T);
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

extern "C" int alaya_roll_n(const void* x, void* out, long long B, int K,
                            int n, void* stream) {
  if (B == 0 || K == 0) {
    return 0;
  }
  const size_t smem = static_cast<size_t>(2) * K * sizeof(float);
  cudaError_t err = allow_smem(roll_n_kernel, smem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  roll_n_kernel<<<static_cast<unsigned>(B), kBlock, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), K, n);
  return static_cast<int>(cudaGetLastError());
}
