// seed_scan: the block search's per-query entry points, the nseed sample
// points of least  sq[j] - 2 * sum_d bf16(q[i, d]) * vec[j, d]  for each
// query row, written for Hopper (sm_90a).
//
//   q f32 [B, D], vecs bf16 [S, D], sq f32 [S], ids i32 [S], nseed <= 16
//   -> out i32 [B, nseed] = ids[sel], sel ascending by score, the lower j
//      first among equal scores (lax.top_k's order), a NaN score last
//
// It replaces no Pallas kernel: the JAX package leaves this product and
// approx_max_k to XLA (alayalite_tpu/index/search.py, scan_seeds). It was
// added because the PyTorch chain that computed it (an f32 gemm of the
// bf16-rounded operands on the FFMA cores, 2 * dot, the broadcast subtract,
// torch.topk) set about 36% of the bsq8 search's device time: it wrote a
// [4096, 16384] f32 score matrix three times a slice, ~0.8 GB, and the
// radix top-k read it again in several passes.
//
// Bound: operations. At (B 4096, S 16384, D 128) the product is 17.2 GFLOP
// of bf16 x bf16, 0.017 ms on the tensor cores at 989 TFLOP/s; the inputs
// (2 MB of queries, the 4 MB sample, which L2 holds) and the [4096, 8]
// output are 0.002 ms of device memory. What the design does about it:
//   - the scores never leave the SM. A block holds BM query rows as bf16 in
//     shared memory for all of D (zero-padded to a multiple of 64) and walks
//     64-row tiles of the sample through a cp.async ring (4 stages of 64
//     columns of D). Eight warps run mma.sync m16n8k16 (bf16 in, f32
//     accumulate: every product is exact in f32, so only the order of the
//     sums differs from the chain's) into registers; the epilogue forms
//     sq - 2 * acc (one rounding, as sq - (2 * dot) rounds) into a [BM, 64]
//     tile of shared memory;
//   - one thread a query row scans that tile against its row's running
//     nseed-th best, held sorted in its registers with the ids (16 or 32
//     registers): a bit mask of the scores that may beat it, with no
//     branch, then one insert for each bit set, so the warp diverges only
//     over the few candidates a tile has (a branch a score, tried first,
//     diverged on every score any lane of the warp took, and the inserts
//     set the kernel's time); the tile is the only place a score is
//     written;
//   - the card is filled at every batch: the sample is split across
//     blockIdx.y so that rows x splits blocks fill the SMs once (from the
//     occupancy of the instance that runs), each split at least two tiles.
//     Each block writes its rows' partial best to the caller's scratch
//     [splits, B, K], and a second kernel merges them, a warp a row (a
//     butterfly arg-min nseed times), and writes ids[sel]. B 4096 and S
//     16384 give 32 row tiles x 8 splits; a served batch of ~50 rows 1 x 128.
// BM follows D: 128 rows a block while the rows fit shared memory beside
// the ring and the score tile (two blocks an SM at D 128), then 64, then 16
// (D up to 5952).
//
// Launches on the caller's stream, allocates nothing, never synchronises:
// safe inside a CUDA graph's capture. Plain C entry points for ctypes; each
// returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // eight warps
constexpr int kBN = 64;           // sample rows a tile
constexpr int kKC = 64;           // columns of D a ring stage
constexpr int kStages = 4;
constexpr int kSB = kKC + 8;      // ring row stride (bf16): 144 B, odd x 16
constexpr int kSS = kBN + 4;      // score row stride (f32): 272 B, odd x 16
constexpr int kMaxDevices = 64;
constexpr int kIdxNone = 0x7fffffff;

constexpr size_t smem_bytes(int bm, int dp) {
  return static_cast<size_t>(bm) * (dp + 8) * 2 +
         static_cast<size_t>(kStages) * kBN * kSB * 2 +
         static_cast<size_t>(bm) * kSS * 4;
}

// (a, ia) before (b, ib): by score, then by index
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

// Insert (s, j) into the sorted K best; a NaN score orders as +inf.
template <int K>
__device__ __forceinline__ void insert(float (&d)[K], int (&ix)[K], float s,
                                       int j) {
  if (s != s) {
    s = __int_as_float(0x7f800000);
  }
  if (!before(s, j, d[K - 1], ix[K - 1])) {
    return;
  }
#pragma unroll
  for (int p = K - 1; p > 0; --p) {
    if (before(s, j, d[p - 1], ix[p - 1])) {
      d[p] = d[p - 1];
      ix[p] = ix[p - 1];
    } else if (before(s, j, d[p], ix[p])) {
      d[p] = s;
      ix[p] = j;
    }
  }
  if (before(s, j, d[0], ix[0])) {
    d[0] = s;
    ix[0] = j;
  }
}

// The scan's insert: its scores come in increasing j, so j is past every
// index held, and a strict compare keeps the lower index first among equal
// scores. A finite score that beats the K-th best shifts with selects; +inf
// and NaN (rare) take the lexicographic insert, which orders them against
// the (+inf, none) fillers.
template <int K>
__device__ __forceinline__ void insert_next(float (&d)[K], int (&ix)[K],
                                            float s, int j) {
  if (s < d[K - 1]) {
#pragma unroll
    for (int p = K - 1; p > 0; --p) {
      const bool up = s < d[p - 1];
      const bool here = s < d[p];
      d[p] = up ? d[p - 1] : (here ? s : d[p]);
      ix[p] = up ? ix[p - 1] : (here ? j : ix[p]);
    }
    if (s < d[0]) {
      d[0] = s;
      ix[0] = j;
    }
  } else if (!(s <= 3.402823466e38f)) {
    insert<K>(d, ix, s, j);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// d (+)= a [16 x 16] * b [16 x 8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One ring stage: sample rows [j0, j0 + 64) x columns [k0, k0 + 64) of D,
// zeros past S and past D. The 16-byte route (vec: D % 8 == 0, the sample
// 16-byte aligned) copies asynchronously; the other loads element by
// element.
__device__ __forceinline__ void load_stage(__nv_bfloat16* st,
                                           const __nv_bfloat16* __restrict__ vecs,
                                           int S, int D, int j0, int k0,
                                           bool vec) {
  for (int seg = threadIdx.x; seg < kBN * (kKC / 8); seg += kThreads) {
    const int r = seg >> 3;
    const int c = (seg & 7) * 8;
    const int j = j0 + r;
    const int k = k0 + c;
    __nv_bfloat16* dst = st + r * kSB + c;
    if (vec) {
      const bool ok = j < S && k < D;
      cp_async16(dst, ok ? vecs + static_cast<size_t>(j) * D + k : vecs, ok);
    } else {
      uint16_t v[8];
      const uint16_t* row = reinterpret_cast<const uint16_t*>(vecs) +
                            static_cast<size_t>(j < S ? j : 0) * D;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = (j < S && k + e < D) ? row[k + e] : 0;
      }
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(v[0] | (uint32_t(v[1]) << 16), v[2] | (uint32_t(v[3]) << 16),
                     v[4] | (uint32_t(v[5]) << 16), v[6] | (uint32_t(v[7]) << 16));
    }
  }
}

// Warp layout of a [BM, 64] tile: WM x WN warps of (16 MT) x (8 NT).
template <int BM>
struct Layout {
  static constexpr int MT = BM >= 128 ? 2 : 1;
  static constexpr int WM = BM / (16 * MT);
  static constexpr int WN = (kThreads / 32) / WM;
  static constexpr int NT = kBN / (8 * WN);
  static_assert(WM * WN == kThreads / 32, "eight warps");
  static_assert(WN * NT * 8 == kBN, "64 columns");
};

template <int BM, int K>
__global__ void __launch_bounds__(kThreads, 2)
    seed_scan_kernel(const float* __restrict__ q,
                     const __nv_bfloat16* __restrict__ vecs,
                     const float* __restrict__ sq, float* __restrict__ part_d,
                     int* __restrict__ part_i, long long B, int S, int D,
                     int Dp, int tiles_per_split, int vec) {
  using L = Layout<BM>;
  constexpr int MT = L::MT, NT = L::NT;
  extern __shared__ __align__(16) uint8_t smem[];
  const int SA = Dp + 8;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + static_cast<size_t>(BM) * SA;
  float* Ss = reinterpret_cast<float*>(Bs + kStages * kBN * kSB);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % L::WM;
  const int wn = warp / L::WM;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int col_tiles = (S + kBN - 1) / kBN;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(col_tiles, t_begin + tiles_per_split);
  const int kchunks = Dp / kKC;
  const int steps = t_end > t_begin ? (t_end - t_begin) * kchunks : 0;

  // the ring's first stages, then the block's query rows as bf16 (round to
  // nearest even, as .to(torch.bfloat16)); zeros past D and past B
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      load_stage(Bs + s * kBN * kSB, vecs, S, D,
                 (t_begin + s / kchunks) * kBN, (s % kchunks) * kKC, vec);
    }
    cp_async_commit();
  }
  const int half = Dp / 2;
  for (int e = tid; e < BM * half; e += kThreads) {
    const int r = e / half;
    const int c = (e - r * half) * 2;
    const long long i = row0 + r;
    float a = 0.f, b = 0.f;
    if (i < B) {
      const float* qr = q + i * D;
      a = c < D ? qr[c] : 0.f;
      b = c + 1 < D ? qr[c + 1] : 0.f;
    }
    *reinterpret_cast<__nv_bfloat162*>(As + r * SA + c) =
        __floats2bfloat162_rn(a, b);
  }

  float acc[MT][NT][4];
  float bd[K];
  int bi[K];
#pragma unroll
  for (int p = 0; p < K; ++p) {
    bd[p] = __int_as_float(0x7f800000);
    bi[p] = kIdxNone;
  }
  const bool scans = tid < BM && row0 + tid < B;

  int kc = 0;
  int tile = t_begin;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int s = step + kStages - 1;
      if (s < steps) {
        load_stage(Bs + (s % kStages) * kBN * kSB, vecs, S, D,
                   (t_begin + s / kchunks) * kBN, (s % kchunks) * kKC, vec);
      }
      cp_async_commit();
    }
    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    const __nv_bfloat16* st = Bs + (step % kStages) * kBN * kSB;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * 16 * MT + mt * 16 + (lane & 15);
        ldmatrix_x4(a[mt], As + r * SA + kc * kKC + ks * 16 + (lane >> 4) * 8);
      }
      uint32_t b[NT][2];
      if constexpr (NT == 1) {
        const int n = wn * 8 + (lane & 7);
        ldmatrix_x2(b[0][0], b[0][1],
                    st + n * kSB + ks * 16 + ((lane >> 3) & 1) * 8);
      } else {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int n = wn * 8 * NT + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          uint32_t r4[4];
          ldmatrix_x4(r4, st + n * kSB + ks * 16 + ((lane >> 3) & 1) * 8);
          b[2 * np][0] = r4[0];
          b[2 * np][1] = r4[1];
          b[2 * np + 1][0] = r4[2];
          b[2 * np + 1][1] = r4[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    if (++kc < kchunks) {
      continue;
    }
    // the tile's last slice of D: scores into shared memory, then the scan
    kc = 0;
    const int j0 = tile * kBN;
    const int g = lane >> 2;
    const int c4 = (lane & 3) * 2;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = wn * 8 * NT + nt * 8 + c4;
      const int j = j0 + c;
      const float s0 = j < S ? __ldg(sq + j) : 0.f;
      const float s1 = j + 1 < S ? __ldg(sq + j + 1) : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * 16 * MT + mt * 16 + g;
        *reinterpret_cast<float2*>(Ss + r * kSS + c) =
            make_float2(fmaf(-2.f, acc[mt][nt][0], s0),
                        fmaf(-2.f, acc[mt][nt][1], s1));
        *reinterpret_cast<float2*>(Ss + (r + 8) * kSS + c) =
            make_float2(fmaf(-2.f, acc[mt][nt][2], s0),
                        fmaf(-2.f, acc[mt][nt][3], s1));
      }
    }
    __syncthreads();
    if (scans) {
      // which of the row's scores may beat its K-th best as the tile
      // starts: a bit each, no branch; then an insert for each bit set,
      // few past the first tiles (the threshold only falls)
      const float* row = Ss + tid * kSS;
      const float thr = bd[K - 1];
      uint32_t m[2] = {0u, 0u};
#pragma unroll
      for (int c = 0; c < kBN; c += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + c);
        m[c >> 5] |= (uint32_t(!(v.x > thr)) | uint32_t(!(v.y > thr)) << 1 |
                      uint32_t(!(v.z > thr)) << 2 |
                      uint32_t(!(v.w > thr)) << 3)
                     << (c & 31);
      }
      const int ncols = S - j0;           // the sample's ragged end
      if (ncols < kBN) {
        m[1] &= ncols <= 32 ? 0u : (1u << (ncols - 32)) - 1u;
        m[0] &= ncols >= 32 ? ~0u : (1u << ncols) - 1u;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        while (m[h]) {
          const int c = h * 32 + __ffs(m[h]) - 1;
          m[h] &= m[h] - 1;
          insert_next<K>(bd, bi, row[c], j0 + c);
        }
      }
    }
    ++tile;
  }
  if (scans) {
    const size_t o = (static_cast<size_t>(blockIdx.y) * B + row0 + tid) * K;
#pragma unroll
    for (int p = 0; p < K; ++p) {
      part_d[o + p] = bd[p];
      part_i[o + p] = bi[p];
    }
  }
}

// A warp a row: the row's best nseed of the splits' partial lists, ids[sel].
template <int K>
__global__ void __launch_bounds__(kThreads)
    seed_merge_kernel(const float* __restrict__ part_d,
                      const int* __restrict__ part_i,
                      const int* __restrict__ ids, int* __restrict__ out,
                      long long B, int splits, int nseed) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= B) {
    return;
  }
  const int lane = threadIdx.x & 31;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int p = 0; p < K; ++p) {
    bd[p] = __int_as_float(0x7f800000);
    bi[p] = kIdxNone;
  }
  for (int e = lane; e < splits * K; e += 32) {
    const int s = e / K;
    const size_t o = (static_cast<size_t>(s) * B + row) * K + (e - s * K);
    insert<K>(bd, bi, part_d[o], part_i[o]);
  }
  for (int r = 0; r < nseed; ++r) {
    float d = bd[0];
    int i = bi[0];
    int l = lane;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, o);
      const int oi = __shfl_xor_sync(0xffffffffu, i, o);
      const int ol = __shfl_xor_sync(0xffffffffu, l, o);
      if (before(od, oi, d, i) || (od == d && oi == i && ol < l)) {
        d = od;
        i = oi;
        l = ol;
      }
    }
    if (lane == l) {
#pragma unroll
      for (int p = 0; p < K - 1; ++p) {
        bd[p] = bd[p + 1];
        bi[p] = bi[p + 1];
      }
      bd[K - 1] = __int_as_float(0x7f800000);
      bi[K - 1] = kIdxNone;
    }
    if (lane == 0) {
      out[row * nseed + r] = ids[i];
    }
  }
}

struct DeviceState {
  int sms = 0;
  int smem_optin = 0;
  // per (BM route, K route): the dynamic shared memory the instance is
  // allowed, and its blocks an SM at the shared memory last asked about
  // (D sets it)
  size_t allowed[3][2] = {};
  size_t occ_smem[3][2] = {};
  int per_sm[3][2] = {};
};

DeviceState g_state[kMaxDevices];

cudaError_t device_state(DeviceState** out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) {
    return err;
  }
  if (dev >= kMaxDevices) {
    return cudaErrorInvalidDevice;
  }
  DeviceState& st = g_state[dev];
  if (st.sms == 0) {
    err = cudaDeviceGetAttribute(&st.smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) {
      st.sms = 0;
      return err;
    }
  }
  *out = &st;
  return cudaSuccess;
}

// The instance for D and K: its route (BM 128 / 64 / 16), its shared memory,
// its blocks an SM (asking the occupancy calculator when D changes).
struct Plan {
  int bm_route, k_route, Dp, per_sm, splits, tiles_per_split;
  size_t smem;
};

template <int BM, int K>
cudaError_t prepare(DeviceState& st, Plan& p) {
  auto kernel = seed_scan_kernel<BM, K>;
  size_t& allowed = st.allowed[p.bm_route][p.k_route];
  if (p.smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (err != cudaSuccess) {
      return err;
    }
    allowed = p.smem;
  }
  int& per_sm = st.per_sm[p.bm_route][p.k_route];
  size_t& occ_smem = st.occ_smem[p.bm_route][p.k_route];
  if (occ_smem != p.smem) {
    int n = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, kThreads, p.smem);
    if (err != cudaSuccess) {
      return err;
    }
    if (n < 1) {
      return cudaErrorInvalidConfiguration;
    }
    per_sm = n;
    occ_smem = p.smem;
  }
  p.per_sm = per_sm;
  return cudaSuccess;
}

template <int K>
cudaError_t prepare_k(DeviceState& st, Plan& p) {
  switch (p.bm_route) {
    case 0: return prepare<128, K>(st, p);
    case 1: return prepare<64, K>(st, p);
    default: return prepare<16, K>(st, p);
  }
}

cudaError_t make_plan(long long B, long long S, long long D, int nseed,
                      DeviceState** st_out, Plan& p) {
  DeviceState* st = nullptr;
  cudaError_t err = device_state(&st);
  if (err != cudaSuccess) {
    return err;
  }
  *st_out = st;
  p.Dp = static_cast<int>((D + kKC - 1) / kKC * kKC);
  p.k_route = nseed <= 8 ? 0 : 1;
  const int bms[3] = {128, 64, 16};
  p.bm_route = -1;
  for (int r = 0; r < 3; ++r) {
    if (smem_bytes(bms[r], p.Dp) <= static_cast<size_t>(st->smem_optin)) {
      p.bm_route = r;
      break;
    }
  }
  if (p.bm_route < 0) {
    return cudaErrorInvalidValue;
  }
  p.smem = smem_bytes(bms[p.bm_route], p.Dp);
  err = p.k_route == 0 ? prepare_k<8>(*st, p) : prepare_k<16>(*st, p);
  if (err != cudaSuccess) {
    return err;
  }
  // rows x splits blocks fill the SMs once; at least two tiles a split
  const long long row_tiles = (B + bms[p.bm_route] - 1) / bms[p.bm_route];
  const long long col_tiles = (S + kBN - 1) / kBN;
  long long splits = static_cast<long long>(p.per_sm) * st->sms / row_tiles;
  const long long most = col_tiles / 2 > 1 ? col_tiles / 2 : 1;
  splits = splits < 1 ? 1 : (splits > most ? most : splits);
  const long long tps = (col_tiles + splits - 1) / splits;
  p.tiles_per_split = static_cast<int>(tps);
  p.splits = static_cast<int>((col_tiles + tps - 1) / tps);
  return cudaSuccess;
}

template <int BM, int K>
void launch_scan(const Plan& p, const float* q, const __nv_bfloat16* vecs,
                 const float* sq, float* part_d, int* part_i, long long B,
                 int S, int D, int vec, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((B + BM - 1) / BM),
                  static_cast<unsigned>(p.splits));
  seed_scan_kernel<BM, K><<<grid, kThreads, p.smem, stream>>>(
      q, vecs, sq, part_d, part_i, B, S, D, p.Dp, p.tiles_per_split, vec);
}

template <int K>
void launch_k(const Plan& p, const float* q, const __nv_bfloat16* vecs,
              const float* sq, float* part_d, int* part_i, const int* ids,
              int* out, long long B, int S, int D, int nseed, int vec,
              cudaStream_t stream) {
  switch (p.bm_route) {
    case 0: launch_scan<128, K>(p, q, vecs, sq, part_d, part_i, B, S, D, vec, stream); break;
    case 1: launch_scan<64, K>(p, q, vecs, sq, part_d, part_i, B, S, D, vec, stream); break;
    default: launch_scan<16, K>(p, q, vecs, sq, part_d, part_i, B, S, D, vec, stream); break;
  }
  const unsigned mgrid =
      static_cast<unsigned>((B + kThreads / 32 - 1) / (kThreads / 32));
  seed_merge_kernel<K><<<mgrid, kThreads, 0, stream>>>(
      part_d, part_i, ids, out, B, p.splits, nseed);
}

}  // namespace

// The splits of a call at (B, S, D, nseed): the wrapper sizes the scratch
// [splits, B, K] by it (K = 8 for nseed <= 8, else 16). Launches nothing;
// takes the stream only as every entry point of the port does.
extern "C" int alaya_seed_scan_splits(long long B, long long S, long long D,
                                      int nseed, int* splits, void*) {
  DeviceState* st = nullptr;
  Plan p;
  const cudaError_t err = make_plan(B, S, D, nseed, &st, p);
  if (err == cudaSuccess) {
    *splits = p.splits;
  }
  return static_cast<int>(err);
}

// q f32 [B, D], vecs bf16 [S, D], sq f32 [S], ids i32 [S]; part_d / part_i
// the scratch of alaya_seed_scan_splits' size; out i32 [B, nseed]. The two
// kernels run in turn on the stream.
extern "C" int alaya_seed_scan(const void* q, const void* vecs, const void* sq,
                               const void* ids, void* part_d, void* part_i,
                               void* out, long long B, long long S,
                               long long D, int nseed, int vec, void* stream) {
  if (B == 0) {
    return 0;
  }
  DeviceState* st = nullptr;
  Plan p;
  cudaError_t err = make_plan(B, S, D, nseed, &st, p);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qf = static_cast<const float*>(q);
  auto* vb = static_cast<const __nv_bfloat16*>(vecs);
  auto* sqf = static_cast<const float*>(sq);
  auto* pd = static_cast<float*>(part_d);
  auto* pi = static_cast<int*>(part_i);
  auto* idp = static_cast<const int*>(ids);
  auto* o = static_cast<int*>(out);
  if (p.k_route == 0) {
    launch_k<8>(p, qf, vb, sqf, pd, pi, idp, o, B, static_cast<int>(S),
                static_cast<int>(D), nseed, vec, s);
  } else {
    launch_k<16>(p, qf, vb, sqf, pd, pi, idp, o, B, static_cast<int>(S),
                 static_cast<int>(D), nseed, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
