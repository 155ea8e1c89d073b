// gather_diagdot: the block hop's estimate stage with the neighbor-block
// gather inside the kernel, written for Hopper (sm_90a).
//
//   out[b, m*R + r] = sum_d (codes[u[b, m], r, d] - 128) * qs[b, d]
//   codes u8 [C, R, Dp], u i32 [B, M], qs bf16 [B, Dp] -> out f32 [B, M*R]
//
// and, as the rows entry with the identity gather (u[b, 0] = b, M = 1, C =
// B, R = K), block_diagdot over code blocks already gathered:
//
//   out[b, k] = sum_d (codes[b, k, d] - 128) * qs[b, d]
//   codes u8 [B, K, Dp], qs bf16 [B, Dp] -> out f32 [B, K]
//
// u is clamped into [0, C) here. With the estimate fused in (the second
// output set), each entry also writes BQGSpace.estimate_many's two outputs:
//
//   est[b, j] = (qconst[b] - coef * dot[b, j]) + xsq[node, r]   (0 if < 0
//               where clamp is set: L2)
//   ids[b, j] = nbr_ids[node, r]
//
// in exactly that f32 order (__fmul_rn, __fsub_rn, __fadd_rn: no FMA), so
// for the same dot the estimate equals the PyTorch epilogue bit for bit; a
// -1 slot's xsq is inf, so its estimate is inf.
//
// Three entry points, one per TPU kernel replaced:
//   rows  scripts/proto_dma_gather.py:93 (dma_diagdot): every popped node's
//         block is copied by DMA into scratch, then one product is taken;
//   bulk  scripts/proto_dma_gather2.py:124 (dma2_diagdot): the same with the
//         next tile's copies in flight while this tile computes;
//   block_diagdot  alayalite_tpu/ops/pallas_block.py:46 (_diagdot_kernel,
//         launched through _diagdot_call): the product over blocks the
//         caller gathered; here the rows kernel with no index to read.
// None is carried over tile by tile. The TPU kernels batch 32 queries so
// that their decoded blocks fill one MXU product whose block diagonal is
// kept; on Hopper that product is wasted work and each row is a plain dot
// on the CUDA cores.
//
// Bound: memory. Each code byte is used in one multiply-add. At the hop's
// shape (B 4096, M 8, R 32, Dp 128) every pop reads a 4 KB block: 134.2 MB
// of codes + 1.0 MB of qs + 4.2 MB of output + 0.1 MB of ids, 139.6 MB or
// ~42 us at 3.35 TB/s if every pop's block came from device memory. Pops
// that share a node need its bytes once (the hop's inactive pops all name
// node 0), so the bound chip_smoke.py states counts each distinct block
// once: 24,996 distinct nodes of 32,768 pops on its inputs, 0.0322 ms. The
// fused estimate adds 8 bytes of xsq + id read and 8 of output per row.
// The sq8 traversal's R = 1 shape (4096 x 256 pops of 128-byte rows) reads
// 134.2 MB if every pop came from device memory, but over 100,000 rows its
// distinct bytes are 12.8 MB (an L2-sized table): bound 0.0066 ms.
// block_diagdot's bytes are all distinct: at (4096, 256, 128) 134.2 MB of
// codes + 1.0 MB of qs + 4.2 MB of output, 0.0416 ms.
//
// Design. The old kernels (and block_diagdot's first kernel, a source of its
// own) ran a 256-thread block per (query, node or 64-row tile):
// stage qs in shared memory, barrier, one 16-byte load per thread per row,
// reduce. Each wave of blocks paid two memory latencies back to back with
// 4-16 KB in flight per block, and the sq8 traversal's one-row blocks (R =
// 1) left 248 of 256 threads idle. Here the unit of work is a code row:
//   rows  a CTA owns one query's M*R rows (or a slice). G = min(Dp/16, 16)
//         lanes (a power of two) share a row, each lane always the same
//         16-byte column slices, so its slice of qs[b] lives in registers,
//         read once from global bf16; no shared memory, no barrier. A group
//         owns kInFlight / (slices a lane) consecutive rows and starts every
//         row load (u, then the 64-bit row address, then 16-byte loads, up
//         to 8 x 16 B a thread) before its first multiply-add. R = 1 rows
//         are rows like any other: every lane works.
//   bulk  a persistent CTA walks a run of (query, pops) items; warp 0 moves
//         each popped node's R*Dp contiguous bytes with a TMA 1-D bulk copy
//         (cp.async.bulk, completion on an mbarrier) into a ring of
//         kStages stages, kStages - 1 items ahead; the CTA computes from the
//         stage as in rows (rows interleaved over the groups, qs[b] in
//         registers while b lasts), then one barrier frees the stage for
//         the next copy. Warp 0 loads the next item's node ids before it
//         computes, and keeps them in shared memory for the fused loads.
// A byte is decoded without an int-to-float conversion: the byte permute
// 0x4B0000bb is the float 2^23 + bb, and subtracting 2^23 + 128 leaves
// bb - 128 exactly. (c - 128) is exact in bf16 and each bf16 x bf16 product
// is exact in f32, so results differ from the plain PyTorch version only in
// the order of the f32 sums; both entries and both outputs sum a row in the
// same order (a lane's slices in turn, then a shuffle butterfly, which
// leaves the same bits in every lane of the group).
// Byte loads (G = 8) where 16-byte accesses are not possible: Dp % 16 != 0
// or an unaligned base; bulk needs R*Dp % 16 == 0 and 16-byte aligned codes.
//
// Plain C entry points for ctypes; each returns cudaGetLastError() after
// the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 8;       // 16-byte row loads a thread starts first
constexpr int kByteLanesLog = 3;   // byte path: 8 lanes a row
// bulk: shared memory holds the ring's mbarriers, kStages + 1 buffers of
// an item's node ids, then kStages stages of up to 16 KB or 128 pops
constexpr int kStages = 4;
constexpr int kStageTarget = 16384;
constexpr int kMaxPops = 128;
constexpr int kBarrierBytes = 128;
constexpr int kNodeBytes = (kStages + 1) * kMaxPops * 4;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;

// the fused estimate; qconst == nullptr: the dot alone
struct Estimate {
  const float* qconst;   // [B]
  const float* xsq;      // [C, R]
  const int* nbr_ids;    // [C, R]
  int* ids;              // [B, M*R]
  float coef;
  int clamp;
};

__device__ __forceinline__ float centred(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + j)) -
         8388736.0f;
}

// 16 bf16 of qs (two 16-byte words) as f32
__device__ __forceinline__ void widen(const uint4 (&qp)[2], float (&qf)[16]) {
  const uint32_t q[8] = {qp[0].x, qp[0].y, qp[0].z, qp[0].w,
                         qp[1].x, qp[1].y, qp[1].z, qp[1].w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    qf[2 * e] = __uint_as_float(q[e] << 16);
    qf[2 * e + 1] = __uint_as_float(q[e] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ float dot16(uint4 v, const float (&qf)[16],
                                       float acc) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = fmaf(centred(w[i], j), qf[4 * i + j], acc);
    }
  }
  return acc;
}

__device__ __forceinline__ long long clamp_node(int node, long long C) {
  const long long n = node;
  return n < 0 ? 0 : (n >= C ? C - 1 : n);
}

__device__ __forceinline__ float estimate(const Estimate& ep, float qc,
                                          float dot, float xs) {
  float e = __fadd_rn(__fsub_rn(qc, __fmul_rn(ep.coef, dot)), xs);
  if (ep.clamp && e < 0.f) {
    e = 0.f;
  }
  return e;
}

template <int kU>
__device__ __forceinline__ void butterfly(float (&acc)[kU], int G) {
  for (int off = G >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
    }
  }
}

// The lane's 16-byte slices of qs[b]: slice gl + c*G for c < kC
template <int kC>
__device__ __forceinline__ void load_q(const __nv_bfloat16* __restrict__ qb,
                                       int nchunks, int G, int gl,
                                       uint4 (&qp)[kC][2]) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int chunk = gl + c * G;
    qp[c][0] = qp[c][1] = make_uint4(0u, 0u, 0u, 0u);
    if (chunk < nchunks) {
      const uint4* p = reinterpret_cast<const uint4*>(qb) + 2 * chunk;
      qp[c][0] = __ldg(p);
      qp[c][1] = __ldg(p + 1);
    }
  }
}

// The lane's 16-byte slices of kU rows: row[k] points at row k's Dp bytes
// (in device memory when kGlobal, else in a shared stage); bit k of
// `valid` says whether row k exists
template <int kCPL, int kU, bool kGlobal>
__device__ __forceinline__ void load_rows(const uint8_t* const (&row)[kU],
                                          unsigned valid, int nchunks, int G,
                                          int gl, uint4 (&v)[kU][kCPL]) {
#pragma unroll
  for (int k = 0; k < kU; ++k) {
#pragma unroll
    for (int c = 0; c < kCPL; ++c) {
      const int chunk = gl + c * G;
      v[k][c] = make_uint4(0u, 0u, 0u, 0u);
      if (((valid >> k) & 1u) && chunk < nchunks) {
        const uint4* p = reinterpret_cast<const uint4*>(row[k]) + chunk;
        v[k][c] = kGlobal ? __ldg(p) : *p;
      }
    }
  }
}

// The lane's partial dots of the loaded slices
template <int kCPL, int kU>
__device__ __forceinline__ void dots(const uint4 (&v)[kU][kCPL],
                                     const uint4 (&qp)[kCPL][2],
                                     unsigned valid, int nchunks, int G,
                                     int gl, float (&acc)[kU]) {
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    acc[k] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < kCPL; ++c) {
    if (gl + c * G < nchunks) {
      float qf[16];
      widen(qp[c], qf);
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        if ((valid >> k) & 1u) {
          acc[k] = dot16(v[k][c], qf, acc[k]);
        }
      }
    }
  }
}

// The byte path: bytes gl, gl + G, ... of kU rows, qs read per byte
template <int kU, bool kGlobal>
__device__ __forceinline__ void byte_dots(const uint8_t* const (&row)[kU],
                                          unsigned valid,
                                          const __nv_bfloat16* __restrict__ qb,
                                          int Dp, int G, int gl,
                                          float (&acc)[kU]) {
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    acc[k] = 0.f;
  }
  for (int d = gl; d < Dp; d += G) {
    int c[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      c[k] = ((valid >> k) & 1u)
                 ? static_cast<int>(kGlobal ? __ldg(row[k] + d) : row[k][d])
                 : 128;
    }
    const float q = __bfloat162float(qb[d]);
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      acc[k] = fmaf(static_cast<float>(c[k] - 128), q, acc[k]);
    }
  }
}

// ---- rows: grid (B, slices of M*R), groups of G lanes own kU consecutive
// rows each; u == nullptr is the identity gather (node b, M = 1):
// block_diagdot
template <int kCPL, bool kFused>
__global__ void __launch_bounds__(kThreads, kCPL == 8 ? 2 : 3)
gather_rows_kernel(const uint8_t* __restrict__ codes,
                   const int* __restrict__ u,
                   const __nv_bfloat16* __restrict__ qs,
                   float* __restrict__ out, long long C, int M, int R, int Dp,
                   int lg_g, int rows_cta, Estimate ep) {
  constexpr int kU = kCPL == 0 ? kInFlight : kInFlight / kCPL;
  constexpr int kC = kCPL > 0 ? kCPL : 1;
  const int G = 1 << lg_g;
  const int gl = threadIdx.x & (G - 1);
  const long long b = blockIdx.x;
  const int MR = M * R;
  const int row0 = blockIdx.y * rows_cta + (threadIdx.x >> lg_g) * kU;
  const int nchunks = Dp >> 4;
  // u, then the rows' 64-bit addresses (node * R * Dp passes 2^31 at 1M);
  // the fused estimate's xsq and id of the rows this lane stores
  const uint8_t* row[kU];
  unsigned valid = 0;
  float xs[kU];
  int id[kU];
  int m = row0 / R;
  int r = row0 - m * R;
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    row[k] = codes;
    xs[k] = 0.f;
    id[k] = -1;
    if (row0 + k < MR) {
      const long long node =
          u != nullptr ? clamp_node(__ldg(u + b * M + m), C) : b;
      const long long nr = node * R + r;
      row[k] = codes + nr * Dp;
      valid |= 1u << k;
      if (kFused && (k & (G - 1)) == gl) {
        xs[k] = __ldg(ep.xsq + nr);
        id[k] = __ldg(ep.nbr_ids + nr);
      }
    }
    if (++r == R) {
      r = 0;
      ++m;
    }
  }
  float acc[kU];
  if constexpr (kCPL == 0) {
    byte_dots<kU, true>(row, valid, qs + b * Dp, Dp, G, gl, acc);
  } else {
    // every row load first, then qs, then the products
    uint4 v[kU][kC];
    load_rows<kC, kU, true>(row, valid, nchunks, G, gl, v);
    uint4 qp[kC][2];
    load_q<kC>(qs + b * Dp, nchunks, G, gl, qp);
    dots<kC, kU>(v, qp, valid, nchunks, G, gl, acc);
  }
  butterfly(acc, G);
  const float qc = kFused ? __ldg(ep.qconst + b) : 0.f;
  const long long o = b * MR + row0;
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    if ((k & (G - 1)) == gl && ((valid >> k) & 1u)) {
      if (kFused) {
        out[o + k] = estimate(ep, qc, acc[k], xs[k]);
        ep.ids[o + k] = id[k];
      } else {
        out[o + k] = acc[k];
      }
    }
  }
}

// ---- bulk: TMA 1-D copies into a ring of shared-memory stages
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :
               : "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n"
      :
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :
      : "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int kCPL, bool kFused>
__global__ void __launch_bounds__(kThreads)
gather_bulk_kernel(const uint8_t* __restrict__ codes,
                   const int* __restrict__ u,
                   const __nv_bfloat16* __restrict__ qs,
                   float* __restrict__ out, long long C, int M, int R, int Dp,
                   int lg_g, int T, long long items, long long per_cta,
                   int stage_bytes, Estimate ep) {
  constexpr int kU = kCPL == 0 ? kInFlight : kInFlight / kCPL;
  constexpr int kC = kCPL > 0 ? kCPL : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int* nodes = reinterpret_cast<int*>(smem + kBarrierBytes);
  uint8_t* stages = smem + kBarrierBytes + kNodeBytes;
  const long long i0 = blockIdx.x * per_cta;
  const long long i1 = i0 + per_cta < items ? i0 + per_cta : items;
  if (i0 >= i1) {
    return;
  }
  const int G = 1 << lg_g;
  const int gl = threadIdx.x & (G - 1);
  const int grp = threadIdx.x >> lg_g;
  const int groups = blockDim.x >> lg_g;
  const int lane = threadIdx.x & 31;
  const int nchunks = Dp >> 4;
  const int per_query = (M + T - 1) / T;
  const long long blk = static_cast<long long>(R) * Dp;
  const int MR = M * R;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp 0 moves an item's pops, one bulk copy each, all on the stage's
  // barrier, and keeps their clamped node ids in the item's node buffer
  // (kStages + 1 of them: the item in flight longest never shares one with
  // the item being computed). Each lane holds up to kMaxPops / 32 ids of
  // the next item, loaded before the compute so that its copies do not
  // wait on u.
  constexpr int kPerLane = kMaxPops / 32;
  auto fetch = [&](long long item, int (&nxt)[kPerLane]) {
    const long long b = item / per_query;
    const int m0 = static_cast<int>(item - b * per_query) * T;
    const int n = M - m0 < T ? M - m0 : T;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int p = lane + 32 * t;
      nxt[t] = p < n ? __ldg(u + b * M + m0 + p) : 0;
    }
  };
  auto start_copies = [&](long long item, int slot, const int (&nxt)[kPerLane]) {
    const long long b = item / per_query;
    const int m0 = static_cast<int>(item - b * per_query) * T;
    const int n = M - m0 < T ? M - m0 : T;
    int* nb = nodes + ((item - i0) % (kStages + 1)) * kMaxPops;
    if (lane == 0) {
      mbar_expect_tx(full + slot, static_cast<uint32_t>(n * blk));
    }
    __syncwarp();
    uint8_t* dst = stages + static_cast<long long>(slot) * stage_bytes;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      const int p = lane + 32 * t;
      if (p < n) {
        const long long node = clamp_node(nxt[t], C);
        nb[p] = static_cast<int>(node);
        bulk_copy(dst + p * blk, codes + node * blk,
                  static_cast<uint32_t>(blk), full + slot);
      }
    }
  };
  int nxt[kPerLane];
  if (threadIdx.x < 32) {
    for (int s = 0; s < kStages && i0 + s < i1; ++s) {
      fetch(i0 + s, nxt);
      start_copies(i0 + s, s, nxt);
    }
  }
  __syncthreads();   // the first items' node buffers

  long long cur_b = -1;
  uint4 qp[kC][2];
  float qc = 0.f;
  for (long long j = 0; i0 + j < i1; ++j) {
    const long long item = i0 + j;
    const int slot = static_cast<int>(j % kStages);
    const long long b = item / per_query;
    const int m0 = static_cast<int>(item - b * per_query) * T;
    const int nrows = (M - m0 < T ? M - m0 : T) * R;
    const __nv_bfloat16* qb = qs + b * Dp;
    if (b != cur_b) {   // qs[b] and qconst[b] stay in registers for its items
      if (kCPL > 0) {
        load_q<kC>(qb, nchunks, G, gl, qp);
      }
      qc = kFused ? __ldg(ep.qconst + b) : 0.f;
      cur_b = b;
    }
    const bool more = i0 + j + kStages < i1;
    if (threadIdx.x < 32 && more) {
      fetch(i0 + j + kStages, nxt);
    }
    const int* nb = nodes + (j % (kStages + 1)) * kMaxPops;
    const uint8_t* st = stages + static_cast<long long>(slot) * stage_bytes;
    for (int base = 0; base < nrows; base += groups * kU) {
      // rows interleaved over the groups: row grp + k * groups
      const uint8_t* row[kU];
      unsigned valid = 0;
      float xs[kU];
      int id[kU];
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int i = base + grp + k * groups;
        row[k] = st + static_cast<long long>(i) * Dp;
        xs[k] = 0.f;
        id[k] = -1;
        if (i < nrows) {
          valid |= 1u << k;
          if (kFused && (k & (G - 1)) == gl) {   // before the stage's wait
            const int m = i / R;
            const long long nr =
                static_cast<long long>(nb[m]) * R + (i - m * R);
            xs[k] = __ldg(ep.xsq + nr);
            id[k] = __ldg(ep.nbr_ids + nr);
          }
        }
      }
      if (base == 0) {
        mbar_wait(full + slot, static_cast<uint32_t>((j / kStages) & 1));
      }
      float acc[kU];
      if constexpr (kCPL == 0) {
        byte_dots<kU, false>(row, valid, qb, Dp, G, gl, acc);
      } else {
        uint4 v[kU][kC];
        load_rows<kC, kU, false>(row, valid, nchunks, G, gl, v);
        dots<kC, kU>(v, qp, valid, nchunks, G, gl, acc);
      }
      butterfly(acc, G);
      const long long o = b * MR + static_cast<long long>(m0) * R;
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int i = base + grp + k * groups;
        if ((k & (G - 1)) == gl && ((valid >> k) & 1u)) {
          if (kFused) {
            out[o + i] = estimate(ep, qc, acc[k], xs[k]);
            ep.ids[o + i] = id[k];
          } else {
            out[o + i] = acc[k];
          }
        }
      }
    }
    __syncthreads();   // every thread is done with this stage
    if (threadIdx.x < 32 && more) {
      start_copies(i0 + j + kStages, slot, nxt);
    }
  }
}

// ---- host side
struct Shape {
  long long C, B, M, R, Dp;
};

// 16-byte slices a lane covers and the lanes of a row: G = min(Dp/16, 16)
// rounded down to a power of two; cpl 0 is the byte path (G = 8)
void plan(const Shape& s, int vec, int* lg_g, int* cpl) {
  if (!vec) {
    *lg_g = kByteLanesLog;
    *cpl = 0;
    return;
  }
  const long long chunks = s.Dp / 16;
  if (chunks > 16 * kInFlight) {   // more than 8 slices a lane: byte loads
    *lg_g = kByteLanesLog;
    *cpl = 0;
    return;
  }
  int lg = 0;
  while (lg < 4 && (2LL << lg) <= chunks) {
    ++lg;
  }
  const long long per_lane = (chunks + (1LL << lg) - 1) >> lg;
  *lg_g = lg;
  *cpl = per_lane <= 1 ? 1 : per_lane <= 2 ? 2 : per_lane <= 4 ? 4 : 8;
}

int sm_count() {
  static int cached[kMaxDevices] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) {
    return -static_cast<int>(err);
  }
  if (device < kMaxDevices && cached[device] > 0) {
    return cached[device];
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) {
    return -static_cast<int>(err);
  }
  if (device < kMaxDevices) {
    cached[device] = sms;
  }
  return sms;
}

template <int kCPL, bool kFused>
int launch_rows(const Shape& s, const void* codes, const void* u,
                const void* qs, void* out, int lg_g, const Estimate& ep,
                cudaStream_t stream) {
  constexpr int kU = kCPL == 0 ? kInFlight : kInFlight / kCPL;
  const long long MR = s.M * s.R;
  const long long groups = (MR + kU - 1) / kU;
  long long threads = ((groups << lg_g) + 31) / 32 * 32;
  if (threads > kThreads) {
    threads = kThreads;
  }
  const int rows_cta = static_cast<int>((threads >> lg_g) * kU);
  const long long slices = (MR + rows_cta - 1) / rows_cta;
  if (slices > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(s.B), static_cast<unsigned>(slices));
  gather_rows_kernel<kCPL, kFused>
      <<<grid, static_cast<unsigned>(threads), 0, stream>>>(
          static_cast<const uint8_t*>(codes), static_cast<const int*>(u),
          static_cast<const __nv_bfloat16*>(qs), static_cast<float*>(out),
          s.C, static_cast<int>(s.M), static_cast<int>(s.R),
          static_cast<int>(s.Dp), lg_g, rows_cta, ep);
  return static_cast<int>(cudaGetLastError());
}

template <int kCPL, bool kFused>
int launch_bulk(const Shape& s, const void* codes, const void* u,
                const void* qs, void* out, int lg_g, const Estimate& ep,
                cudaStream_t stream) {
  const long long blk = s.R * s.Dp;
  long long T = kStageTarget / blk;
  T = T < 1 ? 1 : (T > s.M ? s.M : T);
  T = T > kMaxPops ? kMaxPops : T;
  const long long stage_bytes = T * blk;
  const size_t smem = kBarrierBytes + kNodeBytes + kStages * stage_bytes;
  if (smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = gather_bulk_kernel<kCPL, kFused>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int sms = sm_count();
  if (sms <= 0) {
    return -sms;
  }
  long long per_sm = static_cast<long long>(kMaxSmem) / (smem + 1024);
  per_sm = per_sm < 1 ? 1 : (per_sm > 8 ? 8 : per_sm);
  const long long items = s.B * ((s.M + T - 1) / T);
  long long grid = sms * per_sm;
  grid = grid > items ? items : grid;
  const long long per_cta = (items + grid - 1) / grid;
  grid = (items + per_cta - 1) / per_cta;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int*>(u),
      static_cast<const __nv_bfloat16*>(qs), static_cast<float*>(out), s.C,
      static_cast<int>(s.M), static_cast<int>(s.R), static_cast<int>(s.Dp),
      lg_g, static_cast<int>(T), items, per_cta,
      static_cast<int>(stage_bytes), ep);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBulk, bool kFused>
int dispatch(const Shape& s, const void* codes, const void* u, const void* qs,
             void* out, int vec, const Estimate& ep, cudaStream_t stream) {
  int lg_g = 0, cpl = 0;
  plan(s, vec, &lg_g, &cpl);
#define ALAYA_GATHER_CASE(N)                                               \
  case N:                                                                  \
    return kBulk ? launch_bulk<N, kFused>(s, codes, u, qs, out, lg_g, ep,  \
                                          stream)                          \
                 : launch_rows<N, kFused>(s, codes, u, qs, out, lg_g, ep,  \
                                          stream);
  switch (cpl) {
    ALAYA_GATHER_CASE(0)
    ALAYA_GATHER_CASE(1)
    ALAYA_GATHER_CASE(2)
    ALAYA_GATHER_CASE(4)
    ALAYA_GATHER_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ALAYA_GATHER_CASE
}

template <bool kBulk>
int entry(const void* codes, const void* u, const void* qs, void* out,
          long long C, long long B, long long M, long long R, long long Dp,
          int vec, const void* qconst, const void* xsq, const void* nbr_ids,
          void* ids, float coef, int clamp, void* stream) {
  if (B == 0 || M == 0 || R == 0 || C == 0) {
    return 0;
  }
  const Shape s{C, B, M, R, Dp};
  const Estimate ep{static_cast<const float*>(qconst),
                    static_cast<const float*>(xsq),
                    static_cast<const int*>(nbr_ids), static_cast<int*>(ids),
                    coef, clamp};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return qconst ? dispatch<kBulk, true>(s, codes, u, qs, out, vec, ep, st)
                : dispatch<kBulk, false>(s, codes, u, qs, out, vec, ep, st);
}

}  // namespace

// out = the dots, or (qconst != null) the fused estimate with ids; vec: 16-
// byte loads of codes and qs
extern "C" int alaya_gather_diagdot_rows(
    const void* codes, const void* u, const void* qs, void* out, long long C,
    long long B, long long M, long long R, long long Dp, int vec,
    const void* qconst, const void* xsq, const void* nbr_ids, void* ids,
    float coef, int clamp, void* stream) {
  return entry<false>(codes, u, qs, out, C, B, M, R, Dp, vec, qconst, xsq,
                      nbr_ids, ids, coef, clamp, stream);
}

// block_diagdot: the rows entry with the identity gather, codes [B, K, Dp]
// read as B nodes of K rows; vec: 16-byte loads of codes and qs
extern "C" int alaya_block_diagdot(const void* codes, const void* qs,
                                   void* out, long long B, long long K,
                                   long long Dp, int vec, void* stream) {
  return entry<false>(codes, nullptr, qs, out, B, B, 1, K, Dp, vec, nullptr,
                      nullptr, nullptr, nullptr, 0.f, 0, stream);
}

// the same through TMA bulk copies; needs R*Dp % 16 == 0 and 16-byte aligned
// codes (the wrapper checks); vec: 16-byte reads of the staged rows and qs
extern "C" int alaya_gather_diagdot_bulk(
    const void* codes, const void* u, const void* qs, void* out, long long C,
    long long B, long long M, long long R, long long Dp, int vec,
    const void* qconst, const void* xsq, const void* nbr_ids, void* ids,
    float coef, int clamp, void* stream) {
  return entry<true>(codes, u, qs, out, C, B, M, R, Dp, vec, qconst, xsq,
                     nbr_ids, ids, coef, clamp, stream);
}
