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
// what it computes: the bf16 x bf16 products on the tensor cores, f32 sums,
// so only the order of the sums differs. Its (256, 512) blocks and
// multiple-of-128 shapes are not carried over: any Q, N and D, ragged
// edges masked, D zero-padded to a multiple of 64 in shared memory (a
// padded slot holds bf16 0 in both operands).
//
// Bound: bytes. At (Q=4096, N=65536, D=128) the kernel must move 1,084 MB
// (the [Q, N] f32 output is 1,074 MB of it), 0.324 ms at 3.35 TB/s, against
// 68.7 GFLOP that the bf16 tensor cores do in 0.070 ms. So the product
// goes to wgmma (m64n128k16, bf16 in, f32 accumulate, both operands read
// from shared memory, no swizzle) and the kernel's time is its stores.
// The design keeps every other step short and overlapped:
//   - two warpgroups (256 threads) per block share one decoded code tile:
//     each owns 64 of the block's 128 query rows, held as bf16(q * scale)
//     in shared memory for all of D (D <= 256: "resident"; past that the
//     rows are staged slice by slice beside the codes, in three stages of
//     their own: at D = 128 that leaves room for one block per SM instead
//     of two, and measured 1.9x slower on an H100). A block walks every
//     gridDim.x-th 128-row code tile, so a query row is staged a few dozen
//     times, and blocks running side by side write neighbouring tiles;
//   - the queries are the A operand and the codes the B operand: the
//     accumulator then holds, in each thread, pairs of neighbouring output
//     columns of one row, stored straight from the registers as float2
//     (whole 32-byte sectors). Codes as a register A operand would put
//     code rows on the accumulator's rows and make every store a column;
//     staging the tile through shared memory for 16-byte or bulk stores,
//     16-byte stores built by a shuffle between lane pairs, and streaming
//     (.cs) stores all measured slower: the extra pass, the lower
//     occupancy or the shuffles cost more than the store shape gains;
//   - the code bytes arrive by cp.async, two 64-wide slices of D ahead,
//     into a ring that each thread reads back only where it copied
//     (16 bytes of a row, four threads a row: a warp's copies cover eight
//     rows); it decodes them to bf16 (c - 128) with a byte permute and one
//     add (2^23 + c as an f32, minus 2^23 + 128) into three stages in the
//     core-matrix layout wgmma reads, one slice ahead: the next slice (the
//     next tile's first, at a tile's end) is decoded while the tensor cores
//     run this one, with one barrier a slice. Every slice is a whole 64
//     columns, so the four k16 steps of a slice are unrolled, their
//     descriptors fixed at compile time for each layout (a template
//     argument), and the warpgroup issues its wgmma chain on a path the
//     compiler sees as uniform (no wgmma serialization, ptxas C7520);
//   - qconst is summed by the threads that stage the query rows, once per
//     row and block; xsq by a first small kernel (xsq_kernel), once per code
//     row, into the caller's scratch, so the decode does no arithmetic past
//     the conversion. The epilogue clamps at 0 and stores each output once.
// Two blocks fit an SM (128 registers a thread, ~106 KB of shared memory);
// one block per SM with a producer warpgroup and two consumers measured
// slower.
//
// Plain C entry point for ctypes; returns cudaGetLastError() after launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // two warpgroups
constexpr int kBM = 128;        // query rows per block: wgmma's M twice
constexpr int kBN = 128;        // code rows per tile: wgmma's N
constexpr int kKC = 64;         // slice of D per stage
constexpr int kResidentDp = 256;  // longest padded D kept whole in smem
constexpr int kStageBytesB = kBN * kKC * 2;
constexpr int kStageBytesA = kBM * kKC * 2;
constexpr int kStages = 3;      // staged slices: one in the product, one
                                // being written, one finishing
// raw code bytes of a slice, one 16-byte segment per thread and row half
constexpr int kRingHalf = kThreads * 16;
constexpr int kRingStage = 2 * kRingHalf;
constexpr int kRingStages = 3;  // slices in flight: two ahead of the decode
constexpr int kXsqThreads = 256;

// shared-memory matrix descriptor: K-major, no swizzle; lbo = bytes between
// the two core matrices along K of a k16 step, sbo = bytes between 8-row
// groups
__device__ __forceinline__ uint64_t descriptor(const uint8_t* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// d[64] (+)= A[64 x 16] * B[128 x 16]^T, asynchronously
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// 16 bytes from device memory to shared memory, asynchronously; zeros
// where !ok
__device__ __forceinline__ void cp_async16(uint8_t* dst, const uint8_t* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    asm volatile("" : "+f"(d[i])::"memory");
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// eight query values [k0, k0 + 8) of a row, 0 past D or for a masked row
template <bool kVec>
__device__ __forceinline__ void load_q8(const float* __restrict__ row,
                                        bool ok, int k0, int D,
                                        float (&v)[8]) {
  if (kVec) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 b = a;
    if (ok && k0 < D) {  // D % 16 == 0: the eight are wholly in or out
      a = __ldg(reinterpret_cast<const float4*>(row + k0));
      b = __ldg(reinterpret_cast<const float4*>(row + k0 + 4));
    }
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] = (ok && k0 + e < D) ? __ldg(row + k0 + e) : 0.f;
    }
  }
}

// sixteen code bytes [k0, k0 + 16) of a row, little-endian in four words
template <bool kVec>
__device__ __forceinline__ uint4 load_c16(const uint8_t* __restrict__ row,
                                          bool ok, int k0, int D) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (kVec) {
    if (ok && k0 < D) {
      v = __ldg(reinterpret_cast<const uint4*>(row + k0));
    }
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const uint32_t c = (ok && k0 + e < D) ? __ldg(row + k0 + e) : 0u;
      w[e >> 2] |= c << (8 * (e & 3));
    }
    v = make_uint4(w[0], w[1], w[2], w[3]);
  }
  return v;
}

// Stage the 8-wide groups kb = half, half + 2, ... < nkb of one query row
// (D offset k0) as bf16(q * scale) at row `row` of a core-matrix tile whose
// 8-row groups are sbo bytes apart; returns this thread's qconst terms.
template <bool kVec>
__device__ __forceinline__ float stage_q(const float* __restrict__ qrow,
                                         bool ok, int D, int k0, int nkb,
                                         const float* sc, const float* sh,
                                         uint8_t* dst, int sbo, int row,
                                         int half) {
  float qc = 0.f;
  for (int kb = half; kb < nkb; kb += 2) {
    const int k = k0 + kb * 8;
    float v[8];
    load_q8<kVec>(qrow, ok, k, D, v);
    uint32_t p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = v[2 * e], b = v[2 * e + 1];
      qc += a * a - 2.f * a * sh[k + 2 * e];
      qc += b * b - 2.f * b * sh[k + 2 * e + 1];
      p[e] = pack_bf16(a * sc[k + 2 * e], b * sc[k + 2 * e + 1]);
    }
    *reinterpret_cast<uint4*>(dst + (row >> 3) * sbo + kb * 128 +
                              (row & 7) * 16) =
        make_uint4(p[0], p[1], p[2], p[3]);
  }
  return qc;
}

// Decode one 16-column segment of code rows n and 64 + n of a tile (D
// offset k, stage column k - k0) to bf16 (c - 128) into a [kBN x kKC]
// stage. Four neighbouring threads hold the four segments of a row's
// 64-byte slice, so a warp's 16-byte copies cover eight rows' slices.
template <bool kVec>
__device__ __forceinline__ void stage_codes(const uint8_t* __restrict__ codes,
                                            long long N, int D, long long j0,
                                            int n, int k, int col,
                                            const uint8_t* ring,
                                            uint8_t* dst) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = n + 64 * h;
    uint4 raw;
    if (kVec) {  // the bytes this thread's cp.async brought
      raw = *reinterpret_cast<const uint4*>(ring + h * kRingHalf);
    } else {
      const bool ok = j0 + r < N;
      raw = load_c16<kVec>(codes + (ok ? j0 + r : 0) * D, ok, k, D);
    }
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t p[8];
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      float cf[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = e + u;
        // 2^23 + c as an f32, minus 2^23 + 128: c - 128 exactly
        const float v = __uint_as_float(__byte_perm(w[i >> 2], 0x4B000000u,
                                                    0x7540u | (i & 3))) -
                        8388736.f;
        // kVec: D % 16 == 0, a segment lies wholly inside or past D
        cf[u] = (kVec ? k < D : k + i < D) ? v : 0.f;
      }
      p[e >> 1] = pack_bf16(cf[0], cf[1]);
    }
    uint8_t* at = dst + (r >> 3) * 1024 + (col >> 3) * 128 + (r & 7) * 16;
    *reinterpret_cast<uint4*>(at) = make_uint4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<uint4*>(at + 128) = make_uint4(p[4], p[5], p[6], p[7]);
  }
}

// xsq[j] = sum_d ((c[j, d] - 128) scale[d] + shift[d])^2 in f32, once per
// code row: eight threads a row (16-byte loads, a warp's covering four
// rows' 128 bytes), scale and shift staged in shared memory ([D] each,
// dynamic).
template <bool kVec>
__global__ void __launch_bounds__(kXsqThreads)
xsq_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ dmin,
           const float* __restrict__ scale, float* __restrict__ xsq,
           long long N, int D) {
  extern __shared__ float ss[];
  float* sh = ss + D;
  for (int d = threadIdx.x; d < D; d += kXsqThreads) {
    const float s = __ldg(scale + d);
    ss[d] = s;
    sh[d] = __ldg(dmin + d) + 128.f * s;
  }
  __syncthreads();
  const long long j =
      static_cast<long long>(blockIdx.x) * (kXsqThreads / 8) +
      (threadIdx.x >> 3);
  const int part = threadIdx.x & 7;
  const uint8_t* row = codes + (j < N ? j : 0) * D;
  float acc = 0.f;
  if (j < N) {
    if (kVec) {  // D % 16 == 0, rows 16-byte aligned
      for (int d = 16 * part; d < D; d += 128) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + d));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const float c = static_cast<float>(
              static_cast<int>((w[u >> 2] >> (8 * (u & 3))) & 0xFFu));
          const float xh = fmaf(c - 128.f, ss[d + u], sh[d + u]);
          acc = fmaf(xh, xh, acc);
        }
      }
    } else {
      for (int d = part; d < D; d += 8) {
        const float c = static_cast<float>(static_cast<int>(__ldg(row + d)));
        const float xh = fmaf(c - 128.f, ss[d], sh[d]);
        acc = fmaf(xh, xh, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (j < N && part == 0) {
    xsq[j] = acc;
  }
}

// The epilogue of one tile: accumulator register 4 jn + 2 h + e is row
// 16 warp + lane / 4 + 8 h of warpgroup g's rows, column 8 jn + 2 (lane % 4)
// + e of the tile; out = max(qconst - 2 dot + xsq, 0), stored as float2
// (whole 32-byte sectors) where the pair lies inside N and is aligned.
__device__ __forceinline__ void store_tile(const float (&acc)[64],
                                           const float* xsb,
                                           const float* qc_s,
                                           float* __restrict__ out,
                                           long long i0, long long j0,
                                           long long Q, long long N,
                                           int vec_out, int g, int warp,
                                           int lane) {
  const bool full = vec_out && j0 + kBN <= N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * g + warp * 16 + (lane >> 2) + 8 * h;
    const long long gi = i0 + r;
    if (gi < Q) {
      const float qci = qc_s[r];
      float* orow = out + gi * N;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        const int col = jn * 8 + 2 * (lane & 3);
        const long long gj = j0 + col;
        const float2 x = *reinterpret_cast<const float2*>(xsb + col);
        const float v0 =
            fmaxf(fmaf(-2.f, acc[4 * jn + 2 * h], qci + x.x), 0.f);
        const float v1 =
            fmaxf(fmaf(-2.f, acc[4 * jn + 2 * h + 1], qci + x.y), 0.f);
        if (full || (vec_out && gj + 1 < N)) {
          *reinterpret_cast<float2*>(orow + gj) = make_float2(v0, v1);
        } else {
          if (gj < N) {
            orow[gj] = v0;
          }
          if (gj + 1 < N) {
            orow[gj + 1] = v1;
          }
        }
      }
    }
  }
}

// Shared memory, in order: the query rows (kResident: [kBM x Dp]; else
// kStages [kBM x kKC] stages), kStages [kBN x kKC] code stages, (kVec) the
// ring of raw code bytes, scale and shift [Dp] (0 past D), qconst [kBM],
// the tile's xsq [2][kBN] (by tile parity). Dp is D padded to kKC.
template <bool kVec, bool kResident>
__global__ void __launch_bounds__(kThreads, 2)
sq8_tile_kernel(const float* __restrict__ q, const uint8_t* __restrict__ codes,
                const float* __restrict__ dmin,
                const float* __restrict__ scale,
                const float* __restrict__ xsq, float* __restrict__ out,
                long long Q, long long N, int D, int Dp, int tiles,
                int vec_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* qs = smem;
  uint8_t* cs = qs + (kResident ? kBM * Dp * 2 : kStages * kStageBytesA);
  uint8_t* ring = cs + kStages * kStageBytesB;
  float* sc = reinterpret_cast<float*>(ring + (kVec ? kRingStages * kRingStage
                                                    : 0));
  float* sh = sc + Dp;
  float* qc_s = sh + Dp;
  float* xs_s = qc_s + kBM;

  const int tid = threadIdx.x;
  const long long i0 = static_cast<long long>(blockIdx.y) * kBM;
  for (int d = tid; d < Dp; d += kThreads) {
    const float s = d < D ? __ldg(scale + d) : 0.f;
    sc[d] = s;
    sh[d] = d < D ? __ldg(dmin + d) + 128.f * s : 0.f;
  }
  __syncthreads();

  // staging role for the queries: row qr, every other 8-wide group
  const int qr = tid >> 1;
  const int half = tid & 1;
  const bool qok = i0 + qr < Q;
  const float* qrow = q + (qok ? i0 + qr : 0) * D;
  float qc = 0.f;
  if (kResident) {
    qc = stage_q<kVec>(qrow, qok, D, 0, Dp / 8, sc, sh, qs, Dp * 16, qr, half);
    qc += __shfl_xor_sync(0xffffffffu, qc, 1);
    if (half == 0) {
      qc_s[qr] = qc;
    }
  }

  // decoding role for the codes: rows cn and 64 + cn, segment cseg
  const int cn = tid >> 2;
  const int cseg = tid & 3;
  // product and epilogue: warpgroup g owns query rows [64 g, 64 g + 64)
  const int g = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int nch = Dp / kKC;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
  }
  // kVec: the raw bytes of flat slice f (tile f / nch, slice f % nch) go
  // to ring stage f % 3 by cp.async, two slices ahead of their decode;
  // each thread decodes only the segments it copied itself
  auto prefetch = [&](int f) {
    if (kVec) {
      const int tt = f / nch;
      const long long jj =
          (static_cast<long long>(tt) * gridDim.x + blockIdx.x) * kBN;
      const int kk = (f % nch) * kKC + cseg * 16;
      uint8_t* dst = ring + (f % kRingStages) * kRingStage + tid * 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = jj + cn + 64 * h;
        const bool ok = tt < tiles && r < N && kk < D;
        cp_async16(dst + h * kRingHalf, codes + (ok ? r * D + kk : 0), ok);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  };
  prefetch(0);
  prefetch(1);
  // the tiles this block walks: t * gridDim.x + blockIdx.x < tiles_n
  const long long tiles_n = (N + kBN - 1) / kBN;
  const int my_tiles = static_cast<int>(
      (tiles_n - blockIdx.x + gridDim.x - 1) / gridDim.x < tiles
          ? (tiles_n - blockIdx.x + gridDim.x - 1) / gridDim.x
          : tiles);
  const int slices = my_tiles * nch;
  // Stage flat slice f (tile f / nch, slice f % nch) into stage f % 3: the
  // code bytes decoded, and the query rows' slice when they are not
  // resident. Stage f % 3 was last read by slice f - 3's product.
  auto stage = [&](int f) {
    const int t = f / nch;
    const int c = f % nch;
    const long long j0 =
        (static_cast<long long>(t) * gridDim.x + blockIdx.x) * kBN;
    const int k0 = c * kKC;
    if (c == 0 && tid < kBN) {  // the tile's xsq, by tile parity
      xs_s[(t & 1) * kBN + tid] = j0 + tid < N ? __ldg(xsq + j0 + tid) : 0.f;
    }
    if (kVec) {
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    }
    stage_codes<kVec>(codes, N, D, j0, cn, k0 + cseg * 16, cseg * 16,
                      ring + (f % kRingStages) * kRingStage + tid * 16,
                      cs + (f % kStages) * kStageBytesB);
    prefetch(f + 2);
    if (!kResident) {
      qc += stage_q<kVec>(qrow, qok, D, k0, kKC / 8, sc, sh,
                          qs + (f % kStages) * kStageBytesA, kKC * 16, qr,
                          half);
      if (t == 0 && c == nch - 1) {
        qc += __shfl_xor_sync(0xffffffffu, qc, 1);
        if (half == 0) {
          qc_s[qr] = qc;
        }
      }
    }
    // the generic proxy's stores, then visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  if (slices > 0) {
    stage(0);
  }
  for (int f = 0; f < slices; ++f) {
    const int t = f / nch;
    const int c = f % nch;
    const int k0 = c * kKC;
    const uint8_t* abuf = kResident ? qs + g * 8 * Dp * 16 + k0 * 16
                                    : qs + (f % kStages) * kStageBytesA +
                                          g * 8 * kKC * 16;
    const uint8_t* cbuf = cs + (f % kStages) * kStageBytesB;
    __syncthreads();  // slice f staged by every thread
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kKC / 16; ++s) {
      // A: this warpgroup's 64 query rows, B: the tile's 128 code rows, at
      // column k0 + 16 s
      wgmma_m64n128k16(acc, descriptor(abuf + 2 * s * 128, 128,
                                       (kResident ? Dp : kKC) * 16),
                       descriptor(cbuf + 2 * s * 128, 128, kKC * 16),
                       (c > 0 || s > 0) ? 1 : 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // slice f - 1's product has finished in this warp; every warp passes
    // this point before the next barrier, after which stage (f + 2) % 3,
    // slice f - 1's, may be written
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (f + 1 < slices) {
      stage(f + 1);  // while the tensor cores run slice f
    }
    if (c == nch - 1) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);
      const long long j0 =
          (static_cast<long long>(t) * gridDim.x + blockIdx.x) * kBN;
      store_tile(acc, xs_s + (t & 1) * kBN, qc_s, out, i0, j0, Q, N,
                 vec_out, g, warp, lane);
    }
  }
  if (kVec) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
}

// Per device: the SM count and the dynamic shared memory each kernel
// instance was last allowed (xsq_kernel<vec> at [vec], sq8_tile_kernel<vec,
// resident> at [2 + 2 vec + resident]), so a call makes no CUDA runtime
// call but the launches.
constexpr int kMaxDevices = 64;

struct DeviceState {
  int sms = 0;
  size_t allowed[6] = {48 * 1024, 48 * 1024, 48 * 1024,
                       48 * 1024, 48 * 1024, 48 * 1024};
};

DeviceState g_state[kMaxDevices];

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) {
    allowed = smem;
  }
  return err;
}

struct Launch {
  const float* q;
  const uint8_t* codes;
  const float* dmin;
  const float* scale;
  float* xsq;
  float* out;
  long long Q, N;
  int D, Dp, tiles, vec_out;
  dim3 grid;
  unsigned xgrid;
  cudaStream_t stream;
};

template <bool kVec, bool kResident>
cudaError_t run(DeviceState& st, const Launch& a) {
  const size_t xsmem = 2 * static_cast<size_t>(a.D) * sizeof(float);
  const size_t smem =
      static_cast<size_t>(kResident ? kBM * a.Dp * 2 : kStages * kStageBytesA)
      + kStages * kStageBytesB + (kVec ? kRingStages * kRingStage : 0)
      + 2 * a.Dp * sizeof(float) + (kBM + 2 * kBN) * sizeof(float);
  cudaError_t err = allow_smem(xsq_kernel<kVec>, xsmem, st.allowed[kVec]);
  if (err == cudaSuccess) {
    err = allow_smem(sq8_tile_kernel<kVec, kResident>, smem,
                     st.allowed[2 + 2 * kVec + kResident]);
  }
  if (err != cudaSuccess) {
    return err;
  }
  xsq_kernel<kVec><<<a.xgrid, kXsqThreads, xsmem, a.stream>>>(
      a.codes, a.dmin, a.scale, a.xsq, a.N, a.D);
  sq8_tile_kernel<kVec, kResident><<<a.grid, kThreads, smem, a.stream>>>(
      a.q, a.codes, a.dmin, a.scale, a.xsq, a.out, a.Q, a.N, a.D, a.Dp,
      a.tiles, a.vec_out);
  return cudaGetLastError();
}

}  // namespace

// xsq is the caller's scratch of N floats; the two kernels run in turn on
// the stream.
extern "C" int alaya_sq8_tile(const void* q, const void* codes,
                              const void* dmin, const void* scale, void* xsq,
                              void* out, long long Q, long long N, long long D,
                              int vec_in, void* stream) {
  if (Q == 0 || N == 0) {
    return 0;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= kMaxDevices) {
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  }
  DeviceState& st = g_state[dev];
  if (st.sms == 0) {
    err = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  Launch a;
  a.q = static_cast<const float*>(q);
  a.codes = static_cast<const uint8_t*>(codes);
  a.dmin = static_cast<const float*>(dmin);
  a.scale = static_cast<const float*>(scale);
  a.xsq = static_cast<float*>(xsq);
  a.out = static_cast<float*>(out);
  a.Q = Q;
  a.N = N;
  a.D = static_cast<int>(D);
  a.Dp = static_cast<int>((D + kKC - 1) / kKC * kKC);
  // a run of code tiles per block: about 8 blocks per SM in all, so a
  // query row is staged N / (128 * tiles) times
  const long long tiles_n = (N + kBN - 1) / kBN;
  const long long gy = (Q + kBM - 1) / kBM;
  long long gx = (8LL * st.sms + gy - 1) / gy;
  gx = gx < 1 ? 1 : (gx > tiles_n ? tiles_n : gx);
  const long long tiles = (tiles_n + gx - 1) / gx;
  gx = (tiles_n + tiles - 1) / tiles;
  a.tiles = static_cast<int>(tiles);
  a.grid = dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  a.xgrid = static_cast<unsigned>((N + kXsqThreads / 8 - 1) /
                                  (kXsqThreads / 8));
  a.vec_out =
      (N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0) ? 1 : 0;
  a.stream = static_cast<cudaStream_t>(stream);
  const bool resident = a.Dp <= kResidentDp;
  if (vec_in) {
    err = resident ? run<true, true>(st, a) : run<true, false>(st, a);
  } else {
    err = resident ? run<false, true>(st, a) : run<false, false>(st, a);
  }
  return static_cast<int>(err);
}
