// ring_probe: row-wise membership test of the block hop's stale check,
// written for Hopper (sm_90a).
//
//   out[b, k] = any_j (nids[b, k] == seen[b, j])
//   nids i32 [B, K], seen i32 [B, S] -> out u8 [B, K] (0 or 1)
//
// Replaces the TPU kernel scripts/proto_pallas_sort2.py:105
// (ring_probe_kernel). That kernel holds the ids as [K, BT] and the ring as
// [RING, BT] so the query index rides the TPU's lanes; the layout is not
// part of the function, and here both operands are row-major per query.
// -1 equals -1, as in the broadcast compare this replaces; the callers mask
// nids >= 0 afterwards.
//
// Bound: memory, by the bytes that must move (nids and seen read once, one
// byte written per id): at the search's shape (B=4096, K=256, S=160) that
// is 7.9 MB, ~2.3 us at 3.35 TB/s, against 168 M integer compares. The
// eager version builds a [B, K, S] bool tensor in device memory and reduces
// it, moving ~340 MB per hop. The design keeps the compare on chip:
//   - one block per (query b, tile of kThreads ids);
//   - seen[b] is staged once per block in shared memory (int4 loads where
//     the row is 16-byte aligned);
//   - each thread owns one id and walks seen[b] four entries per step, all
//     threads of a warp reading the same shared word (a broadcast);
//   - the row tail is padded in shared memory with the row's first entry,
//     which cannot change the answer, so the walk has no ragged step.
//
// Plain C entry point for ctypes; returns cudaGetLastError() after launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ring_probe_kernel(const int* __restrict__ nids, const int* __restrict__ seen,
                  uint8_t* __restrict__ out, long long K, int S, int S4,
                  int vec) {
  extern __shared__ __align__(16) int seen_s[];
  const long long b = blockIdx.x;
  const int* row = seen + b * S;
  if (vec) {  // S % 4 == 0 and a 16-byte aligned base
    const int4* row4 = reinterpret_cast<const int4*>(row);
    int4* dst4 = reinterpret_cast<int4*>(seen_s);
    for (int j = threadIdx.x; j < S / 4; j += kThreads) {
      dst4[j] = __ldg(row4 + j);
    }
  } else {
    for (int j = threadIdx.x; j < S; j += kThreads) {
      seen_s[j] = __ldg(row + j);
    }
  }
  // pad to a multiple of 4 with a value that is in the row already
  if (threadIdx.x < S4 - S) {
    seen_s[S + threadIdx.x] = __ldg(row);
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

}  // namespace

extern "C" int alaya_ring_probe(const void* nids, const void* seen, void* out,
                                long long B, long long K, long long S,
                                int vec, void* stream) {
  if (B == 0 || K == 0) {
    return 0;
  }
  const int S4 = static_cast<int>((S + 3) / 4 * 4);
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
      static_cast<uint8_t*>(out), K, static_cast<int>(S), S4, vec);
  return static_cast<int>(cudaGetLastError());
}
