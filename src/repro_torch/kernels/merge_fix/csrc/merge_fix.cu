// merge_fix: the fused merge_and_fix tail (DMA Steps 3-4, Lemma 6).  From
// the merged edge activations (t0, t1, s, r) and the sorted interval
// boundaries `events` (K + 1 of them), it computes per interval k
//   alpha_k = max over the 2m ports of the number of active edges, and
//   delta_k = (events[k+1] - events[k]) * max(alpha_k, 1),
// the expanded durations whose cumsum is merge_and_fix's `exp`.
//
// Replaces the TPU path src/repro/kernels/merge_fix/ops.py::merge_fix_step,
// which chains a host searchsorted, build_delta, the coflow_merge Pallas
// kernel (coflow_merge_padded) and the duration product.  Here the whole
// chain is hand-written launches on one stream, with no host step between:
//   1. a memset of the (K + 1, 2m) int32 delta array;
//   2. bin_scatter: one thread per edge does a lower-bound search of t0
//      and t1 in `events` (numpy's searchsorted, side='left') and four
//      int32 atomicAdds (+1/-1 at the start/end interval, sender column s
//      and receiver column m + r).  Integer atomics are exact in any order;
//   3. the three-pass scan of merge_scan.cuh (shared with coflow_merge),
//      whose epilogue writes alpha and the duration as int64: the product
//      in int64 equals both branches of the reference (int32 in-graph when
//      it fits, host int64 otherwise).
//
// Bound on the card: memory.  The function reads events (K + 1 int64) and
// the edges (4E int64) once and writes 2K int64; this design also writes
// the delta array (memset, scattered atomics) and reads it twice in the
// scan, so at the main path's shapes (K ~ 1e4, 2m = 300, 4 bytes a count)
// the delta traffic dominates.  Counts are int32 and exact while the number
// of edge activations is below 2^31 - 1 (the wrapper's guard); offsets are
// 64-bit.  An activation time outside `events` (not produced by
// merge_and_fix) is dropped, as JAX drops an out-of-range scatter.

#include "../../coflow_merge/csrc/merge_scan.cuh"

namespace {

__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ ev,
                                               int64_t n, int64_t x) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (ev[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void bin_scatter(const int64_t* __restrict__ events, int64_t K,
                            const int64_t* __restrict__ t0,
                            const int64_t* __restrict__ t1,
                            const int64_t* __restrict__ s,
                            const int64_t* __restrict__ r, int64_t E, int m,
                            int32_t* __restrict__ delta) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int64_t P = 2 * static_cast<int64_t>(m);
  const int64_t si = lower_bound(events, K + 1, t0[e]);
  const int64_t ei = lower_bound(events, K + 1, t1[e]);
  const int64_t ps = s[e], pr = m + r[e];
  if (si <= K) {
    atomicAdd(&delta[si * P + ps], 1);
    atomicAdd(&delta[si * P + pr], 1);
  }
  if (ei <= K) {
    atomicAdd(&delta[ei * P + ps], -1);
    atomicAdd(&delta[ei * P + pr], -1);
  }
}

struct StoreFix {
  const int64_t* events;
  int64_t* alphas;
  int64_t* deltas;
  __device__ void operator()(int64_t k, int32_t alpha) const {
    alphas[k] = alpha;
    deltas[k] = (events[k + 1] - events[k]) * static_cast<int64_t>(max(alpha, 1));
  }
};

}  // namespace

// events: (K + 1,) int64; t0, t1, s, r: (E,) int64; delta: (K + 1) * 2m
// int32 scratch; totals: ceil(K / 32) * 2m int32 scratch; alphas, deltas:
// (K,) int64.  Returns the first CUDA error, or 0.
extern "C" int merge_fix_launch(void* events, long long K, void* t0, void* t1,
                                void* s, void* r, long long E, int m,
                                void* delta, void* totals, void* alphas,
                                void* deltas, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = 2 * m;
  int32_t* dl = static_cast<int32_t*>(delta);
  cudaError_t e = cudaMemsetAsync(
      dl, 0, static_cast<size_t>(K + 1) * P * sizeof(int32_t), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t* ev = static_cast<const int64_t*>(events);
  if (E > 0) {
    const int threads = 256;
    bin_scatter<<<static_cast<unsigned>((E + threads - 1) / threads), threads,
                  0, st>>>(ev, K, static_cast<const int64_t*>(t0),
                           static_cast<const int64_t*>(t1),
                           static_cast<const int64_t*>(s),
                           static_cast<const int64_t*>(r), E, m, dl);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(merge_scan::scan(
      dl, K, P, static_cast<int32_t*>(totals),
      StoreFix{ev, static_cast<int64_t*>(alphas),
               static_cast<int64_t*>(deltas)},
      st));
}
