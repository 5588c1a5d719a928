// coflow_merge: alpha per merged interval (DMA Steps 3-4, Lemma 6).  Given
// the (K, P) int32 array of per-interval per-port activation deltas
// (P = 2m ports: m senders then m receivers), alpha[k] is the max over
// ports of the running count sum_{k' <= k} delta[k', p].
//
// Replaces the TPU kernel src/repro/kernels/coflow_merge/coflow_merge.py
// (_merge_kernel, launched by coflow_merge_padded).  The TPU walks the
// interval axis as a sequential grid and carries the running counts from
// one grid step to the next in VMEM scratch.  Blocks of a CUDA grid run in
// no order, so the carry becomes the three-pass block-sum scan of
// merge_scan.cuh (column totals per block, a segmented exclusive scan of
// the totals per port, a re-scan of each block from its carry with a warp
// max per row), shared with merge_fix.  The epilogue here stores alpha as
// int32.  The TPU's padding of 2m to 128 lanes is not needed and is gone.
//
// Bound on the card: memory.  The function reads K * P int32 deltas once
// and writes K int32 alphas; this design reads the deltas twice (passes 1
// and 3), so it sits at about half the bandwidth bound at best.  Counts are
// int32 and exact while the number of edge activations is below 2^31 - 1
// (the wrapper's guard); all offsets are 64-bit, so K * P may exceed the
// int32 index space.

#include "merge_scan.cuh"

namespace {

struct StoreAlpha {
  int32_t* alphas;
  __device__ void operator()(int64_t k, int32_t alpha) const {
    alphas[k] = alpha;
  }
};

}  // namespace

// Scratch: `totals` holds ceil(K / 32) * P int32.  Returns cudaGetLastError().
extern "C" int coflow_merge_launch(void* delta, long long K, int P,
                                   void* totals, void* alphas, void* stream) {
  return static_cast<int>(merge_scan::scan(
      static_cast<const int32_t*>(delta), K, P,
      static_cast<int32_t*>(totals),
      StoreAlpha{static_cast<int32_t*>(alphas)},
      static_cast<cudaStream_t>(stream)));
}
