// coflow_merge: alpha per merged interval (DMA Steps 3-4, Lemma 6).  Given
// the (K, P) int32 array of per-interval per-port activation deltas
// (P = 2m ports: m senders then m receivers), alpha[k] is the max over
// ports of the running count sum_{k' <= k} delta[k', p].
//
// Replaces the TPU kernel src/repro/kernels/coflow_merge/coflow_merge.py
// (_merge_kernel, launched by coflow_merge_padded).  The TPU walks the
// interval axis as a sequential grid and carries the running counts from
// one grid step to the next in VMEM scratch.  Blocks of a CUDA grid run in
// no order, so the carry comes from merge_scan.cuh's radix-8 hierarchy of
// tile totals (shared with merge_fix), in one pass over the deltas: one
// block a 32-row tile, taken from a ticket, one thread a port
// of a port tile.  A block copies its rows into shared memory with
// cp.async (16-byte copies of the tile's contiguous run of rows * 2m ints
// where aligned), publishes their column totals as soon as they land,
// waits for the carry, scans its column in place and takes each row's max
// with one warp a row; the blocks resident beside it on the SM overlap one
// tile's copy with another's scan.  The epilogue stores
// alpha as int32.  The TPU's padding of 2m to 128 lanes is not needed and
// is gone.
//
// Bound on the card: memory.  The function reads K * P int32 deltas once
// and writes K int32 alphas; this design reads the deltas once.  Beside
// them it writes the carry (each tile's totals, ceil(K / 32) * P int32,
// 1/32 of the deltas' bytes, and their sums over 8, 64, ... tiles), which
// the tiles above read back from L2, and clears the carry's counts, upper
// levels and ticket with a small kernel first (two launches a call).
// Counts are int32 and exact while the number of edge activations is below
// 2^31 - 1 (the wrapper's guard); all offsets are 64-bit, so K * P may
// exceed the int32 index space.

#include "merge_scan.cuh"

namespace {

using merge_scan::kRows;

struct StoreAlpha {
  int32_t* alphas;
  __device__ void operator()(int64_t k, int32_t alpha) const {
    alphas[k] = alpha;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Start copying port tile pt of tile b into dst: kRows rows of the port
// tile, rows past K as zeros.  With one port tile the tile is one
// run of rows * P ints, copied 16 bytes a thread where aligned and laid
// out [kRows][P]; otherwise [kRows][PT], one column a thread.
__device__ __forceinline__ void stage(int32_t* dst, const int32_t* delta,
                                      int64_t K, int P, int b, int pt) {
  const int PT = blockDim.x, q = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(b) * kRows;
  const int rows = static_cast<int>(K - r0 < kRows ? K - r0 : kRows);
  if (P <= PT) {
    const int32_t* src = delta + r0 * P;
    const int n = rows * P;
    int k0 = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      k0 = n & ~3;
      for (int k = 4 * q; k < k0; k += 4 * PT) cp_async16(dst + k, src + k);
    }
    for (int k = k0 + q; k < n; k += PT) cp_async4(dst + k, src + k);
    for (int k = n + q; k < kRows * P; k += PT) dst[k] = 0;
  } else {
    const int p0 = pt * PT;
    const bool valid = p0 + q < P;
#pragma unroll 8
    for (int i = 0; i < kRows; ++i) {
      if (valid && i < rows)
        cp_async4(dst + i * PT + q, delta + (r0 + i) * P + p0 + q);
      else
        dst[i * PT + q] = 0;
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The block's tile, the next ticket: called by the whole block at its
// start; ends in a barrier.
__device__ __forceinline__ int take_tile(const merge_scan::Carry& cy) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = atomicAdd(cy.ticket(), 1);
  __syncthreads();
  return tile;
}

// Launch 1: the carry's words [from, to) set to 0.
__global__ void carry_clear(int32_t* carry, int64_t from, int64_t to) {
  for (int64_t i = from + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < to; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    carry[i] = 0;
}

// The column totals of port tile pt of tile b, staged in cells, published.
__device__ __forceinline__ void publish_item(const merge_scan::Carry& cy,
                                             const int32_t* cells, int ld,
                                             int P, int b, int pt) {
  const int q = threadIdx.x, p0 = pt * blockDim.x;
  int32_t total = 0;
  if (p0 + q < P)
    for (int i = 0; i < kRows; ++i) total += cells[i * ld + q];
  merge_scan::publish(cy, b, pt, p0 + q, p0 + q < P, total);
}

// Launch 2: one block a 32-row tile (from the ticket), one thread a port
// of a port tile.  Per port tile, in order: copy the rows into shared
// memory, publish their column totals, wait for the carry, scan.
__global__ void __launch_bounds__(merge_scan::kPortTile, 2)
    merge_pass(const int32_t* __restrict__ delta, int64_t K, int P, int T,
               void* carry, StoreAlpha epi) {
  extern __shared__ __align__(16) int32_t cells[];  // [kRows * blockDim.x]
  __shared__ int32_t best[kRows];  // running max per row
  const merge_scan::Carry cy(carry, T, P);
  const int PT = blockDim.x, q = threadIdx.x;
  const int npt = static_cast<int>(cy.npt), ld = npt == 1 ? P : PT;
  if (q < kRows) best[q] = INT32_MIN;
  const int b = take_tile(cy);  // ends in a barrier
  const int64_t r0 = static_cast<int64_t>(b) * kRows;
  const int rows = static_cast<int>(K - r0 < kRows ? K - r0 : kRows);
  for (int pt = 0; pt < npt; ++pt) {
    stage(cells, delta, K, P, b, pt);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // every thread's copies are in
    publish_item(cy, cells, ld, P, b, pt);
    const int p0 = pt * PT, np = P - p0 < PT ? P - p0 : PT;
    int32_t carry = merge_scan::carry_in(cy, b, pt, p0 + q, q < np);
    merge_scan::scan_stretch(cells, ld, np, carry, rows, best);
  }
  if (q < rows) epi(r0 + q, best[q]);  // scan_stretch ends in a barrier
}

}  // namespace

// delta: (K, P) int32; carry: merge_scan::Carry(T, P).words() int32 with
// T = ceil(K / 32); alphas: (K,) int32.  Returns the first CUDA error of
// the two launches, or 0.
extern "C" int coflow_merge_launch(void* delta, long long K, int P,
                                   void* carry, void* alphas, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t T = (K + kRows - 1) / kRows;
  const merge_scan::Carry cy(carry, T, P);
  const int64_t nz = cy.words() - cy.zero_from();
  const int64_t cblocks = (nz + 255) / 256;
  carry_clear<<<static_cast<unsigned>(cblocks < 1024 ? cblocks : 1024), 256,
                0, st>>>(cy.buf, cy.zero_from(), cy.words());
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = merge_scan::block_threads(P);
  const size_t shmem = static_cast<size_t>(kRows) * threads * sizeof(int32_t);
  {  // the dynamic size, past 48 KB with the static part included
    e = cudaFuncSetAttribute(merge_pass,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  merge_pass<<<static_cast<unsigned>(T), threads, shmem, st>>>(
      static_cast<const int32_t*>(delta), K, P, static_cast<int>(T), carry,
      StoreAlpha{static_cast<int32_t*>(alphas)});
  return static_cast<int>(cudaGetLastError());
}
