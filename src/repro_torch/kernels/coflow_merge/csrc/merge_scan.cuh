// merge_scan.cuh: the three-pass scan shared by coflow_merge (K2) and
// merge_fix (K3).  Given the (K, P) int32 array of per-interval per-port
// activation deltas, alpha[k] = max over ports of sum_{k' <= k} delta[k', p],
// handed with its row index to an epilogue that stores it.
//
// Blocks of a CUDA grid run in no order, so the running count down the
// interval axis is a block-sum scan in three launches:
//   1. block_totals: per block of kRows rows, each port's column total;
//   2. block_carry:  per port, an exclusive scan of those totals down the
//                    blocks (the carry into each block).  One CUDA block
//                    per 32 ports, 32 threads per port: each thread sums
//                    its segment of the block axis, one thread per port
//                    scans the 32 segment sums in shared memory, and each
//                    thread re-walks its segment writing the carries, so
//                    the serial chain is nblocks / 32 long, not nblocks;
//   3. block_alphas: each block re-scans its rows from its carry, one
//                    thread per port, into a shared-memory tile of kRows
//                    rows by at most kPortTile ports; one warp per row
//                    takes the max over the tile's ports (shuffle max)
//                    into a running max per row, and the block walks the
//                    port axis tile by tile; then one thread per row calls
//                    the epilogue.  The tile is P ports wide up to 512
//                    (2m <= 512: one tile, 64 KB at most), so shared memory
//                    no longer grows with m and any switch width launches;
//                    a max does not depend on the order it is taken in, so
//                    the alphas are exactly those of one pass.
// All offsets are 64-bit, so K * P may exceed the int32 index space.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace merge_scan {

constexpr int kRows = 32;        // rows per block
constexpr int kPortTile = 512;   // ports per shared-memory tile (64 KB)
constexpr int kThreads = 256;    // threads per block
constexpr int kCarryPorts = 32;  // ports per block_carry block (x)
constexpr int kCarrySegs = 32;   // segments of the block axis per port (y)

__global__ void block_totals(const int32_t* __restrict__ delta, int64_t K,
                             int P, int32_t* __restrict__ totals) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t r1 = (r0 + kRows < K) ? r0 + kRows : K;
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    int32_t acc = 0;
    for (int64_t r = r0; r < r1; ++r) acc += delta[r * P + p];
    totals[static_cast<int64_t>(blockIdx.x) * P + p] = acc;
  }
}

__global__ void block_carry(int32_t* __restrict__ totals, int64_t nblocks,
                            int P) {
  __shared__ int32_t seg[kCarrySegs][kCarryPorts];
  const int p = blockIdx.x * kCarryPorts + threadIdx.x;
  const int64_t len = (nblocks + kCarrySegs - 1) / kCarrySegs;
  const int64_t b0 = threadIdx.y * len;
  const int64_t b1 = (b0 + len < nblocks) ? b0 + len : nblocks;
  int32_t acc = 0;
  if (p < P)
    for (int64_t b = b0; b < b1; ++b) acc += totals[b * P + p];
  seg[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0) {
    int32_t run = 0;  // exclusive scan of this port's segment sums
    for (int j = 0; j < kCarrySegs; ++j) {
      const int32_t v = seg[j][threadIdx.x];
      seg[j][threadIdx.x] = run;
      run += v;
    }
  }
  __syncthreads();
  if (p >= P) return;
  acc = seg[threadIdx.y][threadIdx.x];
  for (int64_t b = b0; b < b1; ++b) {
    const int32_t v = totals[b * P + p];
    totals[b * P + p] = acc;  // exclusive: the carry into block b
    acc += v;
  }
}

template <class Epilogue>
__global__ void block_alphas(const int32_t* __restrict__ delta, int64_t K,
                             int P, const int32_t* __restrict__ carry,
                             Epilogue epi) {
  extern __shared__ int32_t counts[];  // [kRows][tile]
  __shared__ int32_t best[kRows];      // running max per row over the tiles
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = static_cast<int>((K - r0 < kRows) ? K - r0 : kRows);
  const int tile = P < kPortTile ? P : kPortTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (static_cast<int>(threadIdx.x) < kRows) best[threadIdx.x] = INT32_MIN;
  for (int p0 = 0; p0 < P; p0 += tile) {
    const int np = (P - p0 < tile) ? P - p0 : tile;
    __syncthreads();  // the previous tile's counts are read, best is set
    for (int q = threadIdx.x; q < np; q += blockDim.x) {
      const int p = p0 + q;
      int32_t acc = carry[static_cast<int64_t>(blockIdx.x) * P + p];
      for (int i = 0; i < rows; ++i) {
        acc += delta[(r0 + i) * P + p];
        counts[i * tile + q] = acc;
      }
    }
    __syncthreads();
    for (int i = warp; i < rows; i += blockDim.x >> 5) {
      int32_t v = INT32_MIN;
      for (int q = lane; q < np; q += 32) v = max(v, counts[i * tile + q]);
      for (int off = 16; off > 0; off >>= 1)
        v = max(v, __shfl_down_sync(0xffffffffu, v, off));
      if (lane == 0) best[i] = max(best[i], v);
    }
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < rows) epi(r0 + threadIdx.x,
                                                best[threadIdx.x]);
}

// Scratch: `totals` holds ceil(K / kRows) * P int32.  Returns the first
// CUDA error of the three launches, or cudaSuccess.
template <class Epilogue>
cudaError_t scan(const int32_t* delta, int64_t K, int P, int32_t* totals,
                 Epilogue epi, cudaStream_t st) {
  if (K <= 0) return cudaSuccess;
  const int64_t nblocks = (K + kRows - 1) / kRows;
  const int tile = P < kPortTile ? P : kPortTile;
  const size_t shmem = static_cast<size_t>(kRows) * tile * sizeof(int32_t);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block_alphas<Epilogue>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return e;
  }
  block_totals<<<static_cast<unsigned>(nblocks), kThreads, 0, st>>>(
      delta, K, P, totals);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  block_carry<<<(P + kCarryPorts - 1) / kCarryPorts,
                dim3(kCarryPorts, kCarrySegs), 0, st>>>(totals, nblocks, P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  block_alphas<<<static_cast<unsigned>(nblocks), kThreads, shmem, st>>>(
      delta, K, P, totals, epi);
  return cudaGetLastError();
}

}  // namespace merge_scan
