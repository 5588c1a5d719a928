// merge_scan.cuh: the one-pass merge scan shared by coflow_merge (K2) and
// merge_fix (K3).  Both compute, per interval k of K,
//   alpha[k] = max over the P ports of count[k, p],
//   count[k, p] = sum over k' <= k of delta[k', p],
// and hand alpha with its row index to an epilogue that stores it.
//
// The interval axis is cut into T tiles, one block each.  Blocks of a CUDA
// grid run in no order, so the per-port count at a tile's first row (its
// carry) comes from the other tiles' column totals, through a radix-8
// hierarchy in device memory (the carry's levels):
//   * Levels: level 0 holds each tile's totals (T rows of P int32), level l
//     the sums over blocks of 8^l tiles (ceil(T / 8^l) rows).  Beside each
//     row, a completion count per port tile.
//   * Publish, as soon as a tile's totals are known and before it waits on
//     anything: each thread stores its port's level-0 value and atomically
//     adds it into its block's row at every level above (zeros are
//     skipped); then a block barrier, and thread 0 fences
//     (fence.acq_rel.gpu) and adds 1 to the count at every level (the
//     barrier-then-one-fence pattern of CUTLASS's semaphores: the fence
//     orders the block's stores and adds before the counts).
//   * Carry: the tiles below tile b are, at each level l, the (up to 7)
//     full blocks of 8^l tiles below b's own block within its block of 8
//     at the level above; so warp 0 waits until those counts read 8^l
//     (one lane a block, ld.acquire.gpu), a block barrier orders the
//     acquires before the reads, and each thread adds at most 7 values a
//     level (loads through L2, __ldcg, sixteen in flight at a time across
//     the levels: two round trips up to 4096 tiles).  No tile waits on
//     another's carry, so nothing chains: a tile's wait ends once every
//     lower tile has read its own deltas.
//   * Order: a tile waits only on lower tiles, and publishes before it
//     waits; so the block holding the lowest unfinished tile waits on
//     published totals alone, provided every lower tile's block has
//     started.  K2 takes its tile from an atomic ticket as a block starts
//     (coflow_merge.cu), which provides that whatever order the hardware
//     starts blocks in and however few fit at once: a block that has not
//     started holds no tile.  K3's tile_scan takes tile = block index and
//     relies on the hardware starting a grid's blocks in index order, as
//     CUB's single-pass scan does (a ticket there slowed the main path's
//     merges, as PERF.md records).  Past 512 ports a block walks the port
//     axis in port tiles, in the same order in every block, each with its
//     own counts.  A wait that polls 2^26 times (seconds) traps, so a fault
//     ends the launch with an error, not a hang.
//   * Rows: a block scans its tile's 32 rows of the port tile in shared
//     memory (thread q owns column q) from the carry, in place; then one
//     warp a row takes the max over the port tile (one redux.sync) into the
//     block's running max per row.
// The counts, the levels above 0 and the ticket must be 0 when the scan
// starts: K2's first launch (carry_clear) clears them, K3's binning kernel
// on its way.  Counts are int32 (exact while the activations are fewer than
// 2^31, the wrappers' guard); all offsets are 64-bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace merge_scan {

constexpr int kRows = 32;           // rows a tile
constexpr int kPortTile = 512;      // ports a port tile: a block's threads
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPolls = 1 << 26;  // polls before a wait traps
constexpr int kRadix = 3;           // level l sums blocks of 8^l tiles
constexpr int kFan = (1 << kRadix) - 1;  // blocks a level adds at most

// threads a block: one per port of a port tile, a whole number of warps
inline int block_threads(int P) {
  const int t = (P + 31) / 32 * 32;
  return t < kPortTile ? t : kPortTile;
}

// The carry's scratch, in one int32 buffer: the levels' values (rows of
// P), then their counts (rows of npt, one a port tile), then K2's ticket.
// All but level 0 must start at 0 (words [zero_from(), words())).
struct Carry {
  int32_t* buf;
  int64_t T, P, npt;
  int levels;

  __host__ __device__ Carry(void* b, int64_t T_, int64_t P_)
      : buf(static_cast<int32_t*>(b)), T(T_), P(P_),
        npt((P_ + kPortTile - 1) / kPortTile), levels(1) {
    for (int64_t n = 1 << kRadix; n < T; n <<= kRadix) ++levels;
  }
  // first row of level l, counting the rows of the levels below
  __host__ __device__ int64_t row0(int l) const {
    int64_t at = 0, n = T;
    for (int i = 0; i < l; ++i, n = (n + kFan) >> kRadix) at += n;
    return at;
  }
  __host__ __device__ int64_t rows() const { return row0(levels); }
  __host__ __device__ int32_t* values() const { return buf; }
  __host__ __device__ int* counts() const {
    return reinterpret_cast<int*>(buf + rows() * P);
  }
  __host__ __device__ int* ticket() const { return counts() + rows() * npt; }
  __host__ __device__ int64_t zero_from() const { return T * P; }
  __host__ __device__ int64_t words() const { return rows() * (P + npt) + 1; }
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Tile b's totals of port tile pt, this thread's port p (valid: p < P),
// published.  Called by the whole block.
__device__ __forceinline__ void publish(const Carry& cy, int b, int pt,
                                        int64_t p, bool valid,
                                        int32_t total) {
  int32_t* lv = cy.values();
  if (valid) {
    __stcg(lv + static_cast<int64_t>(b) * cy.P + p, total);
    if (total)
      for (int l = 1; l < cy.levels; ++l)
        atomicAdd(lv + (cy.row0(l) + (b >> (kRadix * l))) * cy.P + p, total);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    int* cnt = cy.counts();
    for (int l = 0; l < cy.levels; ++l)
      atomicAdd(cnt + (cy.row0(l) + (b >> (kRadix * l))) * cy.npt + pt, 1);
  }
}

// The carry into tile b of port tile pt, this thread's port p: the totals
// of every lower tile, once published.  Called by the whole block.  The
// blocks to add are, at each level l, the (up to kFan) full blocks of 8^l
// tiles below b's own within its block at the level above: entry f of
// them is level f / kFan, block f % kFan.  Warp 0 waits until their counts
// are full (ld.acquire.gpu), a block barrier orders those acquires before
// every thread's reads, and each thread adds its port's values, sixteen
// loads in flight at a time, whatever their level.
__device__ __forceinline__ int32_t carry_in(const Carry& cy, int b, int pt,
                                            int64_t p, bool valid) {
  __shared__ int64_t row0[32];  // first row of each level
  const int n = cy.levels * kFan;
  if (threadIdx.x < cy.levels) row0[threadIdx.x] = cy.row0(threadIdx.x);
  if (threadIdx.x < 32) {
    const int* cnt = cy.counts();
    for (int polls = 0;; ++polls) {
      bool all = true;
      for (int f = threadIdx.x; f < n; f += 32) {
        const int l = f / kFan, q = b >> (kRadix * l);
        const int j = (q & ~kFan) + f - kFan * l;
        if (j < q && ld_acquire(cnt + (cy.row0(l) + j) * cy.npt + pt) !=
                         1 << (kRadix * l))
          all = false;
      }
      if (__all_sync(kFull, all)) break;
      if (polls == kMaxPolls) __trap();  // seconds: a fault, not a wait
      __nanosleep(32);
    }
  }
  __syncthreads();
  int32_t carry = 0;
  if (!valid) return carry;
  const int32_t* lv = cy.values() + p;
  for (int f0 = 0; f0 < n; f0 += 16) {
    int32_t v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int f = f0 + i, l = f / kFan, q = b >> (kRadix * l);
      const int j = (q & ~kFan) + f - kFan * l;
      v[i] = f < n && j < q ? __ldcg(lv + (row0[l] + j) * cy.P) : 0;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) carry += v[i];
  }
  return carry;
}

// A stretch of up to kRows rows in cells[i * ld + q] (shared memory, one
// column a thread): each thread scans its column on from `carry` in place
// (a thread past the np valid ports writes INT32_MIN), then one warp a row
// folds the row's max over the valid ports into best[i].  Called by the
// whole block; starts and ends with a barrier.
__device__ __forceinline__ void scan_stretch(int32_t* cells, int ld, int np,
                                             int32_t& carry, int rows,
                                             int32_t* best) {
  const int q = threadIdx.x, lane = q & 31, warp = q >> 5;
  __syncthreads();  // the stretch's deltas are in place
  if (q < ld) {
    for (int i0 = 0; i0 < kRows; i0 += 8) {
      int32_t v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = cells[(i0 + i) * ld + q];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        carry += v[i];
        cells[(i0 + i) * ld + q] = q < np ? carry : INT32_MIN;
      }
    }
  }
  __syncthreads();
  for (int i = warp; i < rows; i += blockDim.x >> 5) {
    int32_t m = INT32_MIN;
    for (int c = lane; c < np; c += 32) m = max(m, cells[i * ld + c]);
    m = __reduce_max_sync(kFull, m);
    if (lane == 0) best[i] = max(best[i], m);
  }
  __syncthreads();  // the cells are free again
}

}  // namespace merge_scan
