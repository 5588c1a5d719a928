// merge_fix: the fused merge_and_fix tail (DMA Steps 3-4, Lemma 6).  From
// the merged edge activations (t0, t1, s, r) and the sorted interval
// boundaries `events` (K + 1 of them), it computes per interval k
//   alpha_k = max over the 2m ports of the number of active edges, and
//   delta_k = (events[k+1] - events[k]) * max(alpha_k, 1),
// the expanded durations whose cumsum is merge_and_fix's `exp`.  An edge
// is active on its sender s and receiver m + r from row si to row ei - 1,
// si and ei being numpy's searchsorted (side='left') of t0 and t1 in
// events; an endpoint at or past row K is dropped, as JAX drops an
// out-of-range scatter.
//
// Replaces the TPU path src/repro/kernels/merge_fix/ops.py::merge_fix_step,
// which chains a host searchsorted, build_delta (a dense (K + 1, 2m)
// scatter), the coflow_merge Pallas kernel (coflow_merge_padded) and the
// duration product.  The inputs are sparse (E edges, K + 1 times), so here
// no (K + 1, 2m) array exists anywhere, and no memset runs; three launches
// on one stream, whose layout (tile, bin, chunk and bucket counts) the
// wrapper computes (kernels/merge_fix/ref.py::tile_layout):
//   1. bucket_index: the events' times cut into 2^k >= K + 1 buckets of
//      equal width, and per bucket the lower bound of its first time, so a
//      search is one table read and a binary search of the few events in
//      one bucket (about two random reads, not log2(K) of them).
//   2. bin_sort: one block per chunk of edges (at most 512 chunks), four
//      edges a thread at a time.  Each endpoint's row (numpy's
//      searchsorted, side='left', through the buckets) is counted per bin
//      of rows in shared memory (a bin is one 32-row tile, or 2^j tiles
//      when the tiles outnumber the 12,000 counts that fit); a hand-written
//      block scan turns the counts into offsets, which the block stores
//      (seg[chunk][bin]), and a second walk over its edges scatters one
//      8-byte record per endpoint (row in bin, start or end, s, r) into its
//      chunk's region in bin order.  Each chunk is its own counting sort, so
//      no device-wide sort, scan or histogram is needed; the blocks also
//      clear the carry's counts and upper levels for launch 3.
//   3. tile_scan: one block per 32-row tile, by block index.  The block
//      reads its bin's range in every chunk at once, then, per port tile,
//      the tile's records (four a thread, their chunks by binary search),
//      which go by shared-memory atomics into a zeroed
//      [32][port tile] int32 array whose column sums are the tile's totals;
//      merge_scan.cuh publishes them into its radix-8 carry, then scans
//      each column on from the carry and takes each row's max.  The
//      epilogue writes alpha and the duration as int64: the product in
//      int64 equals both branches of the reference (int32 in-graph when it
//      fits, host int64 otherwise).
// Integer atomics are exact in any order, so neither the order of records
// within a bin nor that of the adds changes a count.
//
// Bound on the card: memory.  The function reads events (K + 1 int64) and
// the edges (4E int64) once and writes 2K int64.  The design reads the
// edges once and events once in the epilogue (the searches hit L1 and L2),
// and moves beside them 2E int32 rows (written and read by the same
// thread), 2E int64 records (written once, read once a tile), the bucket
// table, the chunks' offsets and the carry (tiles * 2m int32 and their
// sums): at the main path's merges about 2.5 times the function's bytes,
// against the dense design's (K + 1) * 2m array written by a memset, 4E
// scattered atomics and read twice.  Counts are int32 and exact while the
// number of edge activations is below 2^31 - 1 (the wrapper's guard); the
// records hold m < 2^22 and K < 2^31 - 1 (checked by the wrapper); offsets
// are 64-bit.

#include "../../coflow_merge/csrc/merge_scan.cuh"

namespace {

using merge_scan::kFull;
using merge_scan::kRows;

constexpr int kSortThreads = 512;
constexpr int kLgRows = 5;        // a tile's rows: 2^5 = kRows
constexpr int kMaxChunks = 512;   // the wrapper's chunks at most
constexpr int kPortBits = 22;     // s and r, each below 2^22
constexpr int kRowShift = 44;     // row in bin: bits 44..62 (below 2^19)
constexpr uint64_t kPortMask = (1ull << kPortBits) - 1;
constexpr uint64_t kRowMask = (1ull << 19) - 1;

// The bucket index of the events: nb buckets of `width` times from
// events[0]; table[b] is the lower bound (side='left') of the bucket's
// first time, so a time's lower bound lies in [table[b], table[b + 1]].
struct Buckets {
  const int64_t* events;
  int64_t K;
  int64_t nb;
  uint64_t width;

  __device__ Buckets(const int64_t* ev, int64_t K_, int64_t nb_)
      : events(ev), K(K_), nb(nb_),
        width(static_cast<uint64_t>(__ldg(ev + K_) - __ldg(ev)) / nb_ + 1) {}
  // the bucket of x; -1 below events[0], nb past events[K]
  __device__ int64_t of(int64_t x) const {
    const int64_t e0 = __ldg(events);
    if (x <= e0) return -1;
    if (x > __ldg(events + K)) return nb;
    return static_cast<int64_t>(static_cast<uint64_t>(x - e0) / width);
  }
};

// lower_bound (side='left') of x in events[lo, hi)
__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ ev,
                                               int64_t lo, int64_t hi,
                                               int64_t x) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(ev + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Launch 1: the bucket table, one thread a bucket (nb + 1 entries).
__global__ void bucket_index(const int64_t* __restrict__ events, int64_t K,
                             int64_t nb, int32_t* __restrict__ table) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b > nb) return;
  const Buckets bk(events, K, nb);
  const int64_t start = __ldg(events) + static_cast<int64_t>(b * bk.width);
  table[b] = static_cast<int32_t>(
      b == nb ? K + 1 : lower_bound(events, 0, K + 1, start));
}

// Exclusive scan of a[0, n) in shared memory by the whole block; a[n]
// receives the total.
__device__ void exclusive_scan(int32_t* a, int n, int32_t* warp_sum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int i0 = min(n, tid * per), i1 = min(n, i0 + per);
  int32_t sum = 0;
  for (int i = i0; i < i1; ++i) sum += a[i];
  int32_t inc = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t t = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += t;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < nw ? warp_sum[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t t = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += t;
    }
    warp_sum[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  int32_t run = inc - sum + (warp ? warp_sum[warp - 1] : 0);
  for (int i = i0; i < i1; ++i) {
    const int32_t v = a[i];
    a[i] = run;
    run += v;
  }
  if (tid == static_cast<int>(blockDim.x) - 1) a[n] = run;
}

// Launch 2.  Chunk c holds edges [c * Ec, (c + 1) * Ec); its records go to
// recs[2 * c * Ec ...] in bin order, its bin offsets to seg[c][0 .. nbins].
// A bin holds 2^lg rows.  The blocks also clear the carry's words
// [zero0, zero1) for launch 3.  Dynamic shared memory: the bins' counts.
__global__ void __launch_bounds__(kSortThreads)
    bin_sort(const int64_t* __restrict__ events, int64_t K, int64_t nb,
             const int32_t* __restrict__ table,
             const int64_t* __restrict__ t0, const int64_t* __restrict__ t1,
             const int64_t* __restrict__ s, const int64_t* __restrict__ r,
             int64_t E, int64_t Ec, int nbins, int lg,
             int32_t* __restrict__ rows, uint64_t* __restrict__ recs,
             int32_t* __restrict__ seg, int32_t* __restrict__ carry,
             int64_t zero0, int64_t zero1) {
  extern __shared__ int32_t hist[];  // nbins + 1 counts, then cursors
  __shared__ int32_t warp_sum[32];
  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  for (int64_t i = zero0 + static_cast<int64_t>(c) * nt + tid; i < zero1;
       i += static_cast<int64_t>(gridDim.x) * nt)
    carry[i] = 0;
  for (int i = tid; i <= nbins; i += nt) hist[i] = 0;
  __syncthreads();
  const Buckets bk(events, K, nb);
  const int64_t e0 = static_cast<int64_t>(c) * Ec;
  const int64_t e1 = E < e0 + Ec ? E : e0 + Ec;
  // four edges a thread at a time, their loads in flight together; each
  // endpoint's row from its bucket's range in the table, then a binary
  // search of the (few) events in it
  for (int64_t e0t = e0 + tid; e0t < e1; e0t += 4 * nt) {
    int64_t x[8], lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t e = e0t + (i >> 1) * nt;
      x[i] = e < e1 ? ((i & 1) ? t1[e] : t0[e]) : 0;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t b = bk.of(x[i]);
      const bool in = b >= 0 && b < nb;
      lo[i] = in ? table[b] : b < 0 ? 0 : K + 1;
      hi[i] = in ? table[b + 1] : lo[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t e = e0t + (i >> 1) * nt;
      if (e >= e1) continue;
      const int64_t rw = lower_bound(events, lo[i], hi[i], x[i]);
      const int64_t kept = rw < K ? rw : K;  // K: dropped
      rows[2 * e + (i & 1)] = static_cast<int32_t>(kept);
      if (kept < K) atomicAdd(hist + (kept >> lg), 1);
    }
  }
  __syncthreads();
  exclusive_scan(hist, nbins, warp_sum);
  __syncthreads();
  int32_t* sg = seg + static_cast<int64_t>(c) * (nbins + 1);
  for (int i = tid; i <= nbins; i += nt) sg[i] = hist[i];
  __syncthreads();  // the offsets are stored before they become cursors
  uint64_t* out = recs + 2 * e0;
  const int64_t in_bin = (int64_t{1} << lg) - 1;
  for (int64_t e0t = e0 + tid; e0t < e1; e0t += 4 * nt) {
    // rows[] of these edges was written by this thread in the first walk
    int32_t rw[8];
    uint64_t sr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t e = e0t + i * nt;
      rw[2 * i] = e < e1 ? rows[2 * e] : K;
      rw[2 * i + 1] = e < e1 ? rows[2 * e + 1] : K;
      sr[i] = e < e1 ? static_cast<uint64_t>(s[e]) |
                           (static_cast<uint64_t>(r[e]) << kPortBits)
                     : 0;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = rw[i];
      if (row < K)
        out[atomicAdd(hist + (row >> lg), 1)] =
            sr[i >> 1] | (static_cast<uint64_t>(row & in_bin) << kRowShift) |
            (static_cast<uint64_t>(i & 1) << 63);
    }
  }
}

__device__ __forceinline__ int row_in_bin(uint64_t x) {
  return static_cast<int>((x >> kRowShift) & kRowMask);
}

// A record's port on side 0 (s) or 1 (m + r), relative to p0: PT or more
// (unsigned) when outside the port tile.
__device__ __forceinline__ unsigned port(uint64_t x, int side, int m,
                                         int p0) {
  const int q = side ? m + static_cast<int>((x >> kPortBits) & kPortMask)
                     : static_cast<int>(x & kPortMask);
  return static_cast<unsigned>(q - p0);
}

// A record's +1 (start) or -1 (end) at its two ports, into line[port - p0]
// for the ports of the port tile [p0, p0 + PT).
__device__ __forceinline__ void add_record(uint64_t x, int32_t* line, int m,
                                           int p0, int PT) {
  const int d = (x >> 63) ? -1 : 1;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const unsigned q = port(x, side, m, p0);
    if (q < static_cast<unsigned>(PT)) atomicAdd(line + q, d);
  }
}

// A bin's records: its range in every chunk (lo, off in shared memory, off
// the running sum of the lengths) and the f-th of them.
struct BinRecords {
  const uint64_t* recs;
  int64_t Ec;
  int C;
  int32_t* lo;
  int32_t* off;

  // by the whole block; ends in a barrier
  __device__ void load(const int32_t* seg, int nbins, int bin,
                       int32_t* warp_sum) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const int32_t* sg = seg + static_cast<int64_t>(c) * (nbins + 1) + bin;
      lo[c] = sg[0];
      off[c] = sg[1] - sg[0];
    }
    __syncthreads();
    exclusive_scan(off, C, warp_sum);  // off[C]: the bin's records
    __syncthreads();
  }
  __device__ int32_t count() const { return off[C]; }
  // fn(x) for each of the bin's records, split over the block: four
  // records a thread at a time, their chunks found by binary searches over
  // off side by side, their loads in flight together
  template <class F>
  __device__ void each(F fn) const {
    const int32_t n = off[C];
    const int PT = blockDim.x;
    for (int32_t f0 = threadIdx.x; f0 < n; f0 += 4 * PT) {
      int a[4], z[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = 0, z[i] = C;
      for (bool more = true; more;) {  // the last c with off[c] <= f
        more = false;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (z[i] - a[i] <= 1) continue;
          const int mid = (a[i] + z[i]) >> 1;
          if (off[mid] <= f0 + i * PT) a[i] = mid; else z[i] = mid;
          more = true;
        }
      }
      uint64_t x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int32_t f = f0 + i * PT;
        if (f < n) x[i] = recs[2 * a[i] * Ec + lo[a[i]] + (f - off[a[i]])];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (f0 + i * PT < n) fn(x[i]);
    }
  }
};

struct StoreFix {
  const int64_t* events;
  int64_t* alphas;
  int64_t* deltas;
  __device__ void operator()(int64_t k, int32_t alpha) const {
    alphas[k] = alpha;
    deltas[k] = (events[k + 1] - events[k]) * static_cast<int64_t>(max(alpha, 1));
  }
};

// Launch 3.  One block per 32-row tile (by block index), one thread per
// port of a port tile.  A bin holds 2^lg_tiles tiles.  Dynamic shared
// memory: cells [kRows][blockDim.x] int32.
__global__ void __launch_bounds__(merge_scan::kPortTile, 2)
    tile_scan(const uint64_t* __restrict__ recs,
              const int32_t* __restrict__ seg, int C, int64_t Ec, int nbins,
              int lg_tiles, int64_t K, int T, int m, int P, void* carry,
              StoreFix epi) {
  static_assert(kRows == 1 << kLgRows, "a tile's rows");
  extern __shared__ __align__(16) int32_t cells[];
  __shared__ int32_t best[kRows];  // running max per row
  __shared__ int32_t lo[kMaxChunks], off[kMaxChunks + 1], warp_sum[32];
  const merge_scan::Carry cy(carry, T, P);
  const int tid = threadIdx.x, PT = blockDim.x;
  if (tid < kRows) best[tid] = INT32_MIN;
  const int b = blockIdx.x;  // tiles in block order: see merge_scan.cuh
  const int64_t r0 = static_cast<int64_t>(b) * kRows;
  const int rows = static_cast<int>(K - r0 < kRows ? K - r0 : kRows);
  const int tib = b & ((1 << lg_tiles) - 1);  // the tile within its bin
  BinRecords br{recs, Ec, C, lo, off};
  br.load(seg, nbins, b >> lg_tiles, warp_sum);  // ends in a barrier
  for (int p0 = 0; p0 < P; p0 += PT) {
    const int np = P - p0 < PT ? P - p0 : PT;
    const int64_t p = p0 + tid;
    int4* c4 = reinterpret_cast<int4*>(cells);
    for (int i = tid; i < kRows * PT / 4; i += PT)
      c4[i] = make_int4(0, 0, 0, 0);
    __syncthreads();
    br.each([&](uint64_t x) {
      const int rib = row_in_bin(x);
      if (rib >> kLgRows == tib)  // else another tile of the bin
        add_record(x, cells + (rib & (kRows - 1)) * PT, m, p0, PT);
    });
    __syncthreads();
    int32_t total = 0;
    if (tid < np)
      for (int i = 0; i < kRows; ++i) total += cells[i * PT + tid];
    merge_scan::publish(cy, b, p0 / PT, p, tid < np, total);
    int32_t carry = merge_scan::carry_in(cy, b, p0 / PT, p, tid < np);
    merge_scan::scan_stretch(cells, PT, np, carry, rows, best);
  }
  if (tid < rows) epi(r0 + tid, best[tid]);  // scan_stretch ends in a barrier
}

}  // namespace

// events: (K + 1,) int64, sorted, unique; t0, t1, s, r: (E,) int64; the
// layout (nb, Ec, C, nbins, lg_tiles) and the scratch come from the
// wrapper (kernels/merge_fix/ops.py::scratch): table nb + 1 int32, rows 2E
// int32, recs 2E uint64, seg C * (nbins + 1) int32, carry
// merge_scan::Carry(T, 2m).words() int32 (T tiles of 32 rows); alphas,
// deltas: (K,) int64.  Returns the first CUDA error, or 0.
extern "C" int merge_fix_launch(void* events, long long K, void* t0, void* t1,
                                void* s, void* r, long long E, int m,
                                long long nb, long long Ec, int C, int nbins,
                                int lg_tiles, void* table, void* rows,
                                void* recs, void* seg, void* carry,
                                void* alphas, void* deltas, void* stream) {
  if (K <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = 2 * m;
  const int T = static_cast<int>((K + kRows - 1) / kRows);
  const merge_scan::Carry cy(carry, T, P);
  const int64_t* ev = static_cast<const int64_t*>(events);
  int32_t* tb = static_cast<int32_t*>(table);
  bucket_index<<<static_cast<unsigned>((nb + 256) / 256), 256, 0, st>>>(
      ev, K, nb, tb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t sort_smem = static_cast<size_t>(nbins + 1) * sizeof(int32_t);
  bin_sort<<<static_cast<unsigned>(C), kSortThreads, sort_smem, st>>>(
      ev, K, nb, tb, static_cast<const int64_t*>(t0),
      static_cast<const int64_t*>(t1), static_cast<const int64_t*>(s),
      static_cast<const int64_t*>(r), E, Ec, nbins, kLgRows + lg_tiles,
      static_cast<int32_t*>(rows), static_cast<uint64_t*>(recs),
      static_cast<int32_t*>(seg), cy.buf, cy.zero_from(), cy.words());
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = merge_scan::block_threads(P);
  const size_t shmem = static_cast<size_t>(kRows) * threads * sizeof(int32_t);
  {  // the dynamic size, past 48 KB with the static part included
    e = cudaFuncSetAttribute(tile_scan,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tile_scan<<<static_cast<unsigned>(T), threads, shmem, st>>>(
      static_cast<const uint64_t*>(recs), static_cast<const int32_t*>(seg), C,
      Ec, nbins, lg_tiles, K, T, m, P, carry,
      StoreFix{ev, static_cast<int64_t*>(alphas),
               static_cast<int64_t*>(deltas)});
  return static_cast<int>(cudaGetLastError());
}
