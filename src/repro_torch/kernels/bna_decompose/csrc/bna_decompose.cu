// bna_decompose: a whole width bucket's BNA decomposition (paper
// Algorithm 1 in filled-matrix form), step AND augmenting-path repair, in
// one launch: (d (B, w, w), ks (B,)) -> per lane the step lengths ts, the
// matched receivers of every step (pieces), the final D and the step count.
//
// Replaces the reference's compiled bucket program
// src/repro/core/pipeline.py::_build_decompose (an XLA program, not a
// Pallas kernel: a lax.while_loop over the batched step with a vmapped
// pointer-scan Kuhn repair).  In separate launches that program would be
// millions of launches a plan (steps x senders x search steps), so on the
// card it is one kernel.
//
// What bounds it: latency.  The function's bytes (the stack read once, the
// steps written once) take microseconds; the work is one chain of
// dependent steps per lane (t depends on the previous step's matching),
// and each repair is a serial Kuhn search.  Lanes are independent and run
// side by side, so the kernel's time is its longest lane's chain.  On the
// paper's workload that chain is mostly search: at scale 0.25 (bucket
// w = 256, 29 lanes) the longest lane takes 2674 steps, 3111 searches and
// 240,057 search iterations (219,747 receiver visits and 20,310 pops); at
// scale 1.0 the longest takes 8575 steps.  An iteration is a chain of two
// dependent shared-memory loads (the top sender's support word and row-
// slack mask, then mrs[r]), one __clz and one redux.sync, and a step a
// few more loads, so the design floor is the longest lane's dependent
// shared-memory round trips times one round trip; chip_smoke.py phase 15
// reports it, and the kernel's ns per iteration and per step, beside the
// bytes bound.
//
// Design (w <= 1024): one warp per lane, four lanes a block (one a block
// at w = 1024), and no block barrier anywhere: a warp runs its lane to the
// end alone.
//   * Ownership: lane l of the warp owns senders and receivers l, l + 32,
//     l + 64, ...; their loads (row, col), the matching both ways, the
//     matched value dmv[s] = d[s, msr[s]] and the row-slack mask live in
//     shared memory.  The kernel is instantiated per owned count (w up to
//     32, 64, ..., 1024), so a step unrolls over its PER senders, holds
//     their values in registers and issues each phase's loads together.
//     The support of d is a bit set in shared memory (w rows of ceil(w/32)
//     words: 8 KB at w = 256); a lane takes about 17 KB at w = 256.
//   * The matched value stays beside the matching: a step decrements dmv
//     in shared memory and never reads device memory.  The working copy
//     of d (device memory, L2-resident) is read only when a repair gives a
//     sender a new match, all of a repair's reads before its write-backs of
//     the old entries, so they overlap.  (Not a register across steps: a
//     repair rewrites the matching through shared memory, and the owners
//     reload it with their other values in one batch.)
//   * Step: a receiver receives when its matched sender's edge is real,
//     read through the inverse matching (mrs, then that sender's dmv); t
//     is one warp min (redux.sync); the slack sets are rebuilt from the
//     owners' registers.  A step stores its row of pieces and its t and
//     nothing else to device memory.
//   * Search state off the chain: the visited and column-slack sets are
//     one 32-bit word per lane in registers (receivers 32 l .. 32 l + 31),
//     and each sender's row-slack mask is a word loaded beside its support
//     word.  Receiver bit sets are stored bit-reversed, so a word's lowest
//     receiver is its leading-zero count; the first admissible unvisited
//     receiver is each lane's lowest candidate and one warp min, whose
//     result is uniform, so the search's branches need no reconvergence.
//     The top sender is a register that every lane computes alike; the DFS
//     stack and the parent of each visited receiver are written by EVERY
//     lane with the same value, so each lane reads back what it wrote and
//     no __syncwarp is needed between iterations (each search step's warp
//     min keeps the lanes within one step of each other, so no lane
//     rewrites a slot that another has yet to read).  (The flip of the
//     augmenting walk reads msr before it writes it, so lane 0 walks it
//     between two __syncwarp, once per successful search.)
//   * The per-sender pointer of the reference's pointer-scan search is
//     not stored: every receiver below a sender's pointer is inadmissible
//     or already visited, so the first admissible unvisited receiver from
//     0 is the one the pointer scan finds.  The search visits the
//     receivers in the reference's order, senders are repaired in
//     increasing order, and the matchings, and with them the pieces, are
//     the reference's.
//   Slower on the H100, and not used: a shared bit set of receiving ports
//   built with atomicOr (same-word atomics serialize); finding the first
//   receiver by ballot, __ffs and shuffle (two more dependent warp
//   operations); and every lane scanning the whole row itself with no warp
//   operation (the lanes then drift apart by whole steps, so the stack
//   needs a single keeper lane).
//
// Past 1024 senders (the wide layout, correctness first): the visited and
// column-slack sets hold ceil(w / 1024) words a lane, so they leave the
// registers, and the support (w^2 / 8 bytes: 512 KB at w = 2048) leaves
// shared memory.  All of a lane's state then lives in a device-memory
// scratch that the wrapper allocates (L2-resident at the sizes a plan
// reaches), not in a cluster's distributed shared memory: a cluster holds
// at most 16 x 227 KB, which caps w near 5500, while device memory takes
// any w the plain version takes.  The code is the same, with the owners
// looping over their senders at run time; a search scans the words 32 at
// a time, and every lane writes the visited and slack words itself.
//
// Storage: steps past T_out are run but not stored (the wrapper reruns
// with a larger T_out if a lane took more); after a lane's last step its
// rows up to T_out are written as t = 0, piece = -1, so every lane's stack
// is the reference's up to T_out.  All arithmetic is int32 and exact under
// the caller's guard (every row and column load below 2^31 - 1); offsets
// are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNoMatch = -1;
constexpr int32_t kBig = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFastMaxW = 1024;     // bit sets of one word a lane
constexpr int kLanesPerBlock = 4;   // one warp per SM sub-partition
constexpr size_t kSmemPerBlock = 232448;

// One lane's state: 9 arrays of w (row and col loads, the matching both
// ways, the matched value and the receiver it belongs to, the parent
// sender of each visited receiver, the DFS stack, each sender's row-slack
// mask), the support bit set (w rows of nw words), a zero word, and in the
// wide layout the visited and column-slack sets (nw words each).  Receiver
// bit sets are stored bit-reversed: receiver r is bit 31 - r % 32 of word
// r / 32, so the lowest receiver of a word is its highest set bit, which
// one __clz finds.
struct Lane {
  int w, nw, k;
  int32_t* row;
  int32_t* col;
  int32_t* msr;
  int32_t* mrs;
  int32_t* dmv;     // d[s, mcache[s]], 0 while unmatched
  int32_t* mcache;  // the receiver dmv[s] belongs to
  int32_t* par;
  int32_t* stk;
  uint32_t* rsm;    // [w]: ~0 while row[s] < D, else 0
  uint32_t* supp;   // [w][nw]: bit (s, r) while d[s, r] > 0, r < k
  uint32_t* zero;   // one word, 0: the support row of lanes past nw
  uint32_t* vis;    // [nw] (wide): receivers visited by the search
  uint32_t* cs;     // [nw] (wide): receivers r < k with col[r] < D
};

__host__ __device__ inline size_t lane_words(int w, bool wide) {
  const size_t nw = (static_cast<size_t>(w) + 31) / 32;
  return 9 * static_cast<size_t>(w) + static_cast<size_t>(w) * nw + 1 +
         (wide ? 2 * nw : 0);
}

__device__ Lane carve(int32_t* base, int w, int k, bool wide) {
  Lane L;
  L.w = w;
  L.nw = (w + 31) >> 5;
  L.k = k;
  L.row = base;
  L.col = base + w;
  L.msr = base + 2 * w;
  L.mrs = base + 3 * w;
  L.dmv = base + 4 * w;
  L.mcache = base + 5 * w;
  L.par = base + 6 * w;
  L.stk = base + 7 * w;
  L.rsm = reinterpret_cast<uint32_t*>(base + 8 * w);
  L.supp = L.rsm + w;
  L.zero = L.supp + static_cast<int64_t>(w) * L.nw;
  L.vis = wide ? L.zero + 1 : nullptr;
  L.cs = wide ? L.vis + L.nw : nullptr;
  return L;
}

// receiver r's bit in its (bit-reversed) word
__device__ __forceinline__ uint32_t rbit(int r) {
  return 0x80000000u >> (r & 31);
}

// The lowest receiver over the warp's bit-reversed words (lane l's word
// holds receivers base_l .. base_l + 31), or kNoMatch: each lane's lowest
// is its word's leading zeros, then one warp min.
__device__ __forceinline__ int warp_first(uint32_t word, int base) {
  const int cand = word ? base + __clz(word) : kBig;
  const int r = __reduce_min_sync(kFull, cand);
  return r == kBig ? kNoMatch : r;
}

// The search's bit sets for w <= 1024: lane l holds word l in registers.
struct RegBits {
  uint32_t vis = 0, cs = 0;
  const uint32_t* srow;  // word `lane` of support row 0, or the zero word
  int stride;            // nw, or 0 past nw

  __device__ __forceinline__ void bind(const Lane& L, int lane) {
    srow = lane < L.nw ? L.supp + lane : L.zero;
    stride = lane < L.nw ? L.nw : 0;
  }

  __device__ __forceinline__ void clear_vis(const Lane&, int) { vis = 0; }

  // first receiver r < k, in increasing order, that is admissible for s
  // (d[s, r] > 0, or row[s] < D and col[r] < D) and not visited: each
  // lane's lowest candidate, then one warp min (its result is uniform, so
  // the search's branches need no reconvergence)
  __device__ __forceinline__ int first(const Lane& L, int s, int lane) {
    return warp_first((srow[s * stride] | (cs & L.rsm[s])) & ~vis,
                      lane << 5);
  }

  __device__ __forceinline__ void visit(const Lane&, int r, int lane) {
    if (lane == (r >> 5)) vis |= rbit(r);
  }

  __device__ __forceinline__ void publish(const Lane&, int j, uint32_t csb,
                                          int lane) {
    if (lane == j) cs = csb;
  }
};

// The wide layout's bit sets, in the lane's scratch; every lane writes
// every word, so each reads back its own writes.
struct MemBits {
  __device__ __forceinline__ void bind(const Lane&, int) {}

  __device__ __forceinline__ void clear_vis(const Lane& L, int) {
    for (int j = 0; j < L.nw; ++j) L.vis[j] = 0;
  }

  __device__ __forceinline__ int first(const Lane& L, int s, int lane) {
    const uint32_t rsm = L.rsm[s];
    const uint32_t* srow = L.supp + static_cast<int64_t>(s) * L.nw;
    for (int base = 0; base < L.nw; base += 32) {
      const int j = base + lane;
      uint32_t word = 0;
      if (j < L.nw) word = (srow[j] | (L.cs[j] & rsm)) & ~L.vis[j];
      const int r = warp_first(word, j << 5);
      if (r != kNoMatch) return r;
    }
    return kNoMatch;
  }

  __device__ __forceinline__ void visit(const Lane& L, int r, int) {
    L.vis[r >> 5] |= rbit(r);
  }

  __device__ __forceinline__ void publish(const Lane& L, int j, uint32_t csb,
                                          int) {
    L.cs[j] = csb;
  }
};

// Rebuild the slack sets for effective size Dv: each owner's row-slack
// masks, and column-slack word j (receivers 32 j .. 32 j + 31, r < k) by
// ballot of their owners.
template <class Bits>
__device__ void publish_slack(const Lane& L, Bits& bits, int32_t Dv,
                              int lane) {
  for (int j = 0; j < L.nw; ++j) {
    const int p = (j << 5) + lane;
    if (p < L.w) L.rsm[p] = L.row[p] < Dv ? ~0u : 0u;
    bits.publish(L, j, __brev(__ballot_sync(kFull, p < L.k && L.col[p] < Dv)),
                 lane);
  }
}

// Pointer-scan Kuhn search from unmatched sender `start`, run by the whole
// warp alike; on success the augmenting walk is flipped into msr/mrs.
template <class Bits>
__device__ void augment(int start, const Lane& L, Bits& bits, int lane) {
  bits.clear_vis(L, lane);
  L.stk[0] = start;
  int depth = 1, s = start, end_r = kNoMatch;
  while (true) {
    const int r = bits.first(L, s, lane);
    if (r == kNoMatch) {  // s's frontier is exhausted: pop
      if (--depth == 0) break;
      s = L.stk[depth - 1];
      continue;
    }
    const int nxt = L.mrs[r];
    bits.visit(L, r, lane);
    L.par[r] = s;
    if (nxt == kNoMatch) {
      end_r = r;
      break;
    }
    L.stk[depth++] = nxt;
    s = nxt;
  }
  if (end_r == kNoMatch) return;
  // the flip reads msr before it writes it, so one lane walks it, after
  // every lane has read the matching and before any reads it again
  __syncwarp();
  if (lane == 0) {
    for (int r = end_r; r != kNoMatch;) {
      const int ps = L.par[r];
      const int prev_r = L.msr[ps];
      L.msr[ps] = r;
      L.mrs[r] = ps;
      r = ps == start ? kNoMatch : prev_r;
    }
  }
  __syncwarp();
}

// Sender s (its owner) brings its matched value along when a repair gave it
// a new match: the old entry goes back to the working copy, and `nv`, the
// new entry read from it, becomes the matched value.
__device__ __forceinline__ void swap_match(const Lane& L,
                                           int32_t* __restrict__ wb, int s,
                                           int32_t nv) {
  const int ms = L.msr[s], mc = L.mcache[s];
  if (ms == mc) return;
  if (mc != kNoMatch) wb[static_cast<int64_t>(s) * L.w + mc] = L.dmv[s];
  L.dmv[s] = nv;
  L.mcache[s] = ms;
}

// Augment every unmatched sender below k, in increasing order.  A search
// leaves every other unmatched sender unmatched (it only re-pairs matched
// senders), so the unmatched senders of a 32-sender slice can be read once
// and taken in order.  Then each owner brings its matched value along: the
// old entry goes back to the working copy, the new one comes from it.
// PER > 0: lane l owns senders l + 32 j, j < PER (unrolled); 0: any w.
template <int PER, class Bits>
__device__ void repair(const Lane& L, Bits& bits, int32_t* __restrict__ wb,
                       int lane) {
  __syncwarp();
  for (int base = 0; base < L.k; base += 32) {
    const int s = base + lane;
    unsigned todo = __ballot_sync(kFull, s < L.k && L.msr[s] == kNoMatch);
    while (todo) {
      augment(base + __ffs(todo) - 1, L, bits, lane);
      todo &= todo - 1;
    }
  }
  __syncwarp();
  if constexpr (PER > 0) {
    // every load before any write-back (a sender's new and old entries
    // differ, and senders own their rows), so the loads overlap
    int32_t nv[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int s = lane + 32 * j;
      const int ms = s < L.w ? L.msr[s] : kNoMatch;
      nv[j] = ms != kNoMatch && ms != L.mcache[s]
                  ? wb[static_cast<int64_t>(s) * L.w + ms] : 0;
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int s = lane + 32 * j;
      if (s < L.w) swap_match(L, wb, s, nv[j]);
    }
  } else {
    for (int s = lane; s < L.w; s += 32)
      swap_match(L, wb, s,
                 L.msr[s] != kNoMatch && L.msr[s] != L.mcache[s]
                     ? wb[static_cast<int64_t>(s) * L.w + L.msr[s]] : 0);
  }
  __syncwarp();  // dmv of other owners, read by the next step
}

// receiver r receives in this step: its matched sender's edge is real
__device__ __forceinline__ bool receives(const Lane& L, int r) {
  const int m = L.mrs[r];
  return m != kNoMatch && L.dmv[m] > 0;
}

// One step of the lane for w <= 1024, each owner's values in registers
// (lane l's senders and receivers l + 32 j, j < PER), so every phase's
// loads go out together.  Stores the step's row of pieces; returns t.
// `any_inv`: some matched edge drained and left the filled graph; such
// edges are already unmatched.
template <int PER>
__device__ int32_t step_regs(const Lane& L, RegBits& bits, int32_t Dv,
                             int lane, int i, int T_out,
                             int32_t* __restrict__ pc_b, bool& any_inv) {
  int ms[PER], mr[PER];
  int32_t dm[PER], rw[PER], cl[PER];
  unsigned real = 0, rcv = 0, inv = 0;  // bit j: sender/receiver lane + 32 j
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int s = lane + 32 * j;
    const bool in = s < L.w;
    ms[j] = in ? L.msr[s] : kNoMatch;
    mr[j] = in ? L.mrs[s] : kNoMatch;
    dm[j] = in ? L.dmv[s] : 0;
    rw[j] = in ? L.row[s] : 0;
    cl[j] = in ? L.col[s] : 0;
  }
  // receiver r receives when its matched sender's edge is real
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (ms[j] != kNoMatch && dm[j] > 0) real |= 1u << j;
    if (mr[j] != kNoMatch && L.dmv[mr[j]] > 0) rcv |= 1u << j;
  }
  int32_t local = kBig;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (lane + 32 * j >= L.w) continue;
    local = min(local, (real >> j) & 1u ? dm[j] : Dv - rw[j]);
    if (!((rcv >> j) & 1u)) local = min(local, Dv - cl[j]);
  }
  const int32_t t = __reduce_min_sync(kFull, local);
  const int32_t Dn = Dv - t;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int s = lane + 32 * j;
    if (s >= L.w) continue;
    const bool rl = (real >> j) & 1u;
    if (rl) {
      dm[j] -= t;
      L.dmv[s] = dm[j];
      if (dm[j] == 0) L.supp[s * L.nw + (ms[j] >> 5)] &= ~rbit(ms[j]);
      rw[j] -= t;
      L.row[s] = rw[j];
    }
    if ((rcv >> j) & 1u) {
      cl[j] -= t;
      L.col[s] = cl[j];
    }
    if (i < T_out) pc_b[static_cast<int64_t>(i) * L.w + s] = rl ? ms[j]
                                                                : kNoMatch;
  }
  // the slack sets for Dn, from the registers
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int p = lane + 32 * j;
    if (p < L.w) L.rsm[p] = rw[j] < Dn ? ~0u : 0u;
    bits.publish(L, j, __brev(__ballot_sync(kFull, p < L.k && cl[j] < Dn)),
                 lane);
  }
  __syncwarp();  // col of other owners' receivers
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (ms[j] != kNoMatch && dm[j] == 0 && Dn > 0 &&
        (rw[j] >= Dn || L.col[ms[j]] >= Dn))
      inv |= 1u << j;
  any_inv = __any_sync(kFull, inv != 0);
  if (any_inv) {
    __syncwarp();  // every owner has read col before an mrs changes
#pragma unroll
    for (int j = 0; j < PER; ++j)
      if ((inv >> j) & 1u) {
        L.mrs[ms[j]] = kNoMatch;
        L.msr[lane + 32 * j] = kNoMatch;
      }
  }
  return t;
}

// The same step for any w (the wide layout): the owners loop over their
// senders and read them from the lane's state in each phase.
template <class Bits>
__device__ int32_t step_any(const Lane& L, Bits& bits, int32_t Dv, int lane,
                            int i, int T_out, int32_t* __restrict__ pc_b,
                            bool& any_inv) {
  const int w = L.w;
  int32_t local = kBig;
  for (int s = lane; s < w; s += 32) {
    const int ms = L.msr[s];
    const int32_t dm = L.dmv[s];
    local = min(local, ms != kNoMatch && dm > 0 ? dm : Dv - L.row[s]);
    if (!receives(L, s)) local = min(local, Dv - L.col[s]);
  }
  const int32_t t = __reduce_min_sync(kFull, local);
  const int32_t Dn = Dv - t;
  for (int s = lane; s < w; s += 32)
    if (receives(L, s)) L.col[s] -= t;
  __syncwarp();  // every receiver has read dmv before the senders change it
  for (int s = lane; s < w; s += 32) {
    const int ms = L.msr[s];
    const int32_t dm = L.dmv[s];
    const bool real = ms != kNoMatch && dm > 0;
    if (real) {
      L.dmv[s] = dm - t;
      if (dm == t)
        L.supp[static_cast<int64_t>(s) * L.nw + (ms >> 5)] &= ~rbit(ms);
      L.row[s] -= t;
    }
    if (i < T_out) pc_b[static_cast<int64_t>(i) * w + s] = real ? ms
                                                                : kNoMatch;
  }
  publish_slack(L, bits, Dn, lane);
  __syncwarp();  // col of other owners' receivers
  bool inv = false;
  for (int s = lane; s < w && Dn > 0; s += 32) {
    const int ms = L.msr[s];
    inv |= ms != kNoMatch && L.dmv[s] == 0 &&
           (L.row[s] >= Dn || L.col[ms] >= Dn);
  }
  any_inv = __any_sync(kFull, inv);
  if (any_inv) {
    __syncwarp();  // every owner has read col before an mrs changes
    for (int s = lane; s < w && inv; s += 32) {
      const int ms = L.msr[s];
      if (ms != kNoMatch && L.dmv[s] == 0 &&
          (L.row[s] >= Dn || L.col[ms] >= Dn)) {
        L.mrs[ms] = kNoMatch;
        L.msr[s] = kNoMatch;
      }
    }
  }
  return t;
}

// PER > 0: w <= 32 PER <= 1024, a lane's state in shared memory and its
// bit sets in registers; PER = 0: the wide layout.
template <int PER>
__global__ void bna_decompose_kernel(const int32_t* __restrict__ d,
                                     const int32_t* __restrict__ ks,
                                     int32_t* __restrict__ work,
                                     int32_t* __restrict__ state,
                                     int32_t* __restrict__ ts,
                                     int32_t* __restrict__ pieces,
                                     int32_t* __restrict__ D_final,
                                     int32_t* __restrict__ nsteps, int B,
                                     int w, int T_cap, int T_out) {
  constexpr bool kWide = PER == 0;
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp: nothing below waits on the block
  const int k = ks[b];
  const Lane L = kWide ? carve(state + b * lane_words(w, true), w, k, true)
                       : carve(smem + warp * lane_words(w, false), w, k,
                               false);
  typename std::conditional<kWide, MemBits, RegBits>::type bits;
  bits.bind(L, lane);
  if (lane == 0) *L.zero = 0;
  const int nw = L.nw;
  const int64_t ww = static_cast<int64_t>(w) * w;
  const int32_t* __restrict__ db = d + b * ww;
  int32_t* __restrict__ wb = work + b * ww;

  // the working copy, row and col loads and the support, 8 words of a row
  // at a time (eight loads in flight a lane)
  for (int s = lane; s < w; s += 32) {
    L.row[s] = 0;
    L.msr[s] = L.mrs[s] = L.mcache[s] = kNoMatch;
    L.dmv[s] = 0;
  }
  for (int c0 = 0; c0 < nw; c0 += 8) {
    int32_t cacc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int s = 0; s < w; ++s) {
      const int64_t rowoff = static_cast<int64_t>(s) * w;
      int32_t v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int r = ((c0 + q) << 5) + lane;
        v[q] = r < w ? db[rowoff + r] : 0;
      }
      int32_t sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int r = ((c0 + q) << 5) + lane;
        if (r < w) wb[rowoff + r] = v[q];
        sum += v[q];
        cacc[q] += v[q];
        const unsigned nz = __brev(__ballot_sync(kFull, r < k && v[q] > 0));
        if (lane == q && c0 + q < nw) L.supp[s * static_cast<int64_t>(nw) +
                                             c0 + q] = nz;
      }
      sum = __reduce_add_sync(kFull, sum);
      if (lane == (s & 31)) L.row[s] += sum;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = ((c0 + q) << 5) + lane;
      if (r < w) L.col[r] = cacc[q];
    }
  }
  int32_t mx = 0;
  for (int s = lane; s < w; s += 32) mx = max(mx, max(L.row[s], L.col[s]));
  int32_t Dv = __reduce_max_sync(kFull, mx);
  publish_slack(L, bits, Dv, lane);
  if (Dv > 0) repair<PER>(L, bits, wb, lane);

  int i = 0;
  int32_t* ts_b = ts + static_cast<int64_t>(b) * T_out;
  int32_t* pc_b = pieces + static_cast<int64_t>(b) * T_out * w;
  while (Dv > 0 && i < T_cap) {
    bool any_inv;
    int32_t t;
    if constexpr (kWide)
      t = step_any(L, bits, Dv, lane, i, T_out, pc_b, any_inv);
    else
      t = step_regs<PER>(L, bits, Dv, lane, i, T_out, pc_b, any_inv);
    if (lane == 0 && i < T_out) ts_b[i] = t;
    Dv -= t;
    ++i;
    if (any_inv) repair<PER>(L, bits, wb, lane);
  }
  // rows after the lane's last step: no-op steps, as in the reference
  for (int j = i; j < T_out; ++j) {
    for (int s = lane; s < w; s += 32)
      pc_b[static_cast<int64_t>(j) * w + s] = kNoMatch;
    if (lane == 0) ts_b[j] = 0;
  }
  if (lane == 0) {
    D_final[b] = Dv;
    nsteps[b] = i;
  }
}

struct Layout {
  int lanes;         // lanes (warps) per block
  size_t smem;       // dynamic shared memory per block, bytes
  size_t state;      // int32 scratch words per lane (wide layout), or 0
};

Layout layout(int B, int w) {
  Layout lay;
  if (w <= kFastMaxW) {
    const size_t per = lane_words(w, false) * sizeof(int32_t);
    size_t fit = per ? kSmemPerBlock / per : kLanesPerBlock;
    lay.lanes = static_cast<int>(fit < kLanesPerBlock ? fit : kLanesPerBlock);
    lay.state = 0;
  } else {
    lay.lanes = kLanesPerBlock;
    lay.state = lane_words(w, true);
  }
  if (B > 0 && B < lay.lanes) lay.lanes = B;
  lay.smem = w <= kFastMaxW ? lay.lanes * lane_words(w, false) *
                                  sizeof(int32_t)
                            : 0;
  return lay;
}

struct Args {
  const int32_t* d;
  const int32_t* ks;
  int32_t *work, *state, *ts, *pieces, *D_final, *nsteps;
  int B, w, T_cap, T_out;
};

template <int PER>
int launch(const Args& a, const Layout& lay, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((a.B + lay.lanes - 1) /
                                                lay.lanes);
  if (lay.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bna_decompose_kernel<PER>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(lay.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bna_decompose_kernel<PER><<<blocks, 32 * lay.lanes, lay.smem, st>>>(
      a.d, a.ks, a.work, a.state, a.ts, a.pieces, a.D_final, a.nsteps, a.B,
      a.w, a.T_cap, a.T_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch's layout for a (B, w, w) bucket: lanes per block, dynamic
// shared memory per block (bytes), and the int32 scratch words per lane
// that the wrapper allocates as `state` (0 for w <= 1024).
extern "C" int bna_decompose_layout(int B, int w, int* lanes,
                                    long long* smem_bytes,
                                    long long* state_words) {
  const Layout lay = layout(B, w);
  *lanes = lay.lanes;
  *smem_bytes = static_cast<long long>(lay.smem);
  *state_words = static_cast<long long>(lay.state);
  return 0;
}

// d: (B, w, w) int32 input (not modified); work: (B, w, w) int32 scratch;
// state: B * state_words int32 scratch (w > 1024; may be null otherwise);
// ts: (B, T_out), pieces: (B, T_out, w), D_final, nsteps: (B,) int32.
// Returns the first CUDA error of the launch, or 0.
extern "C" int bna_decompose_launch(void* d, void* ks, void* work,
                                    void* state, void* ts, void* pieces,
                                    void* D_final, void* nsteps, int B,
                                    int w, int T_cap, int T_out,
                                    void* stream) {
  if (B <= 0) return 0;
  const Args a{static_cast<const int32_t*>(d),   static_cast<const int32_t*>(ks),
               static_cast<int32_t*>(work),      static_cast<int32_t*>(state),
               static_cast<int32_t*>(ts),        static_cast<int32_t*>(pieces),
               static_cast<int32_t*>(D_final),   static_cast<int32_t*>(nsteps),
               B, w, T_cap, T_out};
  const Layout lay = layout(B, w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w > kFastMaxW) return launch<0>(a, lay, st);
  const int per = (w + 31) / 32;  // senders a lane owns
  if (per > 16) return launch<32>(a, lay, st);
  if (per > 8) return launch<16>(a, lay, st);
  if (per > 4) return launch<8>(a, lay, st);
  if (per > 2) return launch<4>(a, lay, st);
  if (per > 1) return launch<2>(a, lay, st);
  return launch<1>(a, lay, st);
}
