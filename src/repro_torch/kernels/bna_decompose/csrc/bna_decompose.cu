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
// Design: one block per matrix (lane), one thread per sender/receiver
// (w <= 1024), and each block runs its own lane to the end; the lanes are
// independent, so no lock-step across blocks is needed.
//   * state in shared memory: row and col loads, the matching both ways
//     (msr, mrs), the receivers of real edges, and for the search the
//     per-sender pointer, parent senders and the DFS stack (8 int32 arrays
//     of w); plus three bit sets of 32-bit words: the support of d (bit
//     (s, r) set while d[s, r] > 0; w * w / 8 bytes, 8 KB at w = 256),
//     the slack receivers (col[r] < D) and the visited receivers.  The
//     demand values, 256 KB at w = 256, do not fit a block's 227 KB, so a
//     working copy stays in device memory (L2-resident) and is read and
//     updated only at the matched entries;
//   * step: as the bna_step kernel (K1): one thread per sender gathers its
//     matched entry, one block min gives t, d/row/col/D are updated at the
//     matched entries (a support bit is cleared when its entry drains),
//     and invalid[s] marks matched edges that left the filled graph; each
//     warp then ballots its 32 receivers' slack bits;
//   * repair, when any edge is invalid: the invalid edges are cleared in
//     parallel, then warp 0 augments every unmatched sender in increasing
//     order with the reference's pointer-scan DFS (augment_one): from the
//     sender s on top of the stack, each lane takes one word of
//     (support[s] | slack, if row[s] < D) & ~visited, masked to
//     ptr[s] <= r < k, and one ballot finds the first receiver that is
//     admissible and unvisited, 1024 receivers at a time, all in shared
//     memory; a free receiver ends the search and lane 0 flips the
//     augmenting walk.  This visits the receivers in the reference's
//     order, so the matchings, and with them the pieces, are the
//     reference's.
//
// Bound on the card: latency.  The function's bytes are the input stack
// and the step stacks written once; the work is a chain of dependent steps
// per lane (t depends on the previous step's matching), and the repair is
// a serial search run by one warp.  The design keeps that chain on the SM:
// no host round trip and no launch per step, one block per lane so lanes
// run side by side on the 132 SMs, and the search reads shared memory
// only.
//
// Storage: steps past T_out are run but not stored (the wrapper reruns
// with a larger T_out if a lane took more); after a lane's last step its
// rows up to T_out are written as t = 0, piece = -1, so every lane's stack
// is the reference's up to T_out.  All arithmetic is int32 and exact under
// the caller's guard (every row and column load below 2^31 - 1); offsets
// are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>

namespace {

constexpr int kNoMatch = -1;
constexpr int32_t kBig = 2147483647;
constexpr unsigned kFull = 0xffffffffu;

struct Lane {
  int nw;          // 32-bit words per bit-set row: ceil(w / 32)
  int32_t* row;
  int32_t* col;
  int32_t* msr;
  int32_t* mrs;
  int32_t* ptr;
  int32_t* par;
  int32_t* stk;
  int32_t* recv;
  uint32_t* supp;    // [w][nw]: bit (s, r) while d[s, r] > 0
  uint32_t* cslack;  // [nw]: bit r while col[r] < D
  uint32_t* visw;    // [nw]: receivers visited by the current search
};

__host__ __device__ size_t shared_words(int w) {
  const size_t nw = (w + 31) / 32;
  return 8 * static_cast<size_t>(w) + static_cast<size_t>(w) * nw + 2 * nw;
}

// block-wide min or max of one int32 per thread
__device__ int32_t block_reduce(int32_t v, bool take_max, int32_t* part) {
  for (int off = 16; off > 0; off >>= 1) {
    const int32_t o = __shfl_down_sync(kFull, v, off);
    v = take_max ? max(v, o) : min(v, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // part[] may still be read by the previous reduction
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    v = lane < nwarps ? part[lane] : (take_max ? INT32_MIN : kBig);
    for (int off = 16; off > 0; off >>= 1) {
      const int32_t o = __shfl_down_sync(kFull, v, off);
      v = take_max ? max(v, o) : min(v, o);
    }
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  return part[0];
}

// Each warp publishes its 32 receivers' slack bits (col[r] < D); all
// threads of the block call it.
__device__ void publish_slack(const Lane& L, int w, int32_t Dv) {
  const int s = threadIdx.x;
  const bool slack = s < w && L.col[s] < Dv;
  const unsigned bits = __ballot_sync(kFull, slack);
  if ((s & 31) == 0) L.cslack[s >> 5] = bits;
}

// Pointer-scan Kuhn search from unmatched sender `start`, run by warp 0
// (all 32 lanes).  On success the augmenting walk is flipped into msr/mrs.
__device__ void augment(int start, int k, int32_t Dv, const Lane& L) {
  const int lane = threadIdx.x & 31;
  const int kw = (k + 31) >> 5;
  for (int i = lane; i < kw; i += 32) L.visw[i] = 0;
  for (int i = lane; i < k; i += 32) L.ptr[i] = 0;
  if (lane == 0) L.stk[0] = start;
  __syncwarp();
  int depth = 1, end_r = kNoMatch;
  while (depth > 0) {
    const int s = L.stk[depth - 1];
    const int p = L.ptr[s];
    const uint32_t slack_mask = L.row[s] < Dv ? ~0u : 0u;
    const uint32_t* srow = L.supp + static_cast<int64_t>(s) * L.nw;
    int r = kNoMatch;
    for (int base = p >> 5; base < kw; base += 32) {
      const int j = base + lane;
      uint32_t word = 0;
      if (j < kw) {
        word = (srow[j] | (L.cslack[j] & slack_mask)) & ~L.visw[j];
        if (j == (p >> 5)) word &= ~0u << (p & 31);         // r >= ptr[s]
        if (j == kw - 1 && (k & 31)) word &= (1u << (k & 31)) - 1;  // r < k
      }
      const unsigned bal = __ballot_sync(kFull, word != 0);
      if (bal) {
        const int src = __ffs(bal) - 1;
        const uint32_t wv = __shfl_sync(kFull, word, src);
        r = ((base + src) << 5) + __ffs(wv) - 1;
        break;
      }
    }
    if (r == kNoMatch) {  // frontier exhausted: pop
      --depth;
      continue;
    }
    const int nxt = L.mrs[r];
    __syncwarp();
    if (lane == 0) {
      L.visw[r >> 5] |= 1u << (r & 31);
      L.par[r] = s;
      L.ptr[s] = r + 1;
      if (nxt != kNoMatch) L.stk[depth] = nxt;
    }
    __syncwarp();
    if (nxt == kNoMatch) {
      end_r = r;
      break;
    }
    ++depth;
  }
  if (end_r != kNoMatch && lane == 0) {
    int r = end_r;
    while (true) {
      const int ps = L.par[r];
      const int prev_r = L.msr[ps];
      L.msr[ps] = r;
      L.mrs[r] = ps;
      if (ps == start) break;
      r = prev_r;
    }
  }
  __syncwarp();
}

// Augment every unmatched sender below k, in increasing order (warp 0).
// A search leaves every other unmatched sender unmatched (it only re-pairs
// matched senders), so the unmatched senders of a 32-sender slice can be
// read once and taken in order.
__device__ void augment_unmatched(int k, int32_t Dv, const Lane& L) {
  if ((threadIdx.x >> 5) != 0) return;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < k; base += 32) {
    __syncwarp();
    const int s = base + lane;
    unsigned todo = __ballot_sync(kFull, s < k && L.msr[s] == kNoMatch);
    while (todo) {
      augment(base + __ffs(todo) - 1, k, Dv, L);
      todo &= todo - 1;
    }
  }
}

__global__ void bna_decompose_kernel(const int32_t* __restrict__ d,
                                     const int32_t* __restrict__ ks,
                                     int32_t* __restrict__ work,
                                     int32_t* __restrict__ ts,
                                     int32_t* __restrict__ pieces,
                                     int32_t* __restrict__ D_final,
                                     int32_t* __restrict__ nsteps, int w,
                                     int T_cap, int T_out) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t part[32];
  const int nw = (w + 31) >> 5;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + 8 * w);
  Lane L{nw,           smem,         smem + w,     smem + 2 * w,
         smem + 3 * w, smem + 4 * w, smem + 5 * w, smem + 6 * w,
         smem + 7 * w, bits,         bits + w * nw, bits + w * nw + nw};

  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int lane = s & 31, warp = s >> 5, nwarps = blockDim.x >> 5;
  const int k = ks[b];
  const int64_t ww = static_cast<int64_t>(w) * w;
  const int32_t* db = d + b * ww;
  int32_t* dw = work + b * ww;
  for (int64_t i = s; i < ww; i += blockDim.x) dw[i] = db[i];

  // row loads and support bits, one warp per row (coalesced reads)
  for (int rs = warp; rs < w; rs += nwarps) {
    int32_t sum = 0;
    for (int j = 0; j < nw; ++j) {
      const int c = (j << 5) + lane;
      const int32_t v = c < w ? db[static_cast<int64_t>(rs) * w + c] : 0;
      sum += v;
      const unsigned nz = __ballot_sync(kFull, v > 0);
      if (lane == 0) L.supp[rs * nw + j] = nz;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(kFull, sum, off);
    if (lane == 0) L.row[rs] = sum;
  }
  int32_t cs = 0;
  if (s < w) {
    for (int j = 0; j < w; ++j) cs += db[static_cast<int64_t>(j) * w + s];
    L.col[s] = cs;
    L.msr[s] = kNoMatch;
    L.mrs[s] = kNoMatch;
  }
  __syncthreads();
  int32_t Dv = block_reduce(s < w ? max(L.row[s], cs) : 0, true, part);
  publish_slack(L, w, Dv);
  __syncthreads();
  if (Dv > 0) augment_unmatched(k, Dv, L);
  __syncthreads();

  int i = 0;
  int32_t* ts_b = ts + static_cast<int64_t>(b) * T_out;
  int32_t* pc_b = pieces + static_cast<int64_t>(b) * T_out * w;
  while (Dv > 0 && i < T_cap) {
    int ms = kNoMatch;
    int32_t dm = 0;
    bool real = false;
    if (s < w) {
      ms = L.msr[s];
      if (ms != kNoMatch) dm = dw[static_cast<int64_t>(s) * w + ms];
      real = ms != kNoMatch && dm > 0;
      L.recv[s] = 0;
    }
    __syncthreads();
    if (real) L.recv[ms] = 1;
    __syncthreads();
    int32_t local = kBig;
    bool recv_s = false;
    if (s < w) {
      recv_s = L.recv[s] != 0;
      local = real ? dm : Dv - L.row[s];
      if (!recv_s) local = min(local, Dv - L.col[s]);
    }
    const int32_t t = block_reduce(local, false, part);
    const int32_t Dn = Dv - t;
    if (real) {
      dw[static_cast<int64_t>(s) * w + ms] = dm - t;
      if (dm == t) L.supp[s * nw + (ms >> 5)] &= ~(1u << (ms & 31));
      L.row[s] -= t;
    }
    if (recv_s) L.col[s] -= t;
    if (i < T_out) {
      if (s < w) pc_b[static_cast<int64_t>(i) * w + s] = real ? ms : kNoMatch;
      if (s == 0) ts_b[i] = t;
    }
    publish_slack(L, w, Dn);
    __syncthreads();
    bool inv = false;
    if (ms != kNoMatch && (real ? dm - t : dm) == 0 && Dn > 0)
      inv = L.row[s] >= Dn || L.col[ms] >= Dn;
    Dv = Dn;
    ++i;
    if (__syncthreads_or(inv)) {
      if (inv) {
        L.mrs[ms] = kNoMatch;
        L.msr[s] = kNoMatch;
      }
      __syncthreads();
      augment_unmatched(k, Dv, L);
      __syncthreads();
    }
  }
  // rows after the lane's last step: no-op steps, as in the reference
  for (int j = i; j < T_out; ++j) {
    if (s < w) pc_b[static_cast<int64_t>(j) * w + s] = kNoMatch;
    if (s == 0) ts_b[j] = 0;
  }
  if (s == 0) {
    D_final[b] = Dv;
    nsteps[b] = i;
  }
}

}  // namespace

// d: (B, w, w) int32 input (not modified); work: (B, w, w) int32 scratch;
// ts: (B, T_out), pieces: (B, T_out, w), D_final, nsteps: (B,) int32.
// Returns the first CUDA error of the launch, or 0.
extern "C" int bna_decompose_launch(void* d, void* ks, void* work, void* ts,
                                    void* pieces, void* D_final,
                                    void* nsteps, int B, int w, int T_cap,
                                    int T_out, void* stream) {
  if (B <= 0) return 0;
  const int threads = ((w + 31) / 32) * 32;
  const size_t shmem = shared_words(w) * sizeof(int32_t);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bna_decompose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bna_decompose_kernel<<<B, threads, shmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(d), static_cast<const int32_t*>(ks),
      static_cast<int32_t*>(work), static_cast<int32_t*>(ts),
      static_cast<int32_t*>(pieces), static_cast<int32_t*>(D_final),
      static_cast<int32_t*>(nsteps), w, T_cap, T_out);
  return static_cast<int>(cudaGetLastError());
}
