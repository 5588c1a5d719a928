// ssd_scan_bwd: the gradient of the Mamba2 SSD chunked scan (K5's backward):
// the entry points for both types, and for float32 inputs four kernels of
// float32 FMAs (1-4 below).  bfloat16 inputs go to the tensor-core kernels
// of ssd_scan_bwd_mma.cu (5-9).  Both are sources of the ssd_scan library:
// they are compiled beside ssd_scan.cu into one shared object.
//
// Replaces no Pallas kernel: the reference trains through jax.grad of its
// plain chunked form (src/repro/models/ssm.py, _ssd_chunked_jnp), and its
// Pallas forward (src/repro/kernels/ssd_scan/ssd_scan.py) has no backward.
// These kernels compute what jax.vjp of _ssd_chunked_jnp computes.
//
// Per (batch, head) and chunk c of length L, with cum the in-chunk prefix
// sum of la = log(max(a, 1e-37)), tot = cum[L-1], h_c the state entering
// chunk c (the forward's scratch after its kernels 1-2, kept for the
// backward) and G_c the gradient of the state leaving it:
//   1. chunk   U_c = sum_i e^cum_i c_i dy_i^T                    (N x P)
//   2. pass    G_last = 0, G_(c-1) = U_c + e^tot_c G_c, serial over the
//              chunks in reverse (the mirror of the forward's kernel 2)
//   3. chunk   dx_j = sum_(i>=j) (c_i.b_j) e^(cum_i-cum_j) dy_i
//                     + e^(tot-cum_j) G_c^T b_j
//              db_j = sum_(i>=j) (dy_i.x_j) e^(cum_i-cum_j) c_i
//                     + e^(tot-cum_j) G_c x_j                  (per head)
//              dc_i = sum_(j<=i) (dy_i.x_j) e^(cum_i-cum_j) b_j
//                     + e^cum_i h_c dy_i                        (per head)
//              dla_t = sum_(i>=t>j) Q_ij
//                      + sum_(i>=t) e^cum_i dy_i.(h_c^T c_i)
//                      + sum_(j<t) e^(tot-cum_j) b_j^T G_c x_j
//                      + e^tot <h_c, G_c>
//              with Q_ij = (dy_i.x_j)(c_i.b_j) e^(cum_i-cum_j), and
//              da = dla / a above a = 1e-37, 0 at and under that floor
//              (ref.py says why the reference's autodiff gives no usable
//              number there)
//   4. group   db, dc summed over each state group's heads
// Kernel 1 writes U_c as float32 into a (B, nC, H, N, P) scratch that
// kernel 2 overwrites in place with G_c; kernel 3 (one block per (chunk,
// head, batch)) writes dx, da and float32 per-head partials of db and dc,
// (B, S, H, N) each; kernel 4 sums the partials over the group's heads.
//
// Determinism: no atomics; every sum runs in a fixed order (the chunk pass
// in reverse chunk order, a group's heads in head order, block reductions
// as fixed shuffle trees and serial scans), so two runs give the same bits,
// which the training path's bit-exact resume needs.
//
// Kernel 3 holds C B^T and dY X^T (L x L, float32) in shared memory; their
// lower triangles, decayed, feed dx, db and dc as matrix products, and their
// product feeds dla.  The first term of dla, the sum over the rectangle
// i >= t > j, is the scan M(0) = 0, M(t+1) = M(t) + sum_(i>t) Q_it -
// sum_(j<t) Q_tj (the plain version sums the rectangle directly).
// e^(cum_i - cum_j) is taken only where i >= j: for i < j the exponent is
// positive and may overflow.  dla is computed from these pairwise terms, not
// as dy.y - x.dx from a y read back in bf16, which cancels.
//
// The products are float32 FMAs from shared memory: 256 threads a block, a
// thread an 8-row x TN-column tile of the output (two float4 reads of A and
// TN / 4 of B a step), operands staged 32 deep through tiles with a row
// stride of 132 floats (16-byte aligned rows).  Kernel 3 computes C B^T and
// dY X^T as whole L x L squares; in its products with their lower triangles
// each warp runs only its own part of the triangle, over an operand staged
// whole (no barrier inside), and the two warps on one scheduler hold
// complementary row blocks, so the skipped upper half is work saved.
// (TF32 would not hold float32's tolerance, 1e-4, as in the forward.)
//
// Bound on the card: mamba2-2.7b's shape (B = 4, S = 4096, H = 80, N =
// 128, P = 64) needs about 15 MFLOP a (batch, head, chunk), 0.15 TFLOP a
// layer; the chunk gradients read the float32 states and their gradients
// (0.67 GB), so the bound is bytes.  chip_smoke.py computes both bounds (for
// bf16, the training path's type: ssd_scan_bwd_mma.cu).
//
// Strides: x, b and c are read through their (batch, seq, head or group)
// strides with 64-bit offsets (the views models.ssm splits out of one
// projection); dy, loga, a and the outputs are dense.  S is a multiple of L
// (the wrapper pads with a = 1 and zeros), L, N, P <= 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_chunk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;     // largest L, N, P
constexpr int kLd = 132;       // row stride (floats) of the squares and tiles
constexpr int kKt = 32;        // depth of a staged tile
constexpr int kPassU = 8;      // chunks the reverse pass loads ahead
constexpr float kFloor = 1e-37f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A thread's place in a 128-row output: rows row0 + r (r < 8), columns
// col(q) = 4 tx + (q & 3) + 64 (q >> 2).  Warp w takes the 16 rows of block
// w (w < 4) or 11 - w, so the two warps that share a scheduler (w, w + 4)
// hold blocks b and 7 - b: in a product over a triangle each scheduler gets
// the same work.
struct Place {
  int row0, tx, lo;   // lo: the warp's first row
  __device__ __forceinline__ explicit Place(int tid) {
    const int warp = tid >> 5, lane = tid & 31;
    const int blk = warp < 4 ? warp : 11 - warp;
    lo = 16 * blk;
    row0 = lo + 8 * (lane >> 4);
    tx = lane & 15;
  }
  __device__ __forceinline__ int col(int q) const {
    return 4 * tx + (q & 3) + 64 * (q >> 2);
  }
};

// The staging loads go out kBatch at a time a thread, all in flight before
// the first store: one latency of device memory (or L2) a batch, not one a
// value
constexpr int kBatch = 16;

// stage[kk][r] = rscale[r] kscale[k] src[r][k] for k = k0 + kk, kk < kKt,
// from a source whose k index is contiguous (row r at r * rstride); zero
// past R rows or K.  A warp reads 32 consecutive k of a row.
__device__ __forceinline__ void stage_rk(float* stg, const float* src,
                                         long long rstride, int R, int K,
                                         int k0, const float* rscale,
                                         const float* kscale, int tid) {
  constexpr int kPer = kKt * kMaxL / kThreads;
  static_assert(kPer == kBatch, "one batch a tile");
  const int kk = tid % kKt, k = k0 + kk;
  float v[kPer];
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    const int r = tid / kKt + it * (kThreads / kKt);
    v[it] = (r < R && k < K) ? src[r * rstride + k] : 0.f;
  }
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    const int r = tid / kKt + it * (kThreads / kKt);
    float s = v[it];
    if (r < R && k < K) {
      if (rscale != nullptr) s *= rscale[r];
      if (kscale != nullptr) s *= kscale[k];
    }
    stg[kk * kLd + r] = s;
  }
}

// stage[kk][col] = kscale[k] src[k][col] for k = k0 + kk, kk < DEPTH, from
// a source whose column index is contiguous (row k at k * kstride); zero
// past C columns or K.  Consecutive threads read consecutive columns.
template <int DEPTH>
__device__ __forceinline__ void stage_kc(float* stg, const float* src,
                                         long long kstride, int C, int K,
                                         int k0, const float* kscale,
                                         int tid) {
  constexpr int kPer = DEPTH * kMaxL / kThreads;
  static_assert(kPer % kBatch == 0, "whole batches");
  const int col = tid % kMaxL;
#pragma unroll
  for (int b0 = 0; b0 < kPer; b0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int k = k0 + tid / kMaxL + (b0 + it) * (kThreads / kMaxL);
      v[it] = (col < C && k < K) ? src[k * kstride + col] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int kk = tid / kMaxL + (b0 + it) * (kThreads / kMaxL);
      const int k = k0 + kk;
      float s = v[it];
      if (kscale != nullptr && col < C && k < K) s *= kscale[k];
      stg[kk * kLd + col] = s;
    }
  }
}

// acc[r][q] += sum_(k0 <= k < k1) A(row0 + r, k) Bm(k, col(q)), both from
// shared memory, k-major: A(row, k) = pa[k * kLd + row], Bm(k, col) =
// pb[k * kLd + col]; two float4 reads of A and TN / 4 of Bm a step
template <int TN>
__device__ __forceinline__ void fma_tile(float (&acc)[8][TN], const float* pa,
                                         const float* pb, int k0, int k1,
                                         const Place& pl) {
#pragma unroll 2
  for (int k = k0; k < k1; ++k) {
    const float4 a0 = ld4(pa + k * kLd + pl.row0);
    const float4 a1 = ld4(pa + k * kLd + pl.row0 + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[TN];
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const float4 b = ld4(pb + k * kLd + 4 * pl.tx + 64 * h);
      bv[4 * h] = b.x;
      bv[4 * h + 1] = b.y;
      bv[4 * h + 2] = b.z;
      bv[4 * h + 3] = b.w;
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < TN; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

template <int TN>
__device__ __forceinline__ void zero(float (&acc)[8][TN]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[r][q] = 0.f;
}

// row dot of the tile with v[row][col] (columns < C), summed over the 16
// threads of the row in a fixed shuffle tree; written to out[row] by the
// thread with tx = 0 for rows < R
template <int TN>
__device__ __forceinline__ void row_dots(const float (&acc)[8][TN],
                                         const float* v, long long vstride,
                                         int R, int C, float* out,
                                         const Place& pl) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = pl.row0 + r;
    float s = 0.f;
    if (row < R) {
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        const int col = pl.col(q);
        if (col < C) s = fmaf(acc[r][q], v[row * vstride + col], s);
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (pl.tx == 0 && row < R) out[row] = s;
  }
}

template <int TN>
__device__ __forceinline__ void store_tile(const float (&acc)[8][TN],
                                           float* dst, long long rstride,
                                           int R, int C, const Place& pl) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = pl.row0 + r;
    if (row >= R) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int col = pl.col(q);
      if (col < C) dst[row * rstride + col] = acc[r][q];
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 1: U_c = sum_i e^cum_i c_i dy_i^T, one block per (chunk, head, batch)
// ---------------------------------------------------------------------------

struct StateLayout {   // floats: As, Bs [kKt][kLd]; cum, e^cum [128]
  static constexpr size_t floats() { return 2 * kKt * kLd + 2 * kMaxL; }
};

template <int TNP>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk_state(const float* __restrict__ cm, const float* __restrict__ dy,
                    const float* __restrict__ loga, float* __restrict__ u,
                    Dims dm, Strides cs) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + kKt * kLd;
  float* cum = Bs + kKt * kLd;
  float* ecum = cum + kMaxL;
  const int tid = threadIdx.x, lane = tid & 31;
  const Place pl(tid);
  const int cc = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int c0 = cc * dm.L;
  const int grp = hh / dm.rep;
  const long long dys = static_cast<long long>(dm.H) * dm.P;   // dy's seq
  const float* cg = cm + bb * cs.b + grp * cs.h + c0 * cs.s;
  const float* dyb = dy + (static_cast<long long>(bb) * dm.S + c0) * dys +
                 static_cast<long long>(hh) * dm.P;
  if (tid < 32) {
    chunk_cum(cum, loga + (static_cast<long long>(bb) * dm.S + c0) * dm.H + hh,
              dm.H, dm.L, lane);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 4; ++r) ecum[4 * lane + r] = expf(cum[4 * lane + r]);
  }
  float acc[8][TNP];
  zero(acc);
  // A(n, i) = e^cum_i c[i][n], Bm(i, p) = dy[i][p]
  for (int k0 = 0; k0 < dm.L; k0 += kKt) {
    __syncthreads();
    stage_kc<kKt>(As, cg, cs.s, dm.N, dm.L, k0, ecum, tid);
    stage_kc<kKt>(Bs, dyb, dys, dm.P, dm.L, k0,
                  static_cast<const float*>(nullptr), tid);
    __syncthreads();
    fma_tile(acc, As, Bs, 0, min(kKt, dm.L - k0), pl);
  }
  float* ub = u + ((static_cast<long long>(bb) * dm.nC + cc) * dm.H + hh) *
                      dm.N * dm.P;
  store_tile(acc, ub, static_cast<long long>(dm.P), dm.N, dm.P, pl);
}

// ---------------------------------------------------------------------------
// kernel 2: the reverse pass over the chunks, in place
// ---------------------------------------------------------------------------

// A thread walks one element of a (batch, head)'s N x P over the chunks from
// the last, its loads kPassU chunks ahead: slot c holds U_c on entry and G_c
// (the gradient of the state leaving chunk c) on exit
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass(float* __restrict__ g, const float* __restrict__ decay, int H,
             int NP, int nC) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= NP) return;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * nC * H + hh;
  float run = 0.f;
  for (int c1 = nC; c1 > 0; c1 -= kPassU) {
    float uv[kPassU], dv[kPassU];
#pragma unroll
    for (int k = 0; k < kPassU; ++k) {
      const int ci = c1 - 1 - k;
      if (ci >= 0) {
        const long long bch = bh + static_cast<long long>(ci) * H;
        uv[k] = g[bch * NP + e];
        dv[k] = decay[bch];
      }
    }
#pragma unroll
    for (int k = 0; k < kPassU; ++k) {
      const int ci = c1 - 1 - k;
      if (ci >= 0) {
        const long long bch = bh + static_cast<long long>(ci) * H;
        g[bch * NP + e] = run;
        run = fmaf(expf(dv[k]), run, uv[k]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 3: dx, da and the per-head db, dc of one (chunk, head, batch)
// ---------------------------------------------------------------------------

// floats: S1, S2 [128][kLd] (C B^T and dY X^T, then their decayed lower
// triangles; S1 later the transpose of S2's); R [128][kLd] (two staged
// tiles As, Bs, or one whole L-row operand); cum, e^cum, e^(tot - cum), the
// row and column sums of Q, the two inter-chunk dot terms, a and da [128]
// each; a reduction slot a warp
struct ChunkLayout {
  static constexpr size_t floats() {
    return 3 * kMaxL * kLd + 9 * kMaxL + kThreads / 32;
  }
};

template <int TNP>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk(const float* __restrict__ x, const float* __restrict__ a,
              const float* __restrict__ loga, const float* __restrict__ bm,
              const float* __restrict__ cm, const float* __restrict__ dy,
              const float* __restrict__ states,
              const float* __restrict__ grads, float* __restrict__ dx,
              float* __restrict__ da, float* __restrict__ dbp,
              float* __restrict__ dcp, Dims dm, Strides xs, Strides bs,
              Strides cs) {
  extern __shared__ float4 smem4[];
  float* S1 = reinterpret_cast<float*>(smem4);
  float* S2 = S1 + kMaxL * kLd;
  float* R = S2 + kMaxL * kLd;
  float* As = R;
  float* Bs = R + kKt * kLd;
  float* cum = R + kMaxL * kLd;
  float* ecum = cum + kMaxL;       // e^cum_i
  float* wdec = ecum + kMaxL;      // e^(tot - cum_j)
  float* rowq = wdec + kMaxL;      // sum_(j<t) Q_tj
  float* colq = rowq + kMaxL;      // sum_(i>t) Q_it
  float* rsum = colq + kMaxL;      // e^(tot-cum_j) b_j^T G x_j
  float* isum = rsum + kMaxL;      // e^cum_i dy_i.(h^T c_i)
  float* av = isum + kMaxL;        // a_t
  float* dav = av + kMaxL;         // da_t
  float* red = dav + kMaxL;        // [kThreads / 32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Place pl(tid);
  const int cc = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int L = dm.L, N = dm.N, P = dm.P;
  const int c0 = cc * L;
  const int grp = hh / dm.rep;
  const long long hp = static_cast<long long>(dm.H) * P;   // dy, dx seq
  const long long hn = static_cast<long long>(dm.H) * N;   // dbp, dcp seq
  const long long row0 = static_cast<long long>(bb) * dm.S + c0;
  const float* xb = x + bb * xs.b + hh * xs.h + c0 * xs.s;
  const float* bg = bm + bb * bs.b + grp * bs.h + c0 * bs.s;
  const float* cg = cm + bb * cs.b + grp * cs.h + c0 * cs.s;
  const float* dyb = dy + row0 * hp + static_cast<long long>(hh) * P;
  const long long sbase =
      ((static_cast<long long>(bb) * dm.nC + cc) * dm.H + hh) * N * P;
  const float* hb = states + sbase;
  const float* gb = grads + sbase;
  const float* noscale = nullptr;
  // a warp's k range in a product over the lower triangle: k >= its first
  // row (A(row, k) nonzero for k >= row) or k <= its last (for k <= row)
  const int kfrom = min(pl.lo, L), kto = min(pl.lo + 16, L);

  if (warp == 0) {
    chunk_cum(cum, loga + row0 * dm.H + hh, dm.H, L, lane);
    __syncwarp();
    const float tot = cum[L - 1];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = 4 * lane + r;
      ecum[t] = expf(cum[t]);
      wdec[t] = expf(tot - cum[t]);
    }
  } else if (warp < 5) {
    const int t = tid - 32;
    av[t] = t < L ? a[(row0 + t) * dm.H + hh] : 1.f;
  }

  float acc[8][8];

  // C B^T -> S1, dY X^T -> S2 (raw)
  zero(acc);
  for (int k0 = 0; k0 < N; k0 += kKt) {
    __syncthreads();
    stage_rk(As, cg, cs.s, L, N, k0, noscale, noscale, tid);
    stage_rk(Bs, bg, bs.s, L, N, k0, noscale, noscale, tid);
    __syncthreads();
    fma_tile(acc, As, Bs, 0, min(kKt, N - k0), pl);
  }
  store_tile(acc, S1, static_cast<long long>(kLd), kMaxL, kMaxL, pl);
  zero(acc);
  for (int k0 = 0; k0 < P; k0 += kKt) {
    __syncthreads();
    stage_rk(As, dyb, hp, L, P, k0, noscale, noscale, tid);
    stage_rk(Bs, xb, xs.s, L, P, k0, noscale, noscale, tid);
    __syncthreads();
    fma_tile(acc, As, Bs, 0, min(kKt, P - k0), pl);
  }
  store_tile(acc, S2, static_cast<long long>(kLd), kMaxL, kMaxL, pl);
  __syncthreads();

  // Q's row sums (threads 0-127) and column sums (128-255) below the
  // diagonal, from the raw products: Q_ij = S1_ij S2_ij e^(cum_i - cum_j)
  {
    const int t = tid & (kMaxL - 1);
    float s = 0.f;
    if (t < L) {
      if (tid < kMaxL) {
        for (int j = 0; j < t; ++j)
          s += S1[t * kLd + j] * S2[t * kLd + j] * expf(cum[t] - cum[j]);
      } else {
        for (int i = t + 1; i < L; ++i)
          s += S1[i * kLd + t] * S2[i * kLd + t] * expf(cum[i] - cum[t]);
      }
    }
    (tid < kMaxL ? rowq : colq)[t] = s;
  }
  __syncthreads();
  // the decayed lower triangles, zero elsewhere
  for (int e = tid; e < kMaxL * kMaxL; e += kThreads) {
    const int i = e / kMaxL, j = e % kMaxL;
    const bool keep = i < L && j <= i;
    const float ev = keep ? expf(cum[i] - cum[j]) : 0.f;
    S1[i * kLd + j] = keep ? S1[i * kLd + j] * ev : 0.f;
    S2[i * kLd + j] = keep ? S2[i * kLd + j] * ev : 0.f;
  }

  // dx = (C B^T o E)^T dY + diag(e^(tot-cum)) B G, and rsum_j = x_j . (its
  // inter-chunk part)
  {
    float ax[8][TNP];
    zero(ax);
    for (int k0 = 0; k0 < N; k0 += kKt) {
      __syncthreads();
      stage_rk(As, bg, bs.s, L, N, k0, wdec, noscale, tid);
      stage_kc<kKt>(Bs, gb, static_cast<long long>(P), P, N, k0, noscale,
                    tid);
      __syncthreads();
      fma_tile(ax, As, Bs, 0, min(kKt, N - k0), pl);
    }
    row_dots(ax, xb, xs.s, L, P, rsum, pl);
    __syncthreads();
    stage_kc<kMaxL>(R, dyb, hp, P, L, 0, noscale, tid);
    __syncthreads();
    // A(j, i) = S1[i][j], nonzero for i >= j
    fma_tile(ax, S1, R, kfrom, L, pl);
    store_tile(ax, dx + row0 * hp + static_cast<long long>(hh) * P, hp, L, P,
               pl);
  }

  // db (this head's) = (dY X^T o E)^T C + diag(e^(tot-cum)) X G^T
  zero(acc);
  for (int k0 = 0; k0 < P; k0 += kKt) {
    __syncthreads();
    stage_rk(As, xb, xs.s, L, P, k0, wdec, noscale, tid);
    stage_rk(Bs, gb, static_cast<long long>(P), N, P, k0, noscale, noscale,
             tid);
    __syncthreads();
    fma_tile(acc, As, Bs, 0, min(kKt, P - k0), pl);
  }
  __syncthreads();
  stage_kc<kMaxL>(R, cg, cs.s, N, L, 0, noscale, tid);
  // S1 takes S2's transpose: S1[j][i] = S2[i][j] (S1 is read no more)
  for (int e = tid; e < kMaxL * kMaxL; e += kThreads) {
    const int i = e / kMaxL, j = e % kMaxL;
    S1[j * kLd + i] = S2[i * kLd + j];
  }
  __syncthreads();
  // A(j, i) = S2[i][j], nonzero for i >= j
  fma_tile(acc, S2, R, kfrom, L, pl);
  store_tile(acc, dbp + row0 * hn + static_cast<long long>(hh) * N, hn, L, N,
             pl);

  // dc (this head's) = (dY X^T o E) B + diag(e^cum) dY h^T, and isum_i =
  // c_i . (its inter-chunk part)
  zero(acc);
  for (int k0 = 0; k0 < P; k0 += kKt) {
    __syncthreads();
    stage_rk(As, dyb, hp, L, P, k0, ecum, noscale, tid);
    stage_rk(Bs, hb, static_cast<long long>(P), N, P, k0, noscale, noscale,
             tid);
    __syncthreads();
    fma_tile(acc, As, Bs, 0, min(kKt, P - k0), pl);
  }
  row_dots(acc, cg, cs.s, L, N, isum, pl);
  __syncthreads();
  stage_kc<kMaxL>(R, bg, bs.s, N, L, 0, noscale, tid);
  __syncthreads();
  // A(i, j) = S2[i][j] = S1[j][i], nonzero for j <= i
  fma_tile(acc, S1, R, 0, kto, pl);
  store_tile(acc, dcp + row0 * hn + static_cast<long long>(hh) * N, hn, L, N,
             pl);

  // <h, G>: a fixed stride per thread, a shuffle tree per warp, the warps
  // in order
  float hg = 0.f;
#pragma unroll 8
  for (int e = tid; e < N * P; e += kThreads) hg = fmaf(hb[e], gb[e], hg);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    hg += __shfl_xor_sync(0xffffffffu, hg, off);
  if (lane == 0) red[warp] = hg;
  __syncthreads();

  // dla and da, one thread, t in order; da leaves from every thread
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
    const float carry = expf(cum[L - 1]) * total;
    float suf = 0.f;                 // isum becomes its suffix sums
    for (int t = L - 1; t >= 0; --t) {
      suf += isum[t];
      isum[t] = suf;
    }
    float m = 0.f, pre = 0.f;
    for (int t = 0; t < L; ++t) {
      const float dla = m + isum[t] + pre + carry;
      m += colq[t] - rowq[t];
      pre += rsum[t];
      dav[t] = av[t] > kFloor ? dla / av[t] : 0.f;
    }
  }
  __syncthreads();
  if (tid < L) da[(row0 + tid) * dm.H + hh] = dav[tid];
}

// ---------------------------------------------------------------------------
// kernel 4: db, dc = the per-head partials summed over each group's heads
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_sum(const float* __restrict__ dbp, const float* __restrict__ dcp,
                  float* __restrict__ db, float* __restrict__ dc,
                  long long total,
                  int H, int G, int N, int rep) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= total) return;
  const int n = static_cast<int>(e % N);
  const long long rg = e / N;                       // (b s) * G + g
  const int g = static_cast<int>(rg % G);
  const long long row = rg / G;                     // b * S + s
  const long long base = (row * H + static_cast<long long>(g) * rep) * N + n;
  float sb = 0.f, sc = 0.f;
  for (int r = 0; r < rep; ++r) {
    sb += dbp[base + static_cast<long long>(r) * N];
    sc += dcp[base + static_cast<long long>(r) * N];
  }
  db[e] = sb;
  dc[e] = sc;
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

bool dims_ok(int G, int H, int N, int P, int L, int S) {
  return G > 0 && H % G == 0 && N > 0 && P > 0 && L > 0 && L <= kMaxL &&
         N <= kMaxL && P <= kMaxL && S % L == 0;
}

template <int TNP>
int state_t(const void* c, const void* dy, const void* loga,
            const void* decay, void* grads, int B, const Dims& dm,
            Strides cs, cudaStream_t st) {
  const size_t smem = StateLayout::floats() * 4;
  cudaError_t err = allow_smem(ssd_bwd_chunk_state<TNP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* g = static_cast<float*>(grads);
  ssd_bwd_chunk_state<TNP><<<dim3(dm.nC, dm.H, B), kThreads, smem, st>>>(
      static_cast<const float*>(c), static_cast<const float*>(dy),
      static_cast<const float*>(loga), g, dm, cs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int NP = dm.N * dm.P;
  ssd_bwd_pass<<<dim3((NP + kThreads - 1) / kThreads, dm.H, B), kThreads, 0,
                 st>>>(g, static_cast<const float*>(decay), dm.H, NP, dm.nC);
  return static_cast<int>(cudaGetLastError());
}

template <int TNP>
int chunk_t(const void* x, const void* a, const void* loga, const void* b,
            const void* c, const void* dy, const void* states,
            const void* grads, void* dx, void* da, void* dbp, void* dcp,
            void* db, void* dc, int B, int G, const Dims& dm, Strides xs,
            Strides bs, Strides cs, cudaStream_t st) {
  const size_t smem = ChunkLayout::floats() * 4;
  cudaError_t err = allow_smem(ssd_bwd_chunk<TNP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk<TNP><<<dim3(dm.nC, dm.H, B), kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(loga), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(dy),
      static_cast<const float*>(states), static_cast<const float*>(grads),
      static_cast<float*>(dx), static_cast<float*>(da),
      static_cast<float*>(dbp), static_cast<float*>(dcp), dm, xs, bs, cs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * dm.S * G * dm.N;
  const long long blocks = (total + kThreads - 1) / kThreads;
  ssd_bwd_group_sum<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const float*>(dbp), static_cast<const float*>(dcp),
      static_cast<float*>(db), static_cast<float*>(dc), total, dm.H, G, dm.N,
      dm.rep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the bf16 kernels, in ssd_scan_bwd_mma.cu
namespace ssd_bwd_mma {
int parts(int rep);
int state(const void* c, const void* dy, const void* loga, const void* decay,
          void* grads, int B, int S, int H, int G, int P, int N, int L,
          long long csb, long long css, long long csh, cudaStream_t st);
int chunk(const void* x, const void* a, const void* loga, const void* b,
          const void* c, const void* dy, const void* states,
          const void* grads, void* dx, void* da, void* dsuf, void* dbp,
          void* dcp, void* db, void* dc, int B, int S, int H, int G, int P,
          int N, int L, long long xsb, long long xss, long long xsh,
          long long bsb, long long bss, long long bsh, long long csb,
          long long css, long long csh, cudaStream_t st);
bool entry(int kernel, int L, int N, int P, const char** name,
           const void** fn, long long* smem);
}  // namespace ssd_bwd_mma

// grads (B, S / L, H, N, P) float32, dense, gets G_c, the gradient of the
// state leaving each chunk.  c is (B, S, G, N) through its (batch, seq,
// group) strides; dy (B, S, H, P) dense, c's type (bf16 when is_bf16, else
// float32); loga (B, S, H) and decay (B, S / L, H, the forward's summed log
// decay a chunk) float32, dense.  bf16: one launch (kernel 5, G rounded to
// TF32); float32: kernels 1 and 2.
extern "C" int ssd_bwd_state_launch(const void* c, const void* dy,
                                    const void* loga, const void* decay,
                                    void* grads, int is_bf16, int B, int S,
                                    int H, int G, int P, int N, int L,
                                    long long csb, long long css,
                                    long long csh, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (!dims_ok(G, H, N, P, L, S))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims dm{S, H, H / G, P, N, L, S / L};
  const Strides cs{csb, css, csh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ssd_bwd_mma::state(c, dy, loga, decay, grads, B, S, H, G, P, N, L,
                              csb, css, csh, st);
  return P <= 64
             ? state_t<4>(c, dy, loga, decay, grads, B, dm, cs, st)
             : state_t<8>(c, dy, loga, decay, grads, B, dm, cs, st);
}

// The rows of the db and dc partials a (batch, seq, group): a head's each
// for float32 (kernel 3), a slice of heads' each for bf16 (kernels 7, 8).
extern "C" int ssd_bwd_parts(int is_bf16, int H, int G) {
  if (G <= 0 || H % G != 0) return -1;
  return is_bf16 ? ssd_bwd_mma::parts(H / G) : H / G;
}

// dx (B, S, H, P, x's type), da (B, S, H, float32), db and dc (B, S, G, N,
// b's type), all dense; dbp and dcp (B, S, G, parts, N) float32 scratch for
// the partials (parts from ssd_bwd_parts), dsuf (B, S, H) float32 scratch
// (bf16 only).  x, b, c through their strides; a (padded with 1), loga,
// states and grads (B, S / L, H, N, P) float32 dense.  Kernels 6-9 (bf16)
// or 3 and 4 (float32).
extern "C" int ssd_bwd_chunk_launch(
    const void* x, const void* a, const void* loga, const void* b,
    const void* c, const void* dy, const void* states, const void* grads,
    void* dx, void* da, void* dsuf, void* dbp, void* dcp, void* db, void* dc,
    int is_bf16, int B, int S, int H, int G, int P, int N, int L,
    long long xsb, long long xss, long long xsh, long long bsb,
    long long bss, long long bsh, long long csb, long long css,
    long long csh, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (!dims_ok(G, H, N, P, L, S))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims dm{S, H, H / G, P, N, L, S / L};
  const Strides xs{xsb, xss, xsh}, bs{bsb, bss, bsh}, cs{csb, css, csh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return ssd_bwd_mma::chunk(x, a, loga, b, c, dy, states, grads, dx, da,
                              dsuf, dbp, dcp, db, dc, B, S, H, G, P, N, L, xsb,
                              xss, xsh, bsb, bss, bsh, csb, css, csh, st);
  return P <= 64
             ? chunk_t<4>(x, a, loga, b, c, dy, states, grads, dx, da,
                                 dbp, dcp, db, dc, B, G, dm, xs, bs, cs, st)
             : chunk_t<8>(x, a, loga, b, c, dy, states, grads, dx, da,
                                 dbp, dcp, db, dc, B, G, dm, xs, bs, cs, st);
}

// The backward's kernels, by number, in the one table the name and the
// attributes lookups read (ops.BWD_KERNELS lists each wrapper's): float32 1
// (chunk state gradients), 2 (reverse pass), 3 (chunk gradients), 4 (group
// sum) here; bf16 on the tensor cores 5-9 in ssd_scan_bwd_mma.cu.  Kernel
// k's name, its function as a launch at chunk L, d_state N and d_head P
// runs it, and the dynamic shared memory that launch requests; false for
// another number.
static bool bwd_kernel(int kernel, int L, int N, int P, const char** name,
                       const void** fn, long long* smem) {
  const bool narrow = P <= 64;
  switch (kernel) {
    case 1:
      *name = "ssd_bwd_chunk_state";
      *fn = narrow ? reinterpret_cast<const void*>(ssd_bwd_chunk_state<4>)
                   : reinterpret_cast<const void*>(ssd_bwd_chunk_state<8>);
      *smem = StateLayout::floats() * 4;
      return true;
    case 2:
      *name = "ssd_bwd_pass";
      *fn = reinterpret_cast<const void*>(ssd_bwd_pass);
      *smem = 0;
      return true;
    case 3:
      *name = "ssd_bwd_chunk";
      *fn = narrow ? reinterpret_cast<const void*>(ssd_bwd_chunk<4>)
                   : reinterpret_cast<const void*>(ssd_bwd_chunk<8>);
      *smem = ChunkLayout::floats() * 4;
      return true;
    case 4:
      *name = "ssd_bwd_group_sum";
      *fn = reinterpret_cast<const void*>(ssd_bwd_group_sum);
      *smem = 0;
      return true;
    default:
      return ssd_bwd_mma::entry(kernel, L, N, P, name, fn, smem);
  }
}

// kernel k's name, or null for another number
extern "C" const char* ssd_bwd_kernel_name(int kernel) {
  const char* name;
  const void* fn;
  long long smem;
  return bwd_kernel(kernel, 128, 128, 64, &name, &fn, &smem) ? name
                                                             : nullptr;
}

// kernel k as a call at chunk L, d_state N and d_head P runs it: its
// registers a thread, its local memory a thread (spills), and the dynamic
// shared memory the launch requests
extern "C" int ssd_bwd_attributes(int kernel, int L, int N, int P, int* regs,
                                  int* local_bytes, long long* smem) {
  const char* name;
  const void* fn;
  if (!bwd_kernel(kernel, L, N, P, &name, &fn, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}
