// ssd_scan: the Mamba2 SSD chunked scan (state-space duality).  bfloat16
// inputs run one launch that walks the chunks on the tensor cores
// (ssd_walk_wgmma); float32 inputs run three chunk-parallel kernels of
// float32 FMAs.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py
// (_ssd_kernel, launched by ssd_scan_padded).  That kernel walks a
// (batch, head, chunk) grid whose chunk axis runs in order on one core,
// carrying the state h (N x P) in VMEM scratch from one chunk to the next.
//
// Per chunk c of length L, with cum the in-chunk prefix sum of log a:
//   state  s_c  = sum_j exp(cum_L - cum_j) b_j x_j^T        (N x P)
//   pass   h_0  = 0,  h_(c+1) = exp(cum_L of c) h_c + s_c
//   output y_i  = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) x_j
//                 + exp(cum_i) (c_i . h_c)
// exp(cum_i - cum_j) is taken only where i >= j: for i < j the exponent is
// positive and may overflow (the Pallas kernel zeroes it with where).
//
// Bound on the card: the algorithm's bytes (x read and y written, b, c and
// loga read; with kept states, the float32 state entering each chunk
// written): 0.052 ms at mamba2's B = 2, S = 4096, H = 80 and 0.204 ms at
// its training forward (B = 4, states kept) (chip_smoke.py's
// ssd_fwd_bounds).  The operations, at bf16's peak, are under it.
//
// bfloat16: ssd_walk_wgmma, one block (two warpgroups, 256 threads) a
// (batch, head, 64-column slice of P), as the TPU kernel's sequential chunk
// axis and the backward's state walk (ssd_scan_bwd_mma.cu) do it: the block
// walks the chunks in order with the state in float32 accumulators (as h^T,
// rows p, columns n), so no state goes to device memory unless the caller
// keeps it (the training forward: the state entering each chunk, rounded
// to TF32 as the backward's products take it, and each chunk's log decay;
// the wrapper allocates neither when nothing is kept).
//   * C, B and x chunk tiles come by TMA (4-d tensor maps over their
//     (batch, seq, head or group) strides; ops.py stages a view TMA cannot
//     describe) in the 128-byte swizzle through a ring of two stages under
//     mbarriers, so the next chunk's loads run under this chunk's products;
//     the warp whose release completes a stage refills it.
//   * Every product is a wgmma with float32 accumulators.  C B^T (bf16 as
//     loaded, both K-major) is made for each head: a block holds one (more
//     heads of a group would need their own w o X and h^T beside the ring,
//     past the 227 KB a block may have).  An operand the block computes (h, the decayed scores, w o X with w =
//     exp(cum_L - cum_j)) enters as its high and low bf16 parts, two
//     products, about 16 bits of mantissa (the three-kernel mma.sync design
//     took them in TF32, 10 bits; wgmma's TF32 form takes only K-major
//     operands, where X and B lie MN-major):
//       C h     C's rows (K-major) against h^T's parts (K-major, written
//               by the block), scaled by exp(cum_i) a row
//       C B^T   the scores; warpgroup 0's rows see keys 0..63 only
//       intra   the decayed, masked scores' parts as register A operands
//               against X read MN-major from its tile, 64 keys at a time
//               (the second half's scores made under the first's product)
//       state   h^T_(c+1) = exp(cum_L) h^T_c + (w o X)^T B, both operands
//               read MN-major from shared memory, retiring under y's
//               stores (a warpgroup's wgmma run in issue order: issued
//               with C h, it held the intra products back)
//   * The decay off a warp's diagonal is exp(cum_i - cum_i0) exp(cum_i0 -
//     cum_j), two factors <= 1: two exponentials an n8 tile, not eight.
//   * Shared memory: two stages of C, B (32 KB each) and x (16 KB), w o X and
//     h^T in two parts (16 KB each), cum of two chunks: 231,456 bytes, one
//     block an SM; 159 registers, no local memory.  Two block barriers a
//     chunk: after the products (h^T and w o X are then rewritten) and after
//     the rewrite.
//   * Grid: B * H * ceil(P / 64) blocks, heads fastest: 160 at mamba2's
//     serving B = 2 and 320 at its training B = 4 on the H100's 132 SMs.
//     The chunk-parallel alternative (a decoupled look-back over chunk
//     states) writes and reads the states in device memory; the walk keeps
//     them on chip.
//
// float32 (the checks and float32 configs): three kernels with float32 FMAs
// from shared memory (TF32 would not hold the float32 tolerance, 1e-4):
// kernel 1 (one block per (chunk, head, batch)) writes s_c to the wrapper's
// float32 scratch (B, nC, H, N, P) as 8 state rows x 4 columns a thread,
// and cum_L to (B, nC, H); kernel 2 (one thread per state element of a
// (batch, head), serial over the chunks) overwrites s_c with h_c, the state
// entering chunk c; kernel 3 computes y, the scores 16 rows at a time, then
// y with the inter term.
//
// Both: b and c are read for the head's state group h / (H / G), as the
// BlockSpec index maps do.  x, b and c are read through their (batch, seq,
// head or group) strides with 64-bit offsets; loga (B, S, H) and y
// (B, S, H, P) are dense.  S is a multiple of L (the wrapper pads with
// a = 1 and zero x, b, c, so padded steps pass the state through).
// L, N, P <= 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../flash_attention/csrc/hopper.cuh"
#include "../../flash_attention/csrc/tensor_core.cuh"
#include "ssd_chunk.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kMaxL = 128;
constexpr int kR = 16;        // FMA: rows of y (and of c and the scores) a tile
constexpr int kNB = 8;        // FMA: state rows a thread in the state product

// ---------------------------------------------------------------------------
// float32: the state recurrence over the chunks (kernel 2)
// ---------------------------------------------------------------------------

// A thread walks one state element of a (batch, head) over the chunks, its
// loads kPassU chunks ahead (each chunk's load is otherwise a DRAM round
// trip on the serial path).
constexpr int kPassU = 8;

__global__ void __launch_bounds__(kThreads)
ssd_pass(float* __restrict__ states, const float* __restrict__ decay, int H,
         int NP, int nC) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= NP) return;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const long long bh = static_cast<long long>(bb) * nC * H + hh;
  float run = 0.f;
  for (int c0 = 0; c0 < nC; c0 += kPassU) {
    float sv[kPassU], dv[kPassU];
#pragma unroll
    for (int u = 0; u < kPassU; ++u) {
      const long long bch = bh + static_cast<long long>(c0 + u) * H;
      if (c0 + u < nC) {
        sv[u] = states[bch * NP + e];
        dv[u] = decay[bch];
      }
    }
#pragma unroll
    for (int u = 0; u < kPassU; ++u) {
      const long long bch = bh + static_cast<long long>(c0 + u) * H;
      if (c0 + u < nC) {
        states[bch * NP + e] = run;          // the state entering c0 + u
        run = fmaf(expf(dv[u]), run, sv[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: one launch that walks the chunks (wgmma on TMA tiles)
// ---------------------------------------------------------------------------

constexpr int kWalkL = 128;        // chunk rows a tile: two warpgroups of 64
constexpr int kWalkN = 128;        // d_state columns a tile, zero past N
constexpr int kWalkP = 64;         // d_head columns a block (a slice of P)
constexpr int kWalkStages = 2;     // C, B and x tiles in flight

// shared memory of the walk, byte offsets from a 1024-aligned base, every
// tile bf16 in TMA's 128-byte swizzle: per stage C and B ([2 panels][128
// rows][64]) and x ([128][64]); w o X, high and low parts ([128][64] each);
// h^T, high and low parts ([2 panels of n][64 rows of p][64] each); then
// cum of two chunks ([2][128] floats) and the mbarriers (full, then empty,
// a stage): 231,456 bytes of the 232,448 a block may have
struct WalkSmem {
  static constexpr int kC = kWalkL * kWalkN * 2;
  static constexpr int kX = kWalkL * kWalkP * 2;
  static constexpr int kStage = 2 * kC + kX;
  static constexpr int kH = kWalkP * kWalkN * 2;
  static constexpr int wx = kWalkStages * kStage;   // hi, then lo
  static constexpr int ht = wx + 2 * kX;            // hi, then lo
  static constexpr int cum = ht + 2 * kH;
  static constexpr int bars = cum + 2 * kWalkL * 4;
  static constexpr int bytes = bars + 8 * 2 * kWalkStages + 1024;
};

// byte offset of 16-byte chunk ch (0..7) of row r of a 128-byte-swizzled
// panel (TMA's SWIZZLE_128B: chunk ch lands at ch ^ (r % 8))
__device__ __forceinline__ int sw128(int r, int ch) {
  return r * 128 + ((ch ^ (r & 7)) << 4);
}

// the k step kk of a K-major descriptor over a bf16 tile of `rows` rows:
// 32 bytes inside a panel, the next panel every four
__device__ __forceinline__ uint64_t walk_kstep(int rows, int kk) {
  return static_cast<uint64_t>((kk >> 2) * rows * 128 + (kk & 3) * 32) >> 4;
}

constexpr uint64_t kWalkMnStep = 2048 >> 4;   // 16 rows of an MN-major tile

// v as bf16 high and low parts, hi + lo = v to about 2^-17 |v|
__device__ __forceinline__ void split_bf16(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

__device__ __forceinline__ uint32_t bf16x2_bits(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// scores of 64 keys from k0 (sc, an m64n64 accumulator) decayed and
// masked, as the high and low bf16 parts of four k16 A fragments.  E =
// exp(cum_i - cum_j) for keys j <= row i: off the warp's diagonal as
// exp(cum_i - cum_i0) exp(cum_i0 - cum_j), i0 the warp's first row, two
// factors <= 1 (two exponentials an n8 tile, not eight); on it directly,
// and 0 above it
__device__ __forceinline__ void walk_decay(uint32_t (&ah)[4][4],
                                           uint32_t (&al)[4][4],
                                           float (&sc)[8][4], int k0,
                                           const float* cum, int i0, int g,
                                           int t) {
  const int ia = i0 + g;
  const float c0 = cum[i0], ca = cum[ia], cb = cum[ia + 8];
  const float ra = __expf(ca - c0), rb = __expf(cb - c0);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j0 = k0 + 8 * nt + 2 * t;
    if (k0 + 8 * nt + 8 <= i0) {
      const float d0 = __expf(c0 - cum[j0]), d1 = __expf(c0 - cum[j0 + 1]);
      sc[nt][0] *= ra * d0;
      sc[nt][1] *= ra * d1;
      sc[nt][2] *= rb * d0;
      sc[nt][3] *= rb * d1;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ia + (e >> 1) * 8, j = j0 + (e & 1);
        sc[nt][e] = j <= i
            ? sc[nt][e] * __expf(((e >> 1) ? cb : ca) - cum[j]) : 0.f;
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* v = sc[2 * kk + (q >> 1)] + 2 * (q & 1);
      bf16 h0, l0, h1, l1;
      split_bf16(v[0], h0, l0);
      split_bf16(v[1], h1, l1);
      ah[kk][q] = bf16x2_bits(h0, h1);
      al[kk][q] = bf16x2_bits(l0, l1);
    }
}

// y += (the decayed scores) X over 64 keys: their high and low parts as
// register A operands, X's rows k0 .. read MN-major from its TMA tile
__device__ __forceinline__ void walk_intra(float (&yacc)[8][4],
                                           uint32_t (&ah)[4][4],
                                           uint32_t (&al)[4][4],
                                           uint64_t xb) {
  hop::fence_regs(ah);
  hop::fence_regs(al);
  hop::fence_regs(yacc);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::wgmma_rs_tb(yacc, ah[kk], xb + kk * kWalkMnStep);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hop::wgmma_rs_tb(yacc, al[kk], xb + kk * kWalkMnStep);
  hop::wgmma_commit();
}

// the scores of 64 keys from key row k0 of B's tile: C's rows (A) against
// B's rows (B), both K-major
__device__ __forceinline__ void walk_scores(float (&sc)[8][4], uint64_t ca,
                                            uint64_t ba) {
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kWalkN / 16; ++kk)
    hop::wgmma_ss(sc, ca + walk_kstep(kWalkL, kk),
                  ba + walk_kstep(kWalkL, kk), kk > 0);
  hop::wgmma_commit();
}

// cum[0 .. 128) = prefix sums of log a over the chunk (held flat past L)
// from lv, four steps a lane of one warp
__device__ __forceinline__ void walk_cum(float* cum, const float (&lv)[4],
                                         int lane) {
  float v[4], run = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    run += lv[r];
    v[r] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) cum[4 * lane + r] = incl - run + v[r];
}

// The SSD scan of one (batch, head, 64-column slice of P), walking the
// chunks in order with the state in float32 accumulators, as h^T (rows p,
// columns n).  Warpgroup w holds chunk rows 64 w .. 64 w + 63 of y and
// state columns n = 64 w .. of h^T; warp (w, v) the 16 rows from 64 w + 16
// v of y and the 16 rows from 16 v of h^T.  Per chunk, every product on
// wgmma with float32 accumulators; an operand the block computes (h, the
// decayed scores, w o X) enters as its high and low bf16 parts, two
// products, about 16 bits of mantissa (TF32 keeps 10):
//   C h     y = C h_c, scaled by exp(cum_i) a row (C from its TMA tile,
//           h^T K-major from shared memory)
//   C B^T   scores (C and B K-major from their TMA tiles; keys 0..63 only
//           for warpgroup 0, whose rows see no later key)
//   intra   y += (scores o E) X (the scores as register A operands, X read
//           MN-major from its TMA tile)
//   state   h^T_(c+1) = exp(cum_L) h^T_c + (w o X)^T B (both read MN-major:
//           w o X's tile as A, this warpgroup's 64 columns of B's as B)
// Then, behind one block barrier, the next chunk's w o X and h^T go to
// shared memory, and behind a second the next chunk starts.  Its tiles come
// by TMA under mbarriers (kWalkStages in flight), refilled by the warp
// whose release completes a stage; warp 0 computes the next chunk's cum
// from log a it fetched a chunk ahead.  With `states` (the training
// forward), the state entering each chunk (rounded to TF32, as the
// backward's products take it) and the chunk's log decay go out.
__global__ void __launch_bounds__(kThreads, 1)
ssd_walk_wgmma(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tbm,
               const __grid_constant__ CUtensorMap tcm,
               const float* __restrict__ loga, bf16* __restrict__ y,
               float* __restrict__ states, float* __restrict__ decay,
               Dims dm, int B, int slices) {
  using W = WalkSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* wxh = sm + W::wx;
  unsigned char* wxl = wxh + W::kX;
  unsigned char* hth = sm + W::ht;
  unsigned char* htl = hth + W::kH;
  float* cums = reinterpret_cast<float*>(sm + W::cum);   // [2][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + W::bars);
  uint64_t* empty = full + kWalkStages;

  const int tid = threadIdx.x, lane = tid & 31;
  const int hh = static_cast<int>(blockIdx.x % dm.H);
  const int sl = static_cast<int>((blockIdx.x / dm.H) % slices);
  const int bb = static_cast<int>(blockIdx.x / (dm.H * slices));
  const int grp = hh / dm.rep;
  const int p0 = sl * kWalkP;
  const int L = dm.L, nC = dm.nC;
  const int npan = dm.N > 64 ? 2 : 1;  // C and B panels that hold columns
  const uint32_t tx_bytes = (2 * npan + 1) * L * 128;

  auto load = [&](int c, int s) {
    unsigned char* st = sm + s * W::kStage;
    hop::mbar_arrive_expect_tx(&full[s], tx_bytes);
    for (int p = 0; p < npan; ++p) {
      hop::tma_load_4d(st + p * kWalkL * 128, &tcm, &full[s], 64 * p, c * L,
                       grp, bb);
      hop::tma_load_4d(st + W::kC + p * kWalkL * 128, &tbm, &full[s], 64 * p,
                       c * L, grp, bb);
    }
    hop::tma_load_4d(st + 2 * W::kC, &tx, &full[s], p0, c * L, hh, bb);
  };

  // zero everything: TMA writes neither the rows past L nor the panel
  // past N, and h_0 = 0
  for (int i = tid; i < W::cum / 16; i += kThreads)
    reinterpret_cast<float4*>(sm)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  hop::fence_proxy_async();
  if (tid == 0) {
    for (int s = 0; s < kWalkStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kThreads / 32);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < min(kWalkStages, nC); ++c) load(c, c);

  const int wg = hop::warpgroup();
  const int warp = (tid >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = 64 * wg + 16 * warp;  // this warp's first row of y
  const int r0 = 16 * warp;            // its first row of h^T (a p)
  const int n0 = 64 * wg;              // its warpgroup's first column n
  const long long ys = static_cast<long long>(dm.H) * dm.P;
  const float* lb = loga + static_cast<long long>(bb) * dm.S * dm.H + hh;

  // warp 0 holds the next chunk's log a, four steps a lane
  float lv[4];
  auto fetch_la = [&](int c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * lane + r;
      lv[r] = j < L ? lb[(static_cast<long long>(c) * L + j) * dm.H] : 0.f;
    }
  };

  // w o X of chunk c (its tile in stage s, its cum in `cum`) in high and
  // low parts, in x's own layout: rows j, 16 bytes an item at its
  // swizzled place
  auto stage_wx = [&](const unsigned char* xs, const float* cum) {
    const float cL = cum[L - 1];
    for (int item = tid; item < kWalkL * 8; item += kThreads) {
      const int j = item >> 3, off = sw128(j, item & 7);
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + off);
      const float w = __expf(cL - cum[j]);
      const uint32_t xw[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        bf16 h0, l0, h1, l1;
        split_bf16(w * __uint_as_float(xw[q] << 16), h0, l0);
        split_bf16(w * __uint_as_float(xw[q] & 0xffff0000u), h1, l1);
        hi[q] = bf16x2_bits(h0, h1);
        lo[q] = bf16x2_bits(l0, l1);
      }
      *reinterpret_cast<uint4*>(wxh + off) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(wxl + off) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };

  float hacc[8][4];                    // h^T: rows r0 + g, + 8; n0 + 8 j ..
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[j][e] = 0.f;

  // chunk 0: cum, w o X (h^T_0 = 0 is in place)
  if (tid < 32) {
    fetch_la(0);
    walk_cum(cums, lv, lane);
    if (nC > 1) fetch_la(1);
  }
  hop::mbar_wait(&full[0], 0);
  __syncthreads();
  stage_wx(sm + 2 * W::kC, cums);
  hop::fence_proxy_async();
  __syncthreads();

  for (int c = 0; c < nC; ++c) {
    const int s = c % kWalkStages;
    const unsigned char* ct = sm + s * W::kStage;
    const unsigned char* bt = ct + W::kC;
    const unsigned char* xs = ct + 2 * W::kC;
    const float* cum = cums + (c & 1) * kWalkL;

    // kept (the training forward): h_c, rounded to TF32, and cum_L
    if (states != nullptr) {
      float* sp = states + ((static_cast<long long>(bb) * nC + c) * dm.H +
                            hh) * dm.N * dm.P;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + r0 + g + 8 * (e >> 1);
          const int n = n0 + 8 * j + 2 * t + (e & 1);
          if (p < dm.P && n < dm.N)
            sp[static_cast<long long>(n) * dm.P + p] =
                __uint_as_float(tc::to_tf32(hacc[j][e]));
        }
      if (tid == 0 && sl == 0)
        decay[(static_cast<long long>(bb) * nC + c) * dm.H + hh] = cum[L - 1];
    }

    // C h_c (C's rows K-major, h^T's high then low part) and the scores of
    // keys 0..63 (warpgroup 0's rows see no later key)
    const uint64_t ca = hop::desc_sw128(ct + 64 * wg * 128, 16, 1024);
    const uint64_t ba = hop::desc_sw128(bt, 16, 1024);
    const uint64_t xb = hop::desc_sw128(xs, kWalkL * 128, 1024);
    float yacc[8][4];
    float sc[8][4];
    {
      const uint64_t hb = hop::desc_sw128(hth, 16, 1024);
      const uint64_t lb2 = hop::desc_sw128(htl, 16, 1024);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWalkN / 16; ++kk)
        hop::wgmma_ss(yacc, ca + walk_kstep(kWalkL, kk),
                      hb + walk_kstep(kWalkP, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < kWalkN / 16; ++kk)
        hop::wgmma_ss(yacc, ca + walk_kstep(kWalkL, kk),
                      lb2 + walk_kstep(kWalkP, kk), 1);
      hop::wgmma_commit();
      walk_scores(sc, ca, ba);
    }
    hop::wgmma_wait<0>();  // C h and the scores are done
    hop::fence_regs(yacc);
    hop::fence_regs(sc);
    {
      const float e0 = __expf(cum[i0 + g]), e1 = __expf(cum[i0 + g + 8]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        yacc[j][0] *= e0;
        yacc[j][1] *= e0;
        yacc[j][2] *= e1;
        yacc[j][3] *= e1;
      }
    }
    // intra over keys 0..63; warpgroup 1 then takes keys 64..127, their
    // scores made while the first half's product runs
    uint32_t ah[4][4], al[4][4];
    walk_decay(ah, al, sc, 0, cum, i0, g, t);
    walk_intra(yacc, ah, al, xb);
    if (wg == 1) {
      walk_scores(sc, ca, ba + ((64 * 128) >> 4));
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
      hop::fence_regs(yacc);
      walk_decay(ah, al, sc, 64, cum, i0, g, t);
      walk_intra(yacc, ah, al, xb + 4 * kWalkMnStep);
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(yacc);
    // h^T_(c+1) = exp(cum_L) h^T_c + (w o X)^T B (both read MN-major: w o
    // X's tile as A, this warpgroup's 64 columns of B's as B), in flight
    // while y goes out
    {
      const float dL = __expf(cum[L - 1]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[j][e] *= dL;
      const uint64_t bn = hop::desc_sw128(bt + wg * kWalkL * 128,
                                          kWalkL * 128, 1024);
      const uint64_t wh = hop::desc_sw128(wxh, kWalkL * 128, 1024);
      const uint64_t wl = hop::desc_sw128(wxl, kWalkL * 128, 1024);
      hop::fence_regs(hacc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWalkL / 16; ++kk)
        hop::wgmma_ss_tt(hacc, wh + kk * kWalkMnStep, bn + kk * kWalkMnStep);
#pragma unroll
      for (int kk = 0; kk < kWalkL / 16; ++kk)
        hop::wgmma_ss_tt(hacc, wl + kk * kWalkMnStep, bn + kk * kWalkMnStep);
      hop::wgmma_commit();
    }

    // y out: rows i0 + g, + 8 of the chunk, columns p0 + 8 j + 2 t, + 1
    bf16* yb = y + (static_cast<long long>(bb) * dm.S +
                    static_cast<long long>(c) * L) * ys +
               static_cast<long long>(hh) * dm.P;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + g + 8 * r;
      if (i >= L) continue;
      bf16* yr = yb + i * ys;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p0 + 8 * j + 2 * t;
        if (col >= dm.P) continue;
        if (dm.P % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yr + col) =
              __floats2bfloat162_rn(yacc[j][2 * r], yacc[j][2 * r + 1]);
        } else {
          yr[col] = __float2bfloat16(yacc[j][2 * r]);
          if (col + 1 < dm.P)
            yr[col + 1] = __float2bfloat16(yacc[j][2 * r + 1]);
        }
      }
    }
    // the next chunk's cum (warp 0, from log a fetched a chunk ago)
    if (tid < 32 && c + 1 < nC) {
      walk_cum(cums + ((c + 1) & 1) * kWalkL, lv, lane);
      if (c + 2 < nC) fetch_la(c + 2);
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(hacc);

    // this stage is read: the warp that completes its release refills it
    __syncwarp();
    if (lane == 0 && hop::mbar_arrive_last(&empty[s]) && c + kWalkStages < nC)
      load(c + kWalkStages, s);
    if (c + 1 == nC) break;
    const int s1 = (c + 1) % kWalkStages;
    hop::mbar_wait(&full[s1], ((c + 1) / kWalkStages) & 1);
    __syncthreads();  // every warp is done with h^T and w o X; cum is in
    // h^T_(c+1) in high and low parts (row p, columns n, n + 1 a word),
    // and the next chunk's w o X
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = r0 + g + 8 * r, n = n0 + 8 * j + 2 * t;
        const int off = (n >> 6) * kWalkP * 128 + sw128(p, (n & 63) >> 3) +
                        (n & 7) * 2;
        bf16 h0, l0, h1, l1;
        split_bf16(hacc[j][2 * r], h0, l0);
        split_bf16(hacc[j][2 * r + 1], h1, l1);
        *reinterpret_cast<uint32_t*>(hth + off) = bf16x2_bits(h0, h1);
        *reinterpret_cast<uint32_t*>(htl + off) = bf16x2_bits(l0, l1);
      }
    stage_wx(sm + s1 * W::kStage + 2 * W::kC, cums + ((c + 1) & 1) * kWalkL);
    hop::fence_proxy_async();
    __syncthreads();  // h^T and w o X are in place
  }
}

// ---------------------------------------------------------------------------
// float32: FMAs from shared memory
// ---------------------------------------------------------------------------

// Shared memory, in floats: x [L4][PP], b [L4][NS], then for kernel 3
// h [NP][PP], c [kR][NS] and scores [kR][L4]; then cum and exp(cum) (kernel
// 3) or cum and w = exp(cum_L - cum) (kernel 1), [128] each.  b and c rows
// hold N rounded up to 8, plus 4 (a row stride of 16 bytes mod 128), x and h
// rows P rounded up to 4: the float4 reads of a warp hit distinct banks.
struct FmaLayout {
  int NP, NS, PP, L4;
  __host__ __device__ FmaLayout(const Dims& d)
      : NP(round_up(d.N, kNB)), NS(round_up(d.N, kNB) + 4),
        PP(round_up(d.P, 4)), L4(round_up(d.L, 4)) {}
  __host__ __device__ size_t state_floats() const {
    return static_cast<size_t>(L4) * (PP + NS) + 2 * kMaxL;
  }
  __host__ __device__ size_t out_floats() const {
    return static_cast<size_t>(L4) * (PP + NS) + static_cast<size_t>(NP) * PP +
           kR * NS + kR * L4 + 2 * kMaxL;
  }
};

__device__ __forceinline__ float dot4(float4 u, float4 v, float acc) {
  acc = fmaf(u.x, v.x, acc);
  acc = fmaf(u.y, v.y, acc);
  acc = fmaf(u.z, v.z, acc);
  return fmaf(u.w, v.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 v, float4& acc) {
  acc.x = fmaf(a, v.x, acc.x);
  acc.y = fmaf(a, v.y, acc.y);
  acc.z = fmaf(a, v.z, acc.z);
  acc.w = fmaf(a, v.w, acc.w);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the chunk's x rows [L4][PP] and b rows [L4][NS], zero past L and in the
// padding
__device__ __forceinline__ void stage_xb_f32(float* xt, float* bt,
                                             const float* xb, const float* bg,
                                             const Dims& dm,
                                             const FmaLayout& lay, Strides xs,
                                             Strides bs, int tid) {
  for (int i = tid; i < lay.L4 * lay.PP; i += kThreads) {
    const int j = i / lay.PP, p = i % lay.PP;
    xt[i] = (j < dm.L && p < dm.P) ? xb[j * xs.s + p] : 0.f;
  }
  for (int i = tid; i < lay.L4 * lay.NS; i += kThreads) {
    const int j = i / lay.NS, n = i % lay.NS;
    bt[i] = (j < dm.L && n < dm.N) ? bg[j * bs.s + n] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_state_fma(const float* __restrict__ x, const float* __restrict__ loga,
              const float* __restrict__ bm, float* __restrict__ states,
              float* __restrict__ decay, Dims dm, Strides xs, Strides bs) {
  extern __shared__ float4 smem4[];
  const FmaLayout lay(dm);
  float* xt = reinterpret_cast<float*>(smem4);   // [L4][PP]
  float* bt = xt + lay.L4 * lay.PP;              // [L4][NS]
  float* cum = bt + lay.L4 * lay.NS;             // [128]
  float* wdec = cum + kMaxL;                     // exp(cum_L - cum)

  const int tid = threadIdx.x, lane = tid & 31;
  const int cc = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int c0 = cc * dm.L;
  const int grp = hh / dm.rep;
  const int Q = lay.PP / 4;                      // float4 columns of x, s

  stage_xb_f32(xt, bt, x + bb * xs.b + hh * xs.h + c0 * xs.s,
               bm + bb * bs.b + grp * bs.h + c0 * bs.s, dm, lay, xs, bs, tid);
  if (tid < 32) {
    chunk_cum(cum, loga + (static_cast<long long>(bb) * dm.S + c0) * dm.H + hh,
              dm.H, dm.L, lane);
    __syncwarp();
    const float cL = cum[dm.L - 1];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      wdec[4 * lane + r] = expf(cL - cum[4 * lane + r]);
    if (lane == 0)
      decay[(static_cast<long long>(bb) * dm.nC + cc) * dm.H + hh] = cL;
  }
  __syncthreads();

  // s = sum_j exp(cum_L - cum_j) b_j x_j^T; a thread takes kNB state rows
  // and four columns
  const long long sbase =
      ((static_cast<long long>(bb) * dm.nC + cc) * dm.H + hh) * dm.N * dm.P;
  for (int e = tid; e < (lay.NP / kNB) * Q; e += kThreads) {
    const int n0 = (e / Q) * kNB, q = e % Q;
    float4 acc[kNB];
#pragma unroll
    for (int k = 0; k < kNB; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < dm.L; ++j) {
      float4 xv = ld4(xt + j * lay.PP + 4 * q);
      const float w = wdec[j];
      xv = make_float4(w * xv.x, w * xv.y, w * xv.z, w * xv.w);
      const float4 b0 = ld4(bt + j * lay.NS + n0);
      const float4 b1 = ld4(bt + j * lay.NS + n0 + 4);
      axpy4(b0.x, xv, acc[0]);
      axpy4(b0.y, xv, acc[1]);
      axpy4(b0.z, xv, acc[2]);
      axpy4(b0.w, xv, acc[3]);
      axpy4(b1.x, xv, acc[4]);
      axpy4(b1.y, xv, acc[5]);
      axpy4(b1.z, xv, acc[6]);
      axpy4(b1.w, xv, acc[7]);
    }
#pragma unroll
    for (int k = 0; k < kNB; ++k) {
      const int n = n0 + k;
      if (n >= dm.N) continue;
      const float out[4] = {acc[k].x, acc[k].y, acc[k].z, acc[k].w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (4 * q + r < dm.P)
          states[sbase + static_cast<long long>(n) * dm.P + 4 * q + r] = out[r];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_out_fma(const float* __restrict__ x, const float* __restrict__ loga,
            const float* __restrict__ bm, const float* __restrict__ cm,
            const float* __restrict__ states, float* __restrict__ y, Dims dm,
            Strides xs, Strides bs, Strides cs) {
  extern __shared__ float4 smem4[];
  const FmaLayout lay(dm);
  const int NP = lay.NP, NS = lay.NS, PP = lay.PP, L4 = lay.L4;
  float* xt = reinterpret_cast<float*>(smem4);   // [L4][PP]
  float* bt = xt + L4 * PP;                      // [L4][NS]
  float* ht = bt + L4 * NS;                      // [NP][PP]
  float* ct = ht + NP * PP;                      // [kR][NS]
  float* st = ct + kR * NS;                      // [kR][L4]
  float* cum = st + kR * L4;                     // [128]
  float* ecum = cum + kMaxL;                     // exp(cum)

  const int tid = threadIdx.x, lane = tid & 31;
  const int cc = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int c0 = cc * dm.L;
  const int grp = hh / dm.rep;
  const int L = dm.L, P = dm.P;
  const int Q = PP / 4;                          // float4 columns of x, h, y
  const float* cg = cm + bb * cs.b + grp * cs.h + c0 * cs.s;
  const float* hsrc = states +
      ((static_cast<long long>(bb) * dm.nC + cc) * dm.H + hh) * dm.N * dm.P;

  stage_xb_f32(xt, bt, x + bb * xs.b + hh * xs.h + c0 * xs.s,
               bm + bb * bs.b + grp * bs.h + c0 * bs.s, dm, lay, xs, bs, tid);
  for (int i = tid; i < NP * PP; i += kThreads) {
    const int n = i / PP, p = i % PP;
    ht[i] = (n < dm.N && p < P) ? hsrc[n * P + p] : 0.f;
  }
  if (tid < 32) {
    chunk_cum(cum, loga + (static_cast<long long>(bb) * dm.S + c0) * dm.H + hh,
              dm.H, L, lane);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 4; ++r) ecum[4 * lane + r] = expf(cum[4 * lane + r]);
  }
  __syncthreads();

  const long long ys = static_cast<long long>(dm.H) * P;   // y's seq stride
  float* yb = y + (static_cast<long long>(bb) * dm.S + c0) * ys +
              static_cast<long long>(hh) * P;
  for (int i0 = 0; i0 < L; i0 += kR) {
    // c rows i0 .. i0 + kR - 1
    for (int i = tid; i < kR * NS; i += kThreads) {
      const int r = i / NS, n = i % NS;
      const int row = i0 + r;
      ct[i] = (row < L && n < dm.N) ? cg[row * cs.s + n] : 0.f;
    }
    __syncthreads();

    // scores s[r][j] = (c_i . b_j) exp(cum_i - cum_j) for j <= i, else 0;
    // a thread takes one column j and four rows
    const int jend = min(L4, round_up(i0 + kR, 4));
    for (int e = tid; e < jend * (kR / 4); e += kThreads) {
      const int j = e % jend;
      const int r0 = (e / jend) * 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < NP; k += 4) {
        const float4 bv = ld4(bt + j * NS + k);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
          acc[rr] = dot4(ld4(ct + (r0 + rr) * NS + k), bv, acc[rr]);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int i = i0 + r0 + rr;
        float v = 0.f;
        if (i < L && j <= i) v = acc[rr] * expf(cum[i] - cum[j]);
        st[(r0 + rr) * L4 + j] = v;
      }
    }
    __syncthreads();

    // y rows: the intra-chunk sum over j <= i, then exp(cum_i) (c_i . h);
    // a thread takes one row and four columns
    for (int e = tid; e < kR * Q; e += kThreads) {
      const int r = e / Q, q = e % Q;
      const int i = i0 + r;
      if (i >= L) continue;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      const int jq = round_up(i + 1, 4);
      for (int j = 0; j < jq; j += 4) {
        const float4 sv = ld4(st + r * L4 + j);
        axpy4(sv.x, ld4(xt + (j + 0) * PP + 4 * q), acc);
        axpy4(sv.y, ld4(xt + (j + 1) * PP + 4 * q), acc);
        axpy4(sv.z, ld4(xt + (j + 2) * PP + 4 * q), acc);
        axpy4(sv.w, ld4(xt + (j + 3) * PP + 4 * q), acc);
      }
      float4 inter = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int n = 0; n < NP; n += 4) {
        const float4 cv = ld4(ct + r * NS + n);
        axpy4(cv.x, ld4(ht + (n + 0) * PP + 4 * q), inter);
        axpy4(cv.y, ld4(ht + (n + 1) * PP + 4 * q), inter);
        axpy4(cv.z, ld4(ht + (n + 2) * PP + 4 * q), inter);
        axpy4(cv.w, ld4(ht + (n + 3) * PP + 4 * q), inter);
      }
      const float ei = ecum[i];
      const float out[4] = {fmaf(ei, inter.x, acc.x), fmaf(ei, inter.y, acc.y),
                            fmaf(ei, inter.z, acc.z), fmaf(ei, inter.w, acc.w)};
      float* yr = yb + i * ys;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * q + u < P) yr[4 * q + u] = out[u];
    }
    __syncthreads();  // c and the scores are reused by the next row tile
  }
}

// ---------------------------------------------------------------------------
// launch: kernels 1, 2 and 3 on one stream
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int launch_pass(float* states, const float* decay, int B, const Dims& dm,
                cudaStream_t st) {
  const int NP = dm.N * dm.P;
  const dim3 grid((NP + kThreads - 1) / kThreads, dm.H, B);
  ssd_pass<<<grid, kThreads, 0, st>>>(states, decay, dm.H, NP, dm.nC);
  return static_cast<int>(cudaGetLastError());
}

// the bf16 walk: x, b and c read by TMA (each base and each (batch, seq,
// head or group) stride a multiple of 16 bytes; the wrapper stages a copy
// of an operand that is not); a tensor map that cuTensorMapEncodeTiled
// refuses returns 1000 + its CUresult.  states and decay may be null.
int launch_walk(const bf16* x, const float* loga, const bf16* b,
                const bf16* c, bf16* y, float* states, float* decay, int B,
                const Dims& dm, Strides xs, Strides bs, Strides cs,
                cudaStream_t st) {
  const int slices = (dm.P + kWalkP - 1) / kWalkP;
  const long long blocks = static_cast<long long>(B) * dm.H * slices;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int G = dm.H / dm.rep;
  CUtensorMap mx, mb, mc;
  int err = hop::encode_bf16_panels(&mx, x, dm.P, dm.S, dm.H, B, xs.s, xs.h,
                                    xs.b, dm.L);
  if (!err)
    err = hop::encode_bf16_panels(&mb, b, dm.N, dm.S, G, B, bs.s, bs.h, bs.b,
                                  dm.L);
  if (!err)
    err = hop::encode_bf16_panels(&mc, c, dm.N, dm.S, G, B, cs.s, cs.h, cs.b,
                                  dm.L);
  if (err) return err;
  const cudaError_t e = allow_smem(ssd_walk_wgmma, WalkSmem::bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_walk_wgmma<<<static_cast<unsigned>(blocks), kThreads, WalkSmem::bytes,
                   st>>>(mx, mb, mc, loga, y, states, decay, dm, B, slices);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const float* x, const float* loga, const float* b,
               const float* c, float* y, float* states, float* decay, int B,
               const Dims& dm, Strides xs, Strides bs, Strides cs,
               cudaStream_t st) {
  const dim3 grid(dm.nC, dm.H, B);
  const FmaLayout lay(dm);
  const size_t s1 = lay.state_floats() * 4, s3 = lay.out_floats() * 4;
  cudaError_t err = allow_smem(ssd_state_fma, s1);
  if (err == cudaSuccess) err = allow_smem(ssd_out_fma, s3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_fma<<<grid, kThreads, s1, st>>>(x, loga, b, states, decay, dm, xs,
                                             bs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e2 = launch_pass(states, decay, B, dm, st);
  if (e2 != 0) return e2;
  ssd_out_fma<<<grid, kThreads, s3, st>>>(x, loga, b, c, states, y, dm, xs, bs,
                                           cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, b, c, y: device pointers; is_bf16 selects bfloat16 (else float32) for
// x, b, c and y; loga is float32 (B, S, H), y dense (B, S, H, P); S a
// multiple of L; strides in elements, (batch, seq, head) for x and
// (batch, seq, group) for b and c.  states (B, S / L, H, N, P) and decay
// (B, S / L, H) are float32, dense: the three float32 kernels' scratch,
// which they leave holding the state entering each chunk and the chunk's
// summed log decay; bfloat16 (one launch) writes them only where states is
// not null, and then reads x, b and c by TMA (see launch_walk).  Launches
// on `stream`: bfloat16 one, float32 three.
extern "C" int ssd_scan_launch(const void* x, const void* loga, const void* b,
                               const void* c, void* y, void* states,
                               void* decay, int is_bf16, int B, int S, int H,
                               int G, int P, int N, int L, long long xsb,
                               long long xss, long long xsh, long long bsb,
                               long long bss, long long bsh, long long csb,
                               long long css, long long csh, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || P <= 0) return 0;
  if (G <= 0 || H % G != 0 || N <= 0 || L <= 0 || L > kMaxL || N > 128 ||
      P > 128 || S % L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{xsb, xss, xsh}, bs{bsb, bss, bsh}, cs{csb, css, csh};
  const Dims dm{S, H, H / G, P, N, L, S / L};
  const float* la = static_cast<const float*>(loga);
  float* sts = static_cast<float*>(states);
  float* dec = static_cast<float*>(decay);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_walk(static_cast<const bf16*>(x), la,
                       static_cast<const bf16*>(b),
                       static_cast<const bf16*>(c), static_cast<bf16*>(y),
                       sts, dec, B, dm, xs, bs, cs, st);
  if (sts == nullptr || dec == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32(static_cast<const float*>(x), la,
                    static_cast<const float*>(b),
                    static_cast<const float*>(c), static_cast<float*>(y), sts,
                    dec, B, dm, xs, bs, cs, st);
}

// a forward kernel as a call with chunk L, d_state N and d_head P runs it:
// bfloat16 kernel 1, the chunk walk; float32 kernel 1 (chunk states), 2
// (state pass) or 3 (chunk outputs).  Its registers a thread, its local
// memory a thread (spills), and the dynamic shared memory the launch
// requests
extern "C" int ssd_scan_attributes(int is_bf16, int kernel, int L, int N,
                                   int P, int* regs, int* local_bytes,
                                   long long* smem) {
  const Dims dm{L, 1, 1, P, N, L, 1};
  const FmaLayout fl(dm);
  cudaFuncAttributes attr;
  cudaError_t err;
  if (is_bf16 && kernel == 1) {
    err = cudaFuncGetAttributes(&attr, ssd_walk_wgmma);
    *smem = WalkSmem::bytes;
  } else if (is_bf16) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (kernel == 1) {
    err = cudaFuncGetAttributes(&attr, ssd_state_fma);
    *smem = 4 * fl.state_floats();
  } else if (kernel == 2) {
    err = cudaFuncGetAttributes(&attr, ssd_pass);
    *smem = 0;
  } else if (kernel == 3) {
    err = cudaFuncGetAttributes(&attr, ssd_out_fma);
    *smem = 4 * fl.out_floats();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}
