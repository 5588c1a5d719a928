// ssd_scan: the Mamba2 SSD chunked scan (state-space duality), chunk-parallel
// in three kernels, for bfloat16 inputs on the tensor cores and for float32
// inputs as float32 FMAs.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py
// (_ssd_kernel, launched by ssd_scan_padded).  That kernel walks a
// (batch, head, chunk) grid whose chunk axis runs in order on one core,
// carrying the state h (N x P) in VMEM scratch from one chunk to the next.
// Blocks of a CUDA grid run in no order, and B * H blocks walking the
// chunks in turn leave most of the card idle, so here the chunks run in
// parallel and only the (N x P) state recurrence is serial.
//
// Per chunk c of length L, with cum the in-chunk prefix sum of log a:
//   1. state  s_c  = sum_j exp(cum_L - cum_j) b_j x_j^T        (N x P)
//   2. pass   h_0  = 0,  h_c = exp(cum_L of c - 1) h_(c-1) + s_(c-1)
//   3. output y_i  = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) x_j
//                    + exp(cum_i) (c_i . h_c)
// Kernel 1 (one block per (chunk, head, batch)) writes s_c as float32 to a
// scratch (B, nC, H, N, P) that the wrapper allocates, and cum_L to a
// (B, nC, H) scratch; kernel 2 (one thread per state element of a (batch,
// head), serial over the chunks) overwrites s_c in place with h_c, the
// state entering chunk c; kernel 3 (one block per (chunk, head, batch))
// computes y.  exp(cum_i - cum_j) is taken only where i >= j: for i < j the
// exponent is positive and may overflow (the Pallas kernel zeroes it with
// where).
//
// bfloat16: the products on the tensor cores with mma.sync, float32
// accumulators.  Not wgmma: its operands come from shared memory through
// swizzled-layout descriptors, and the triangular, per-warp-ragged score
// tiles fit register fragments better; wgmma is later work.
//   * C B^T (kernel 3) has bf16 operands straight from memory: m16n8k16 bf16,
//     ldmatrix fragments, exact products as the reference's float32 casts.
//   * Where an operand is a float32 value that a kernel computed, the product
//     is TF32 (m16n8k8; 10 mantissa bits against bf16's 7; the bf16 operand
//     is exact in TF32): the masked scores times X and exp(cum_i) C h
//     (kernel 3), and (exp(cum_L - cum_j) b_j)^T X (kernel 1).
//   * The scores leave the bf16 product as C fragments and enter the TF32
//     product as A fragments without a shuffle: the product's k index (the
//     key) is permuted within each group of 8, k = t <-> key 2t and
//     k = t + 4 <-> key 2t + 1, and X's rows are read in the same order.
//   * Kernel 3: 8 warps, warp w owns chunk rows 16w..16w+15 and their keys
//     0..16w+15 (the causal triangle, skipped tile by tile, 64 keys at a
//     time).  c, x and h come by cp.async; b is copied into h's shared
//     memory once C h is done, so mamba2's block (L = N = 128, P = 64)
//     takes 89 KB and two fit an SM.
//   * Shared-memory rows are padded so that a warp's fragment reads hit
//     distinct banks.
//
// float32 (the checks and float32 configs): the same three kernels with
// float32 FMAs from shared memory (TF32 would not hold the float32
// tolerance, 1e-4): kernel 1 as 8 state rows x 4 columns a thread, kernel 3
// as the scores 16 rows at a time, then y with the inter term.
//
// Both: b and c are read for the head's state group h / (H / G), as the
// BlockSpec index maps do.  x, b and c are read through their (batch, seq,
// head or group) strides with 64-bit offsets; loga (B, S, H) and y
// (B, S, H, P) are dense.  S is a multiple of L (the wrapper pads with
// a = 1 and zero x, b, c, so padded steps pass the state through).
// L, N, P <= 128.
//
// Bound on the card: the algorithm's bytes (x and y once, b, c and loga):
// 0.052 ms at mamba2's B = 2, S = 4096, H = 80.  This design also writes
// and reads the float32 state scratch twice (168 MB there, about 0.2 ms
// more); a single pass with a decoupled look-back over the chunk states
// would not, and is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../flash_attention/csrc/tensor_core.cuh"
#include "ssd_chunk.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kMaxL = 128;
constexpr int kR = 16;        // FMA: rows of y (and of c and the scores) a tile
constexpr int kNB = 8;        // FMA: state rows a thread in the state product

// ---------------------------------------------------------------------------
// kernel 2: the state recurrence over the chunks (both types)
// ---------------------------------------------------------------------------

// A thread walks one state element of a (batch, head) over the chunks, its
// loads kPassU chunks ahead (each chunk's load is otherwise a DRAM round
// trip on the serial path).  With kTf32 (the bf16 path) the states it
// writes are rounded to TF32 once here, for kernel 3's C h product.
constexpr int kPassU = 8;

template <bool kTf32>
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
        // the state entering chunk c0 + u
        states[bch * NP + e] = kTf32 ? __uint_as_float(tc::to_tf32(run)) : run;
        run = fmaf(expf(dv[u]), run, sv[u]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

// kernel 1, bf16.  Shared memory: b [L8][BS], x [L8][XS] (bf16, raw), cum
// and w = exp(cum_L - cum) [128] each.  BS, XS = 16 mod 64 elements: the
// fragment reads (row t, column g) of a warp hit distinct banks.
struct StateMmaLayout {
  int L8, N16, P8, BS, XS;
  __host__ __device__ StateMmaLayout(const Dims& d)
      : L8(round_up(d.L, 8)), N16(round_up(d.N, 16)), P8(round_up(d.P, 8)),
        BS(round_up(N16, 64) + 16), XS(round_up(P8, 64) + 16) {}
  __host__ __device__ size_t bytes() const {
    return 2 * static_cast<size_t>(L8) * (BS + XS) + 2 * kMaxL * 4;
  }
};

__global__ void __launch_bounds__(kThreads)
ssd_state_mma(const bf16* __restrict__ x, const float* __restrict__ loga,
              const bf16* __restrict__ bm, float* __restrict__ states,
              float* __restrict__ decay, Dims dm, Strides xs, Strides bs,
              int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StateMmaLayout lay(dm);
  bf16* bt = reinterpret_cast<bf16*>(smem_raw);      // [L8][BS]
  bf16* xt = bt + lay.L8 * lay.BS;                   // [L8][XS]
  float* cum = reinterpret_cast<float*>(xt + lay.L8 * lay.XS);
  float* w = cum + kMaxL;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cc = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int c0 = cc * dm.L;
  const int grp = hh / dm.rep;

  const bf16* bsrc = bm + bb * bs.b + grp * bs.h + c0 * bs.s;
  const bf16* xsrc = x + bb * xs.b + hh * xs.h + c0 * xs.s;
  tc::stage<kThreads>(bt, lay.BS, bsrc, bs.s, dm.L, dm.N, lay.L8, lay.N16, vec,
                      tid);
  tc::stage<kThreads>(xt, lay.XS, xsrc, xs.s, dm.L, dm.P, lay.L8, lay.P8, vec,
                      tid);
  tc::cp_async_commit();
  if (warp == 0) {
    chunk_cum(cum, loga + (static_cast<long long>(bb) * dm.S + c0) * dm.H + hh,
              dm.H, dm.L, lane);
    __syncwarp();
    const float cL = cum[dm.L - 1];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[4 * lane + r] = expf(cL - cum[4 * lane + r]);
    if (lane == 0)
      decay[(static_cast<long long>(bb) * dm.nC + cc) * dm.H + hh] = cL;
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // s (N x P) = A B with A[n][j] = w_j b_j[n] (tf32), B[j][p] = x_j[p];
  // a warp takes a 16-row m tile and up to 8 n tiles (64 columns)
  const int MTn = lay.N16 / 16, PT = lay.P8 / 8, PG = (PT + 7) / 8;
  const long long sbase =
      ((static_cast<long long>(bb) * dm.nC + cc) * dm.H + hh) * dm.N * dm.P;
  for (int item = warp; item < MTn * PG; item += kThreads / 32) {
    const int m0 = (item / PG) * 16, pg = item % PG;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int k0 = 0; k0 < lay.L8; k0 += 8) {
      const float w0 = w[k0 + t], w1 = w[k0 + t + 4];
      const bf16* b0r = bt + (k0 + t) * lay.BS + m0 + g;
      const bf16* b1r = bt + (k0 + t + 4) * lay.BS + m0 + g;
      const uint32_t a[4] = {tc::to_tf32(w0 * __bfloat162float(b0r[0])),
                             tc::to_tf32(w0 * __bfloat162float(b0r[8])),
                             tc::to_tf32(w1 * __bfloat162float(b1r[0])),
                             tc::to_tf32(w1 * __bfloat162float(b1r[8]))};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nt = pg * 8 + j;
        if (nt < PT) {
          const uint32_t x0 =
              tc::bf16_bits_as_tf32(xt[(k0 + t) * lay.XS + nt * 8 + g]);
          const uint32_t x1 =
              tc::bf16_bits_as_tf32(xt[(k0 + t + 4) * lay.XS + nt * 8 + g]);
          tc::mma_tf32(acc[j], a, x0, x1);
        }
      }
    }
    // a thread's two neighbouring columns go out as one float2 where P is
    // even (the scratch is dense)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nt = pg * 8 + j;
      if (nt >= PT) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + g + 8 * r, col = nt * 8 + 2 * t;
        if (row >= dm.N || col >= dm.P) continue;
        float* sp = states + sbase + static_cast<long long>(row) * dm.P + col;
        if (dm.P % 2 == 0) {
          *reinterpret_cast<float2*>(sp) =
              make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
        } else {
          sp[0] = acc[j][2 * r];
          if (col + 1 < dm.P) sp[1] = acc[j][2 * r + 1];
        }
      }
    }
  }
}

// kernel 3, bf16.  Shared memory: c [L16][CS], x [L16][XS] (bf16, raw), a
// region holding h [N16][HS] (float32) and then b [L16][CS] (bf16), cum and
// exp(cum) [128] each.  CS, XS = 8 mod 32 elements, HS = 8 mod 32 floats:
// ldmatrix rows 16 bytes apart mod 128, and the scalar fragment reads of a
// warp on distinct banks.
struct OutMmaLayout {
  int L16, N16, P8, CS, XS, HS;
  __host__ __device__ OutMmaLayout(const Dims& d)
      : L16(round_up(d.L, 16)), N16(round_up(d.N, 16)), P8(round_up(d.P, 8)),
        CS(round_up(N16, 32) + 8), XS(round_up(P8, 32) + 8),
        HS(round_up(P8, 32) + 8) {}
  __host__ __device__ size_t region() const {       // h, then b (bytes)
    const size_t h = 4 * static_cast<size_t>(N16) * HS;
    const size_t b = 2 * static_cast<size_t>(L16) * CS;
    return h > b ? h : b;
  }
  __host__ __device__ size_t bytes() const {
    return 2 * static_cast<size_t>(L16) * (CS + XS) + region() + 2 * kMaxL * 4;
  }
};

// PTM: n8 tiles of y a warp holds (8 for P <= 64, else 16); with 8 the
// block fits in 128 registers a thread and two blocks share an SM
template <int PTM>
__global__ void __launch_bounds__(kThreads, PTM == 8 ? 2 : 1)
ssd_out_mma(const bf16* __restrict__ x, const float* __restrict__ loga,
            const bf16* __restrict__ bm, const bf16* __restrict__ cm,
            const float* __restrict__ states, bf16* __restrict__ y, Dims dm,
            Strides xs, Strides bs, Strides cs, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const OutMmaLayout lay(dm);
  bf16* ct = reinterpret_cast<bf16*>(smem_raw);      // [L16][CS]
  bf16* xt = ct + lay.L16 * lay.CS;                  // [L16][XS]
  unsigned char* region =
      reinterpret_cast<unsigned char*>(xt + lay.L16 * lay.XS);
  float* ht = reinterpret_cast<float*>(region);      // [N16][HS], phase 1
  bf16* bt = reinterpret_cast<bf16*>(region);        // [L16][CS], phases 2-3
  float* cum = reinterpret_cast<float*>(region + lay.region());
  float* ecum = cum + kMaxL;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cc = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int c0 = cc * dm.L;
  const int grp = hh / dm.rep;
  const bf16* bsrc = bm + bb * bs.b + grp * bs.h + c0 * bs.s;

  const bf16* csrc = cm + bb * cs.b + grp * cs.h + c0 * cs.s;
  const bf16* xsrc = x + bb * xs.b + hh * xs.h + c0 * xs.s;
  const float* hsrc = states + ((static_cast<long long>(bb) * dm.nC + cc) *
                                    dm.H + hh) * dm.N * dm.P;
  tc::stage<kThreads>(ct, lay.CS, csrc, cs.s, dm.L, dm.N, lay.L16, lay.N16,
                      vec, tid);
  tc::stage<kThreads>(xt, lay.XS, xsrc, xs.s, dm.L, dm.P, lay.L16, lay.P8, vec,
                      tid);
  tc::stage<kThreads>(ht, lay.HS, hsrc, static_cast<long long>(dm.P), dm.N,
                      dm.P, lay.N16, lay.P8, vec, tid);
  tc::cp_async_commit();
  if (warp == 0) {
    chunk_cum(cum, loga + (static_cast<long long>(bb) * dm.S + c0) * dm.H + hh,
              dm.H, dm.L, lane);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 4; ++r) ecum[4 * lane + r] = expf(cum[4 * lane + r]);
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  const int i0 = warp * 16;                 // this warp's chunk rows
  const bool active = i0 < lay.L16;
  const int PT = lay.P8 / 8;
  float yacc[PTM][4];
#pragma unroll
  for (int pt = 0; pt < PTM; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[pt][e] = 0.f;

  // phase 1: y = exp(cum_i) (c_i . h), TF32 (c exact, h rounded by kernel 2)
  if (active) {
    for (int k0 = 0; k0 < lay.N16; k0 += 8) {
      const bf16* r0 = ct + (i0 + g) * lay.CS + k0 + t;
      const bf16* r1 = r0 + 8 * lay.CS;
      const uint32_t a[4] = {
          tc::bf16_bits_as_tf32(r0[0]), tc::bf16_bits_as_tf32(r1[0]),
          tc::bf16_bits_as_tf32(r0[4]), tc::bf16_bits_as_tf32(r1[4])};
      const float* h0 = ht + (k0 + t) * lay.HS + g;
      const float* h1 = h0 + 4 * lay.HS;
#pragma unroll
      for (int pt = 0; pt < PTM; ++pt)
        if (pt < PT)
          tc::mma_tf32(yacc[pt], a, __float_as_uint(h0[pt * 8]),
                       __float_as_uint(h1[pt * 8]));
    }
    const float e0 = ecum[i0 + g], e1 = ecum[i0 + g + 8];
#pragma unroll
    for (int pt = 0; pt < PTM; ++pt) {
      yacc[pt][0] *= e0;
      yacc[pt][1] *= e0;
      yacc[pt][2] *= e1;
      yacc[pt][3] *= e1;
    }
  }
  __syncthreads();                          // h is read: b takes its place
  tc::stage<kThreads>(bt, lay.CS, bsrc, bs.s, dm.L, dm.N, lay.L16, lay.N16,
                      vec, tid);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  // the warp's keys 0 .. i0 + 15, 64 at a time
  for (int kb = 0; kb < i0 + 16; kb += 64) {
    // phase 2: scores = C B^T, bf16 on the tensor cores; key tile pairs
    // kb / 16 + np, up to the warp's own (i0 / 16)
    const int npend = min(4, (i0 - kb) / 16 + 1);
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    for (int k0 = 0; k0 < lay.N16; k0 += 16) {
      uint32_t a[4];
      tc::ldmatrix_x4(a, ct + (i0 + (lane & 15)) * lay.CS + k0 +
                             (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np < npend) {
          uint32_t bf[4];
          tc::ldmatrix_x4(bf, bt + (kb + np * 16 + (lane >> 4) * 8 +
                                    (lane & 7)) * lay.CS +
                                   k0 + ((lane >> 3) & 1) * 8);
          tc::mma_bf16(s[2 * np], a, bf[0], bf[1]);
          tc::mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }
    // decay and the causal mask: exp(cum_i - cum_j) only where j <= i;
    // phase 3: y += scores X, TF32, the key order within each 8 permuted so
    // that the score accumulators are the A fragments as they lie
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt < 2 * npend) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + g + (e >> 1) * 8;
          const int j = kb + nt * 8 + 2 * t + (e & 1);
          s[nt][e] = (j <= i && i < dm.L) ? s[nt][e] * expf(cum[i] - cum[j])
                                          : 0.f;
        }
        const uint32_t a[4] = {tc::to_tf32(s[nt][0]), tc::to_tf32(s[nt][2]),
                               tc::to_tf32(s[nt][1]), tc::to_tf32(s[nt][3])};
        const bf16* x0 = xt + (kb + nt * 8 + 2 * t) * lay.XS + g;
        const bf16* x1 = x0 + lay.XS;
#pragma unroll
        for (int pt = 0; pt < PTM; ++pt)
          if (pt < PT)
            tc::mma_tf32(yacc[pt], a, tc::bf16_bits_as_tf32(x0[pt * 8]),
                         tc::bf16_bits_as_tf32(x1[pt * 8]));
      }
    }
  }

  const long long ys = static_cast<long long>(dm.H) * dm.P;   // seq stride
  bf16* yb = y + (static_cast<long long>(bb) * dm.S + c0) * ys +
             static_cast<long long>(hh) * dm.P;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    if (i >= dm.L) continue;
    bf16* yr = yb + i * ys;
#pragma unroll
    for (int pt = 0; pt < PTM; ++pt) {
      const int col = pt * 8 + 2 * t;
      if (col >= dm.P) continue;
      if (dm.P % 2 == 0) {                    // y is dense: one bf16x2
        *reinterpret_cast<__nv_bfloat162*>(yr + col) =
            __floats2bfloat162_rn(yacc[pt][2 * r], yacc[pt][2 * r + 1]);
      } else {
        yr[col] = __float2bfloat16(yacc[pt][2 * r]);
        if (col + 1 < dm.P) yr[col + 1] = __float2bfloat16(yacc[pt][2 * r + 1]);
      }
    }
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

template <bool kTf32>
int launch_pass(float* states, const float* decay, int B, const Dims& dm,
                cudaStream_t st) {
  const int NP = dm.N * dm.P;
  const dim3 grid((NP + kThreads - 1) / kThreads, dm.H, B);
  ssd_pass<kTf32><<<grid, kThreads, 0, st>>>(states, decay, dm.H, NP, dm.nC);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const bf16* x, const float* loga, const bf16* b, const bf16* c,
                bf16* y, float* states, float* decay, int B, const Dims& dm,
                Strides xs, Strides bs, Strides cs, int vec, cudaStream_t st) {
  const dim3 grid(dm.nC, dm.H, B);
  const size_t s1 = StateMmaLayout(dm).bytes(), s3 = OutMmaLayout(dm).bytes();
  auto out = dm.P <= 64 ? ssd_out_mma<8> : ssd_out_mma<16>;
  cudaError_t err = allow_smem(ssd_state_mma, s1);
  if (err == cudaSuccess) err = allow_smem(out, s3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_mma<<<grid, kThreads, s1, st>>>(x, loga, b, states, decay, dm, xs,
                                             bs, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e2 = launch_pass<true>(states, decay, B, dm, st);
  if (e2 != 0) return e2;
  out<<<grid, kThreads, s3, st>>>(x, loga, b, c, states, y, dm, xs, bs, cs,
                                  vec);
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
  const int e2 = launch_pass<false>(states, decay, B, dm, st);
  if (e2 != 0) return e2;
  ssd_out_fma<<<grid, kThreads, s3, st>>>(x, loga, b, c, states, y, dm, xs, bs,
                                           cs);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x, b, c, y: device pointers; is_bf16 selects bfloat16 (else float32) for
// x, b, c and y; loga is float32 (B, S, H), y dense (B, S, H, P); S a
// multiple of L; strides in elements, (batch, seq, head) for x and
// (batch, seq, group) for b and c.  states (B, S / L, H, N, P) and decay
// (B, S / L, H) are float32 scratch, dense.  Three launches on `stream`.
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
  if (!is_bf16)
    return launch_f32(static_cast<const float*>(x), la,
                      static_cast<const float*>(b),
                      static_cast<const float*>(c), static_cast<float*>(y),
                      sts, dec, B, dm, xs, bs, cs, st);
  // cp.async moves 16 bytes (8 bf16) from 16-byte aligned addresses
  const long long strides[] = {xsb, xss, xsh, bsb, bss, bsh, csb, css, csh};
  bool vec = N % 8 == 0 && P % 8 == 0 && aligned16(x) && aligned16(b) &&
             aligned16(c) && aligned16(states);
  for (long long s : strides) vec = vec && s % 8 == 0;
  return launch_bf16(static_cast<const bf16*>(x), la,
                     static_cast<const bf16*>(b), static_cast<const bf16*>(c),
                     static_cast<bf16*>(y), sts, dec, B, dm, xs, bs, cs,
                     vec ? 1 : 0, st);
}

// kernel 1 (chunk states), 2 (state pass) or 3 (chunk outputs) as a call
// with chunk L, d_state N and d_head P runs it: its registers a thread, its
// local memory a thread (spills), and the dynamic shared memory the launch
// requests
extern "C" int ssd_scan_attributes(int is_bf16, int kernel, int L, int N,
                                   int P, int* regs, int* local_bytes,
                                   long long* smem) {
  const Dims dm{L, 1, 1, P, N, L, 1};
  const FmaLayout fl(dm);
  cudaFuncAttributes attr;
  cudaError_t err;
  if (kernel == 1) {
    err = is_bf16 ? cudaFuncGetAttributes(&attr, ssd_state_mma)
                  : cudaFuncGetAttributes(&attr, ssd_state_fma);
    *smem = is_bf16 ? StateMmaLayout(dm).bytes() : 4 * fl.state_floats();
  } else if (kernel == 2) {
    err = is_bf16 ? cudaFuncGetAttributes(&attr, ssd_pass<true>)
                  : cudaFuncGetAttributes(&attr, ssd_pass<false>);
    *smem = 0;
  } else if (kernel == 3) {
    err = !is_bf16 ? cudaFuncGetAttributes(&attr, ssd_out_fma)
          : P <= 64 ? cudaFuncGetAttributes(&attr, ssd_out_mma<8>)
                    : cudaFuncGetAttributes(&attr, ssd_out_mma<16>);
    *smem = is_bf16 ? OutMmaLayout(dm).bytes() : 4 * fl.out_floats();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}
