// flash_attention: blocked online-softmax GQA attention (FlashAttention's
// forward pass) with float32 accumulators, and its backward (below).  Which
// forward kernel runs is a fixed rule on the type and the head dim, chosen
// by ops.py's forward_kernel and passed to flash_attention_launch as its
// route (a route the head dim does not fit is refused):
//   * bfloat16, d = 64 or 128 (every configuration's head dim):
//     flash_fwd_wgmma, wgmma on TMA tiles (the forward section after the
//     backward's wgmma kernels, whose primitives it shares);
//   * bfloat16, any other d up to 256: flash_attention_mma, mma.sync;
//   * float32: flash_attention_fma, float32 FMAs.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (_attn_kernel, launched by flash_attention_padded).  That kernel walks a
// (batch, q head, q block, k block) grid whose last axis runs in order on one
// core, carrying the running max, denominator and accumulator in VMEM
// scratch from one k block to the next.  Blocks of a CUDA grid run in no
// order, so here the k-tile loop runs inside the block and the running state
// stays in registers.
//
// Bound on the card: operations.  Attention does 4 * B * Hq * Sq * Sk * d
// FLOPs (about half of it when causal) on O((Sq + Sk) * d) bytes, far above
// the card's balance point, so the products must run at the tensor cores'
// rate, which on Hopper only wgmma reaches.
//
// bfloat16 at d = 64 and 128: flash_fwd_wgmma.  A block is two consumer
// warpgroups (256 threads: at 288 or 384 ptxas caps the registers and
// serialises every wgmma, C7512, as the backward found, so there is no
// producer warpgroup; an elected thread issues the TMA loads ahead).
//   * Q (a 128-row query tile, 64 rows a warpgroup) stays resident; K and V
//     arrive by TMA in the 128-byte swizzle through 4-d tensor maps over
//     their (batch, head, seq) strides, so the transposed views the model
//     hands in need no copy (ops.py stages one TMA cannot describe), in a
//     ring of stages under mbarriers, each refilled by the warp whose
//     arrival completes its `empty` barrier.  d = 128: 128 keys a stage,
//     three stages, 225 KB, one block an SM, 251 registers; d = 64: 64 keys
//     a stage, four stages, 81 KB, two blocks an SM at 122 registers.
//   * S = Q K^T with both operands K-major in shared memory (wgmma_ss); the
//     online softmax in base 2 on the accumulators (a row's max over the
//     four threads that hold it); P rounded to bf16 in registers is the A
//     operand of O += P V, V read MN-major (wgmma_rs_tb).
//   * The next stage's Q K^T is issued before this stage's softmax and
//     retires under it and under this stage's P V (FlashAttention 3's
//     in-warpgroup pipelining); every group retires before the loop's back
//     edge (an accumulator in flight across it serialises: C7515).
//   * A stage wholly past a warpgroup's causal end is only waited for and
//     released; only tiles that cross the diagonal (or Sk) are masked.  The
//     grid runs (head, batch) fastest and the query tiles from the last, so
//     every head's longest causal tiles start first.
//   * lse (the training forward's) is written per row from the registers.
//
// bfloat16 at other head dims: flash_attention_mma, mma.sync.m16n8k16 with
// ldmatrix, FlashAttention 2's register dataflow.
//   * One block of 4 warps per (q tile, q head, batch); a warp owns MT
//     16-row m tiles of q (MT = 2, a 128-row tile, for head dims up to 128,
//     so that every K and V fragment read from shared memory feeds two
//     products; MT = 1 at 256, where the accumulator is 128 floats a thread).
//   * K and V tiles of 32 keys come through a ring of two shared-memory
//     stages filled with cp.async (16 bytes a thread, zero-filled past Sk and
//     past d), the next tile's copy in flight while this one is multiplied.
//     Rows are padded by 16 bytes, so the eight rows of an ldmatrix hit
//     distinct banks.
//   * S = Q K^T and O += P V as above, P's accumulators rounded to bf16 as
//     the A fragments as they lie; V's B fragments by ldmatrix.trans.
//   * Where a row stride or a pointer is not 16-byte aligned, or d is not a
//     multiple of 8, the tiles are copied element by element instead of by
//     cp.async (the same kernel; no other path).
//
// float32 (the checks and the float32 smoke configs): one block of 128
// threads per (64-row q tile, q head, batch), tiles staged in shared memory
// as float32, both products as float32 FMAs.  TF32 would not hold the
// float32 tolerance (2e-5).  Thread (tr, tc) = (tid / 8, tid % 8) owns q
// rows 4tr..4tr+3: scores of key columns tc + 8j, output columns tc + 8j; a
// row's max and denominator reduce over its 8 neighbouring lanes.
//
// What every path keeps from the Pallas kernel:
//   * GQA: q head h reads kv head h / (Hq / Hkv) through the index; K and V
//     are never repeated in memory.
//   * Scores are scaled, then keys past Sk and, when causal, keys after query
//     i + (Sk - Sq) (the mask aligned to the end of the keys) are set to
//     -1e30.  A causal tile that lies wholly after the block's last query is
//     skipped: on every row that sees a key (key 0 is in the first tile)
//     such a tile adds exp(-1e30 - m) = 0.  The output divides by the
//     denominator; the wgmma kernel writes 0 (and lse -inf) on a row that
//     sees no key, the others divide by 1 where the denominator is 0.
//   * q, k, v and the output are read and written through their (batch, head,
//     seq) strides with 64-bit offsets; only the head dim is contiguous.
//   * No atomics and no split of the keys across blocks: two runs give the
//     same bits.
//   * The mma.sync and FMA kernels' head dim is a template tile DT in {16,
//     32, 64, 128, 256} >= d (a multiple of 16), the columns past d zero.
//     Dynamic shared memory, set by cudaFuncSetAttribute: bf16 68 KB at DT
//     = 128, 99 KB at 256; float32 72.6 KB at 128, 137 KB at 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

constexpr float kLn2 = 0.6931471805599453f;

// a query row's log-sum-exp (natural log) from its running max and log
// denominator in the units of the scores it kept (base 2: unit = ln 2);
// -inf for a row that sees no key (causal, query i + Sk - Sq < 0), whose
// max and denominator count masked keys
__device__ __forceinline__ float row_lse(int causal, int last_key,
                                         float log_sum, float unit) {
  return (causal && last_key < 0) ? -__int_as_float(0x7f800000)
                                   : log_sum * unit;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kBK = 32;       // keys per K / V tile

// m tiles a warp holds
template <int DT>
__host__ __device__ constexpr int mma_mt() { return DT <= 128 ? 2 : 1; }

// q rows a block
template <int DT>
__host__ __device__ constexpr int mma_bq() { return 64 * mma_mt<DT>(); }

template <int DT>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (DT + 8) * (mma_bq<DT>() + 4 * kBK);
}

// rows r0 .. r0 + ROWS - 1 of a (seq, d) bf16 slice with seq stride `ld`
// into a [ROWS][DT + 8] tile, zero past `nrows` and past d
template <int ROWS, int DT>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long ld, int r0, int nrows,
                                           int d, bool vec, int tid) {
  tc::stage<kThreads>(dst, DT + 8, src + r0 * ld, ld, nrows - r0, d, ROWS,
                      DT, vec, tid);
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
flash_attention_mma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int group, int Sq, int Sk, int d, Strides qs, Strides ks,
                    Strides vs, Strides os, float scale_log2, int causal,
                    int vec) {
  constexpr int MT = mma_mt<DT>();
  constexpr int BQ = mma_bq<DT>();
  constexpr int LDS = DT + 8;
  constexpr int NT = kBK / 8;          // n8 tiles of a score row block
  constexpr int OT = DT / 8;           // n8 tiles of an output row block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LDS]
  __nv_bfloat16* kt = qt + BQ * LDS;          // [2][kBK][LDS]
  __nv_bfloat16* vt = kt + 2 * kBK * LDS;     // [2][kBK][LDS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // the longest causal tiles first: the last q tile is the first block
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int offset = Sk - Sq;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

  int k_end = Sk;
  if (causal) {
    const int last_q = min(q0 + BQ, Sq) - 1;
    k_end = max(0, min(Sk, last_q + offset + 1));
  }
  const int ntiles = (k_end + kBK - 1) / kBK;

  stage_rows<BQ, DT>(qt, qb, qs.s, q0, Sq, d, vec, tid);
  if (ntiles > 0) {
    stage_rows<kBK, DT>(kt, kb, ks.s, 0, Sk, d, vec, tid);
    stage_rows<kBK, DT>(vt, vb, vs.s, 0, Sk, d, vec, tid);
  }
  tc::cp_async_commit();

  float acc[MT][OT][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = kNegInf;
      l[mt][r] = 0.f;
    }
#pragma unroll
    for (int ot = 0; ot < OT; ++ot)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][ot][e] = 0.f;
  }
  // first q row of this warp's m tile mt (block-relative)
  auto row0 = [&](int mt) { return (warp * MT + mt) * 16; };

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    const int k0 = it * kBK;
    if (it + 1 < ntiles) {
      stage_rows<kBK, DT>(kt + (st ^ 1) * kBK * LDS, kb, ks.s, k0 + kBK, Sk,
                          d, vec, tid);
      stage_rows<kBK, DT>(vt + (st ^ 1) * kBK * LDS, vb, vs.s, k0 + kBK, Sk,
                          d, vec, tid);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ktile = kt + st * kBK * LDS;
    const __nv_bfloat16* vtile = vt + st * kBK * LDS;

    // S = Q K^T
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tc::ldmatrix_x4(a[mt], qt + (row0(mt) + (lane & 15)) * LDS + kk * 16 +
                                   (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        tc::ldmatrix_x4(bf, ktile + (np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                        LDS +
                                kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          tc::mma_bf16(s[mt][2 * np], a[mt], bf[0], bf[1]);
          tc::mma_bf16(s[mt][2 * np + 1], a[mt], bf[2], bf[3]);
        }
      }
    }

    // mask, online softmax (base 2), P rounded to bf16 as the A fragments;
    // a tile whose keys every row of the block sees takes no mask
    const bool whole =
        k0 + kBK <= Sk && (!causal || k0 + kBK - 1 <= q0 + offset);
    uint32_t pa[MT][NT / 2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int qrow = q0 + row0(mt) + g;      // rows qrow and qrow + 8
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
          const int qpos = qrow + (e >> 1) * 8;
          const bool ok =
              whole || (kpos < Sk && (!causal || qpos + offset >= kpos));
          const float x = ok ? s[mt][nt][e] * scale_log2 : kNegInf;
          s[mt][nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[mt][r], mx[r]);
        corr[r] = exp2f(m[mt][r] - m_new);
        m[mt][r] = m_new;
        l[mt][r] *= corr[r];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[mt][nt][e] - m[mt][e >> 1]);
          s[mt][nt][e] = p;
          l[mt][e >> 1] += p;
        }
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        pa[mt][kk][0] = tc::pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        pa[mt][kk][1] = tc::pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        pa[mt][kk][2] = tc::pack_bf16(s[mt][2 * kk + 1][0],
                                      s[mt][2 * kk + 1][1]);
        pa[mt][kk][3] = tc::pack_bf16(s[mt][2 * kk + 1][2],
                                      s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        acc[mt][ot][0] *= corr[0];
        acc[mt][ot][1] *= corr[0];
        acc[mt][ot][2] *= corr[1];
        acc[mt][ot][3] *= corr[1];
      }
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int op = 0; op < OT / 2; ++op) {
        uint32_t bf[4];
        tc::ldmatrix_x4_trans(
            bf, vtile + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDS +
                    op * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          tc::mma_bf16(acc[mt][2 * op], pa[mt][kk], bf[0], bf[1]);
          tc::mma_bf16(acc[mt][2 * op + 1], pa[mt][kk], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }
  tc::cp_async_wait<0>();  // a block that skipped every tile

  __nv_bfloat16* ob = o + b * os.b + h * os.h;
  // a thread's two neighbouring columns go out as one bf16x2 where aligned
  const bool pair = ((d | os.b | os.h | os.s) & 1) == 0 &&
                    (reinterpret_cast<uintptr_t>(o) & 3) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float den = l[mt][r];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      const int qpos = q0 + row0(mt) + g + 8 * r;
      if (qpos >= Sq) continue;
      if (lse != nullptr && t == 0)
        lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qpos] =
            row_lse(causal, qpos + offset, m[mt][r] + log2f(den), kLn2);
      den = den == 0.f ? 1.f : den;
      __nv_bfloat16* orow = ob + static_cast<long long>(qpos) * os.s;
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        const int col = ot * 8 + 2 * t;
        const float v0 = acc[mt][ot][2 * r] / den;
        const float v1 = acc[mt][ot][2 * r + 1] / den;
        if (pair) {
          if (col < d)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < d) orow[col] = __float2bfloat16(v0);
          if (col + 1 < d) orow[col + 1] = __float2bfloat16(v1);
        }
      }
    }
}

template <int DT>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int d,
               Strides qs, Strides ks, Strides vs, Strides os, float scale,
               int causal, int vec, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DT>();
  auto kern = flash_attention_mma<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int BQ = mma_bq<DT>();
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, Hq / Hkv, Sq, Sk, d, qs, ks, vs, os, scale * kLog2e, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: FMAs from shared memory
// ---------------------------------------------------------------------------

constexpr int kFBQ = 64;      // q rows per block
constexpr int kFBK = 32;      // keys per k tile
constexpr int kRows = 4;      // q rows per thread

template <int DT>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) * (kFBQ * (DT + 1) + kFBK * (DT + 1) + kFBK * DT +
                          kFBQ * (kFBK + 1));
}

__device__ __forceinline__ float row_max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
flash_attention_fma(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int group, int Sq, int Sk, int d,
                    Strides qs, Strides ks, Strides vs, Strides os,
                    float scale, int causal) {
  constexpr int LD = DT + 1;           // padded row of the q and k tiles
  constexpr int LDP = kFBK + 1;        // padded row of the p tile
  constexpr int SC = kFBK / 8;         // score columns per thread
  constexpr int OC = DT / 8;           // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                    // [kFBQ][LD]
  float* kt = qt + kFBQ * LD;          // [kFBK][LD]
  float* vt = kt + kFBK * LD;          // [kFBK][DT]
  float* pt = vt + kFBK * DT;          // [kFBQ][LDP]

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int q0 = blockIdx.x * kFBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int offset = Sk - Sq;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < kFBQ * DT; i += kThreads) {
    const int r = i / DT, c = i % DT;
    float x = 0.f;
    if (q0 + r < Sq && c < d) x = qb[(q0 + r) * qs.s + c];
    qt[r * LD + c] = x;
  }

  float m[kRows], l[kRows], acc[kRows][OC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  int k_end = Sk;
  if (causal) {
    const int last_q = min(q0 + kFBQ, Sq) - 1;
    k_end = max(0, min(Sk, last_q + offset + 1));
  }

  for (int k0 = 0; k0 < k_end; k0 += kFBK) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int i = tid; i < kFBK * DT; i += kThreads) {
      const int r = i / DT, c = i % DT;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Sk && c < d) {
        kx = kb[(k0 + r) * ks.s + c];
        vx = vb[(k0 + r) * vs.s + c];
      }
      kt[r * LD + c] = kx;
      vt[r * DT + c] = vx;
    }
    __syncthreads();

    float s[kRows][SC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DT; ++kk) {
      float qv[kRows], kv[SC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qt[(tr * kRows + i) * LD + kk];
#pragma unroll
      for (int j = 0; j < SC; ++j) kv[j] = kt[(tc + 8 * j) * LD + kk];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = tr * kRows + i;
      const int qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int kpos = k0 + tc + 8 * j;
        const bool ok = kpos < Sk && (!causal || qpos + offset >= kpos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max8(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const float p = expf(s[i][j] - m_new);
        pt[row * LDP + tc + 8 * j] = p;
        rs += p;
      }
      rs = row_sum8(rs);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kFBK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = pt[(tr * kRows + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float vv = vt[kk * DT + tc + 8 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + tr * kRows + i;
    if (qpos >= Sq) continue;
    if (lse != nullptr && tc == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + qpos] =
          row_lse(causal, qpos + offset, m[i] + logf(l[i]), 1.f);
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = tc + 8 * c;
      if (col < d) ob[qpos * os.s + col] = acc[i][c] / den;
    }
  }
}

template <int DT>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Hq, int Hkv, int Sq, int Sk, int d,
               Strides qs, Strides ks, Strides vs, Strides os, float scale,
               int causal, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<DT>();
  auto kern = flash_attention_fma<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kFBQ - 1) / kFBQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Hq / Hkv,
      Sq, Sk, d, qs, ks, vs, os, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// f(DT) for the head-dim tile DT: the smallest of 16, 32, 64, 128, 256
// that holds d
template <typename F>
int by_tile(int d, F&& f) {
  if (d <= 16) return f(std::integral_constant<int, 16>());
  if (d <= 32) return f(std::integral_constant<int, 32>());
  if (d <= 64) return f(std::integral_constant<int, 64>());
  if (d <= 128) return f(std::integral_constant<int, 128>());
  if (d <= 256) return f(std::integral_constant<int, 256>());
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}


// ---------------------------------------------------------------------------
// backward: dq, dk and dv of the attention above
// ---------------------------------------------------------------------------
//
// Replaces no Pallas kernel: the reference has no backward kernel and takes
// its gradient by jax.grad of the plain form (_attn_ref / _attn_chunked,
// src/repro/models/layers.py:92).  This is that gradient, computed as
// FlashAttention 2 computes it, from the forward's output O and its row
// log-sum-exp (lse), with S = scale Q K^T recomputed tile by tile:
//   P = exp(S - lse)     dV = P^T dO     dP = dO V^T
//   D = rowsum(dO o O)   dS = P o (dP - D)
//   dQ = scale dS K      dK = scale dS^T Q
// Three launches: attn_bwd_prep (D, one warp a row), attn_bwd_dkdv (one
// block a key block of one kv head: it walks the group's query heads and
// the query tiles that see the block, so dK and dV of a GQA group sum
// inside one block, with no atomics) and attn_bwd_dq (one block a query
// tile of one head: it walks the key tiles the tile sees).  Every sum runs
// in a fixed order, so the gradient is the same bits on every run.
//
// Masks are the forward's: key padding, the causal mask aligned to the end
// of the keys, and query padding; a masked pair takes P = 0 by a select, so
// a row that sees no key (lse = -inf) adds nothing anywhere and gets dq 0.
//
// Bound on the card: operations.  attn_bwd_dkdv runs four products of
// 2 B Hq Sq Sk d operations (S^T, dP^T, dV, dK) and attn_bwd_dq three (S, dP
// again, dQ), half of each when causal, on O((Sq + Sk) d) bytes: far above
// the card's balance point, so the products must run at the tensor cores'
// rate.  Splitting dq from dk / dv costs two products more than a fused
// backward with atomics on dQ, and buys bits that do not change from run
// to run.  Head dims up to 128 (every configuration's).
//
// bfloat16 (the training path) runs on Hopper's own datapath: wgmma, the
// only instruction that reaches the tensor cores' full rate, on tiles that
// TMA copies into shared memory (hopper.cuh).  A block is two consumer
// warpgroups; a ring of two or three stages of operand tiles stays in
// flight under mbarriers, each stage refilled by the warp that reads it
// last, so no
// thread copies and no block barrier stands between two tiles.  The block's
// own operands stay resident: K and V in dkdv (one block a 128-key block of
// a kv head), Q and dO in dq (one block a 128-row query tile of a query
// head).  The accumulators of S (S^T) and dP (dP^T), turned into P and dS
// in registers and rounded to bf16, are the A operands of the next
// products as they lie (a wgmma accumulator is mma.sync's C fragment
// repeated across the n8 columns); B of those products is the same shared
// tile read MN-major, so no operand is transposed in memory.  A tile whose
// pairs the masks all keep skips the mask; a warpgroup whose rows see no
// key of a stage skips its products.  The tensor maps describe q, k, v and
// dO as they lie, (batch, head, seq) strides included, so the training
// path's transpose(1, 2) views need no copy; the wrapper stages a copy only
// of an operand whose base or stride is not a multiple of 16 bytes.
// float32 (the checks and the float32 smoke configs) runs as float32 FMAs
// from shared memory.

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// D[row] = sum_c dO[row, c] O[row, c], one warp a (batch, head, query) row
template <typename E>
__global__ void __launch_bounds__(kThreads)
attn_bwd_prep(const E* __restrict__ o, const E* __restrict__ dout,
              float* __restrict__ D, long long rows, int Hq, int Sq, int d,
              Strides os, Strides dos) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const long long i = row % Sq;
  const long long h = (row / Sq) % Hq;
  const long long b = row / (static_cast<long long>(Sq) * Hq);
  const E* orow = o + b * os.b + h * os.h + i * os.s;
  const E* drow = dout + b * dos.b + h * dos.h + i * dos.s;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += to_f(orow[c]) * to_f(drow[c]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) D[row] = acc;
}

// --- bfloat16: wgmma on TMA tiles --------------------------------------------
//
// A block is two consumer warpgroups, each owning 64 rows of the block's
// resident tile.  The other operand's tiles stream through a ring of
// shared-memory stages by TMA: a `full` mbarrier a stage, which the TMA's
// bytes complete, and an `empty` one, on which each warp arrives once it
// has read the stage; the warp whose arrival completes it (the barrier's
// pending count was 1) starts the refill, so no warp waits for another to
// finish a stage, no thread copies and no atomic is used.  There is no
// producer warp: at a launch bound of 288 or 384 threads ptxas keeps the
// consumers of dk/dv at d = 128 well below the ~230 registers they need
// and serialises every wgmma (C7512, whatever setmaxnreg grants), while at
// 256 threads the whole kernel gets them.

constexpr int kWg = 128;                  // threads a warpgroup
constexpr int kBwdThreads = 2 * kWg;
constexpr int kReaders = kBwdThreads / 32;   // warps that read a stage
constexpr int kKvStages = 2;              // dkdv: Q / dO ring stages
constexpr int kKvBK = 128;                // dkdv: keys a block (64 each)
constexpr int kKvBQ = 64;                 // dkdv: query rows a Q / dO stage
constexpr int kDqBQ = 128;                // dq: query rows a block (64 each)

// dq's K / V stage: 128 keys in two stages at DT = 128, where S and dP as
// m64n128 products read fewer shared-memory bytes an operation than as
// m64n64; 64 keys in three at DT = 64, where the wider tile was slower on
// the H100
template <int DT>
struct DqTile {
  static constexpr int kBK = DT > 64 ? 128 : 64;
  static constexpr int kStages = DT > 64 ? 2 : 3;
};

// shared memory of the dk/dv kernel, byte offsets from a 1024-aligned base:
// K and V resident ([DT / 64 panels][128 keys][64]), the Q and dO ring
// ([kKvStages][DT / 64][64 rows][64]), each stage's lse and D rows, the
// mbarriers (K and V's, then full and empty a stage)
template <int DT>
struct DkdvSmem {
  static constexpr int kKv = kKvBK * DT * 2;      // K or V
  static constexpr int kQ = kKvBQ * DT * 2;       // a Q or dO stage
  static constexpr int kRow = kKvBQ * 4;          // a stage's lse or D
  static constexpr int k = 0, v = kKv, q = 2 * kKv, dout = q + kKvStages * kQ;
  static constexpr int lse = dout + kKvStages * kQ, D = lse + kKvStages * kRow;
  static constexpr int bars = D + kKvStages * kRow;
  static constexpr int bytes = bars + 8 * (1 + 2 * kKvStages) + 1024;
};

// shared memory of the dq kernel: Q and dO resident ([DT / 64][128][64]),
// the K and V ring ([stages][DT / 64][BK keys][64]), the mbarriers (Q and
// dO's, then full and empty a stage)
template <int DT>
struct DqSmem {
  static constexpr int kQ = kDqBQ * DT * 2;       // Q or dO
  static constexpr int kBK = DqTile<DT>::kBK, kDqStages = DqTile<DT>::kStages;
  static constexpr int kK = kBK * DT * 2;         // a K or V stage
  static constexpr int q = 0, dout = kQ, k = 2 * kQ, v = k + kDqStages * kK;
  static constexpr int bars = v + kDqStages * kK;
  static constexpr int bytes = bars + 8 * (1 + 2 * kDqStages) + 1024;
};

// p moved up to the next 1024-byte boundary of the shared window, by an
// offset on p itself (so the compiler still knows it points into shared
// memory and keeps 32-bit shared addresses)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (hop::smem_u32(p) & 1023)) & 1023);
}

// the accumulators of an m16 x n(2 NP x 8) product as the A fragments of the
// next product, whose k runs over those n columns (rounded to bf16)
template <int NP>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[NP][4],
                                         const float (&c)[2 * NP][4]) {
#pragma unroll
  for (int kk = 0; kk < NP; ++kk) {
    a[kk][0] = tc::pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = tc::pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = tc::pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = tc::pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// one warp's 16 rows of an m16 x DT accumulator out, scaled, where the row
// lies below `nrows` (rows r0 + g and r0 + g + 8; columns 8 ot + 2t, + 1),
// two columns a store where `pair` (d even, even strides, 4-byte base)
template <int OT>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, long long ld,
                                          int r0, int nrows, int d,
                                          const float (&acc)[OT][4],
                                          float mul, int g, int t, bool pair) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= nrows) continue;
    __nv_bfloat16* out = base + static_cast<long long>(row) * ld;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
      const int col = ot * 8 + 2 * t;
      const float lo = acc[ot][2 * r] * mul, hi = acc[ot][2 * r + 1] * mul;
      if (pair && col + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(lo, hi);
      } else {
        if (col < d) out[col] = __float2bfloat16(lo);
        if (col + 1 < d) out[col + 1] = __float2bfloat16(hi);
      }
    }
  }
}

// A descriptor of a K-major operand: the 64 rows from `row0` of a
// [DT / 64][ROWS][64] panel tile, k columns 0 .. 15; k columns 16 kk ..
// are kstep<ROWS>(kk) further (32 bytes a step inside a panel, the next
// panel every four)
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(const __nv_bfloat16* tile,
                                           int row0) {
  return hop::opaque(hop::desc_sw128(tile + row0 * 64, 16, 1024));
}

template <int ROWS>
__host__ __device__ constexpr uint64_t kstep(int kk) {
  return static_cast<uint64_t>((kk / 4) * ROWS * 128 + (kk % 4) * 32) >> 4;
}

// a descriptor of an MN-major operand: k rows 0 .. 15 of a
// [DT / 64][ROWS][64] panel tile, all DT columns (the panels ROWS * 128
// bytes apart); k rows 16 kk .. are 2048 kk bytes further
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(const __nv_bfloat16* tile) {
  return hop::opaque(hop::desc_sw128(tile, ROWS * 128, 1024));
}

constexpr uint64_t kMnStep = 2048 >> 4;

// this warp is done with a stage: its lane 0 arrives on the stage's
// `empty` barrier (one arrival a warp); true on the lane whose arrival
// completes it, which refills the stage
__device__ __forceinline__ bool release_last(uint64_t* empty, int lane) {
  __syncwarp();
  return lane == 0 && hop::mbar_arrive_last(empty);
}

// dK and dV of one key block of one kv head.  Warpgroup w holds keys
// k0 + 64 w ..: per Q / dO stage (64 query rows of one query head), S^T =
// K Q^T and dP^T = V dO^T (wgmma, both operands in shared memory), P^T =
// exp2(S^T scale log2 e - lse log2 e) while dP^T runs, dS^T = P^T o (dP^T
// - D), both in the accumulators' registers, then dV += P^T dO and dK +=
// dS^T Q (wgmma, A the packed registers, B the same dO and Q stages read
// MN-major).  Every wgmma group retires inside its stage (an accumulator
// in flight across the loop's back edge makes ptxas serialise: C7515).
// The stages come in a fixed order, the group's query heads in turn, each
// from the first query tile that sees the block to the last.  The grid
// runs key block fastest, so the blocks in flight share a few GQA groups'
// Q and dO in L2, and each group's longest causal blocks start first.
template <int DT>
__global__ void __launch_bounds__(kBwdThreads, 1)
attn_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tlse,
                    const __grid_constant__ CUtensorMap tD,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int Hq, int group,
                    int Sq, int Sk, int d, Strides dks, Strides dvs,
                    float scale, int causal, int pair) {
  using L = DkdvSmem<DT>;
  constexpr int NP = DT / 64;          // panels of a row
  constexpr int OT = DT / 8;           // n8 tiles of a dK / dV row block
  constexpr int NT = kKvBQ / 8;        // n8 tiles of an S^T row block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(sm + L::k);
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(sm + L::v);
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(sm + L::q);
  __nv_bfloat16* dot = reinterpret_cast<__nv_bfloat16*>(sm + L::dout);
  float* lses = reinterpret_cast<float*>(sm + L::lse);   // [kKvStages][BQ]
  float* drs = reinterpret_cast<float*>(sm + L::D);      // [kKvStages][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kKvStages;

  const int k0 = blockIdx.x * kKvBK;   // the longest causal blocks first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int offset = Sk - Sq;
  // the query tiles that see key k0 or later: query i sees key j when
  // i + offset >= j, so the first is tile (k0 - offset) / BQ
  const int qt0 = causal ? max(0, k0 - offset) / kKvBQ : 0;
  const int nq = max(0, (Sq + kKvBQ - 1) / kKvBQ - qt0);
  const int total = group * nq;
  const int wg = hop::warpgroup();
  const int lane = threadIdx.x & 31;

  // stage s takes step j: the Q and dO rows of (query head, query tile)
  // (hk group + j / nq, qt0 + j % nq), and their lse and D
  auto load_stage = [&](int j, int s) {
    const int h = hk * group + j / nq;
    const int qq0 = (qt0 + j % nq) * kKvBQ;
    hop::mbar_arrive_expect_tx(&full[s], 2 * L::kQ + 2 * L::kRow);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      hop::tma_load_4d(qt + (s * NP + p) * kKvBQ * 64, &tq, &full[s], 64 * p,
                       qq0, h, b);
      hop::tma_load_4d(dot + (s * NP + p) * kKvBQ * 64, &tdo, &full[s],
                       64 * p, qq0, h, b);
    }
    hop::tma_load_2d(lses + s * kKvBQ, &tlse, &full[s], qq0, b * Hq + h);
    hop::tma_load_2d(drs + s * kKvBQ, &tD, &full[s], qq0, b * Hq + h);
  };

  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < kKvStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kReaders);
    }
    hop::fence_barrier_init();
    if (total > 0) {
      hop::mbar_arrive_expect_tx(kv_full, 2 * L::kKv);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        hop::tma_load_4d(kt + p * kKvBK * 64, &tk, kv_full, 64 * p, k0, hk, b);
        hop::tma_load_4d(vt + p * kKvBK * 64, &tv, kv_full, 64 * p, k0, hk, b);
      }
      for (int j = 0; j < min(kKvStages, total); ++j) load_stage(j, j);
    }
  }
  __syncthreads();

  const int warp = (threadIdx.x >> 5) & 3;   // in the warpgroup
  const int g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + 64 * wg;        // this warpgroup's first key
  const float sl2 = scale * kLog2e;

  float dka[OT][4], dva[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[ot][e] = dva[ot][e] = 0.f;

  if (total > 0) hop::mbar_wait(kv_full, 0);
  for (int it = 0; it < total; ++it) {
    const int s = it % kKvStages, round = it / kKvStages;
    const int qq0 = (qt0 + it % nq) * kKvBQ;
    hop::mbar_wait(&full[s], round & 1);
    // does a query of the stage see a key of this warpgroup?
    if (kw0 < Sk && (!causal || qq0 + kKvBQ - 1 + offset >= kw0)) {
      const __nv_bfloat16* qs = qt + s * NP * kKvBQ * 64;
      const __nv_bfloat16* ds = dot + s * NP * kKvBQ * 64;
      const float* ls = lses + s * kKvBQ;
      const float* dr = drs + s * kKvBQ;
      float st[NT][4], dpt[NT][4];     // S^T then P^T; dP^T then dS^T
      {
        const uint64_t ka = desc_k<kKvBK>(kt, 64 * wg);
        const uint64_t va = desc_k<kKvBK>(vt, 64 * wg);
        const uint64_t qb = desc_k<kKvBQ>(qs, 0);
        const uint64_t db = desc_k<kKvBQ>(ds, 0);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DT / 16; ++kk)
          hop::wgmma_ss(st, ka + kstep<kKvBK>(kk), qb + kstep<kKvBQ>(kk),
                        kk > 0);
        hop::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DT / 16; ++kk)
          hop::wgmma_ss(dpt, va + kstep<kKvBK>(kk), db + kstep<kKvBQ>(kk),
                        kk > 0);
        hop::wgmma_commit();
      }
      // every pair kept: keys and queries inside Sk and Sq, and the
      // stage's first query sees the warpgroup's last key
      const bool whole = kw0 + 64 <= Sk && qq0 + kKvBQ <= Sq &&
                         (!causal || qq0 + offset >= kw0 + 63);
      hop::wgmma_wait<1>();            // S^T is done, dP^T may run on
      hop::fence_regs(st);
      // P^T: rows are keys, columns queries 8 j + 2 t, + 1 (lse and D are
      // 0 past Sq, where the mask drops the pair)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 lj = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = hop::ex2(st[j][e] * sl2 -
                                   ((e & 1) ? lj.y : lj.x) * kLog2e);
          if (whole) {
            st[j][e] = p;
          } else {
            const int kpos = kw0 + warp * 16 + g + (e >> 1) * 8;
            const int qpos = qq0 + 8 * j + 2 * t + (e & 1);
            const bool ok = kpos < Sk && qpos < Sq &&
                            (!causal || qpos + offset >= kpos);
            st[j][e] = ok ? p : 0.f;
          }
        }
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(dpt);
      // dS^T = P^T o (dP^T - D)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 dj = *reinterpret_cast<const float2*>(dr + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[j][e] = st[j][e] * (dpt[j][e] - ((e & 1) ? dj.y : dj.x));
      }
      // packed once dS^T is made, so that P^T is not held twice
      uint32_t pa[NT / 2][4], da[NT / 2][4];
      acc_to_a<NT / 2>(pa, st);
      acc_to_a<NT / 2>(da, dpt);
      // dV += P^T dO, dK += dS^T Q
      const uint64_t db = desc_mn<kKvBQ>(ds), qb = desc_mn<kKvBQ>(qs);
      hop::fence_regs(pa);
      hop::fence_regs(da);
      hop::fence_regs(dva);
      hop::fence_regs(dka);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
        hop::wgmma_rs_tb(dva, pa[kk], db + kk * kMnStep);
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
        hop::wgmma_rs_tb(dka, da[kk], qb + kk * kMnStep);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(dva);
      hop::fence_regs(dka);
    }
    if (release_last(&empty[s], lane) && it + kKvStages < total)
      load_stage(it + kKvStages, s);
  }

  // every product has retired (each stage ends in wait<0>); said here, on
  // the warpgroup's uniform path, the compiler needs no wait of its own
  // inside the stores' row and column branches
  hop::wgmma_wait<0>();
  hop::fence_regs(dka);
  hop::fence_regs(dva);
  const int r0 = kw0 + warp * 16;
  store_acc<OT>(dk + b * dks.b + hk * dks.h, dks.s, r0, Sk, d, dka, scale, g,
                t, pair);
  store_acc<OT>(dv + b * dvs.b + hk * dvs.h, dvs.s, r0, Sk, d, dva, 1.f, g,
                t, pair);
}

// dQ of one 128-row query tile of one query head.  Warpgroup w holds query
// rows q0 + 64 w ..: per K / V stage (DqTile<DT>::kBK keys), S = Q K^T and
// dP = dO V^T (wgmma from shared memory), P while dP runs, dS = P o (dP -
// D), then dQ += dS K (wgmma, A the packed registers, B the K stage read
// MN-major).  The stages come in key order up to the tile's causal end.
// The grid runs query tile fastest, the last (the longest, when causal)
// first.
template <int DT>
__global__ void __launch_bounds__(kBwdThreads, 1)
attn_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, const float* __restrict__ D,
                  __nv_bfloat16* __restrict__ dq, int Hq, int group, int Sq,
                  int Sk, int d, Strides dqs, float scale, int causal,
                  int pair) {
  using L = DqSmem<DT>;
  constexpr int kDqBK = L::kBK, kDqStages = L::kDqStages;
  constexpr int NP = DT / 64;
  constexpr int OT = DT / 8;           // n8 tiles of a dQ row block
  constexpr int NT = kDqBK / 8;        // n8 tiles of an S row block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(sm + L::q);
  __nv_bfloat16* dot = reinterpret_cast<__nv_bfloat16*>(sm + L::dout);
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(sm + L::k);
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(sm + L::v);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kDqStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kDqBQ;  // longest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int offset = Sk - Sq;
  int k_end = Sk;
  if (causal) {
    const int last_q = min(q0 + kDqBQ, Sq) - 1;
    k_end = max(0, min(Sk, last_q + offset + 1));
  }
  const int ntiles = (k_end + kDqBK - 1) / kDqBK;
  const int wg = hop::warpgroup();
  const int lane = threadIdx.x & 31;

  // stage s takes the K and V rows of key tile j
  auto load_stage = [&](int j, int s) {
    hop::mbar_arrive_expect_tx(&full[s], 2 * L::kK);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      hop::tma_load_4d(kt + (s * NP + p) * kDqBK * 64, &tk, &full[s], 64 * p,
                       j * kDqBK, hk, b);
      hop::tma_load_4d(vt + (s * NP + p) * kDqBK * 64, &tv, &full[s], 64 * p,
                       j * kDqBK, hk, b);
    }
  };

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kReaders);
    }
    hop::fence_barrier_init();
    if (ntiles > 0) {
      hop::mbar_arrive_expect_tx(q_full, 2 * L::kQ);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        hop::tma_load_4d(qt + p * kDqBQ * 64, &tq, q_full, 64 * p, q0, h, b);
        hop::tma_load_4d(dot + p * kDqBQ * 64, &tdo, q_full, 64 * p, q0, h,
                         b);
      }
      for (int j = 0; j < min(kDqStages, ntiles); ++j) load_stage(j, j);
    }
  }
  __syncthreads();

  const int warp = (threadIdx.x >> 5) & 3;   // in the warpgroup
  const int g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + 64 * wg;        // this warpgroup's first query row
  const float sl2 = scale * kLog2e;

  // this thread's rows (g and g + 8 of its warp's 16): lse in base 2, D
  const long long rb = (static_cast<long long>(b) * Hq + h) * Sq;
  float l2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw0 + warp * 16 + g + 8 * r;
    l2[r] = qpos < Sq ? lse[rb + qpos] * kLog2e : 0.f;
    dr[r] = qpos < Sq ? D[rb + qpos] : 0.f;
  }

  float acc[OT][4];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ot][e] = 0.f;

  if (ntiles > 0) hop::mbar_wait(q_full, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kDqStages, round = it / kDqStages;
    const int k0 = it * kDqBK;
    hop::mbar_wait(&full[s], round & 1);
    // does a row of this warpgroup see a key of the stage?
    if (qw0 < Sq && (!causal || qw0 + 63 + offset >= k0)) {
      const __nv_bfloat16* ks = kt + s * NP * kDqBK * 64;
      const __nv_bfloat16* vs = vt + s * NP * kDqBK * 64;
      float sc[NT][4], dp[NT][4];      // S then P; dP then dS
      {
        const uint64_t qa = desc_k<kDqBQ>(qt, 64 * wg);
        const uint64_t oa = desc_k<kDqBQ>(dot, 64 * wg);
        const uint64_t kb = desc_k<kDqBK>(ks, 0);
        const uint64_t vb = desc_k<kDqBK>(vs, 0);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DT / 16; ++kk)
          hop::wgmma_ss(sc, qa + kstep<kDqBQ>(kk), kb + kstep<kDqBK>(kk),
                        kk > 0);
        hop::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DT / 16; ++kk)
          hop::wgmma_ss(dp, oa + kstep<kDqBQ>(kk), vb + kstep<kDqBK>(kk),
                        kk > 0);
        hop::wgmma_commit();
      }
      const bool whole = k0 + kDqBK <= Sk && qw0 + 64 <= Sq &&
                         (!causal || qw0 + offset >= k0 + kDqBK - 1);
      hop::wgmma_wait<1>();            // S is done, dP may run on
      hop::fence_regs(sc);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = hop::ex2(sc[j][e] * sl2 - l2[e >> 1]);
          if (whole) {
            sc[j][e] = p;
          } else {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = qw0 + warp * 16 + g + (e >> 1) * 8;
            const bool ok = kpos < Sk && qpos < Sq &&
                            (!causal || qpos + offset >= kpos);
            sc[j][e] = ok ? p : 0.f;
          }
        }
      hop::wgmma_wait<0>();
      hop::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = sc[j][e] * (dp[j][e] - dr[e >> 1]);
      uint32_t da[NT / 2][4];
      acc_to_a<NT / 2>(da, dp);
      // dQ += dS K
      const uint64_t kb = desc_mn<kDqBK>(ks);
      hop::fence_regs(da);
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
        hop::wgmma_rs_tb(acc, da[kk], kb + kk * kMnStep);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
    }
    if (release_last(&empty[s], lane) && it + kDqStages < ntiles)
      load_stage(it + kDqStages, s);
  }

  hop::wgmma_wait<0>();                // as in dkdv
  hop::fence_regs(acc);
  store_acc<OT>(dq + b * dqs.b + h * dqs.h, dqs.s, qw0 + warp * 16, Sq, d,
                acc, scale, g, t, pair);
}

// --- forward, bfloat16 at d = 64 and 128: wgmma on TMA tiles ----------------
//
// One block a 128-row query tile of one query head: two consumer warpgroups
// of 64 rows, the tile's Q resident, K and V in a ring of FwdTile<DT>::
// kStages stages of BK keys under mbarriers (refilled as the backward's:
// by the warp whose arrival completes a stage's `empty` barrier).  Per
// stage, S = Q K^T (wgmma, both operands K-major in shared memory), the
// online softmax in base 2 on the accumulators, P rounded to bf16 in
// registers as the A operand of O += P V (V read MN-major).  The Q K^T of
// the next stage is issued before this stage's softmax and retires under
// it and under this stage's P V (FlashAttention 3's in-warpgroup
// pipelining); every group retires before the loop's back edge (C7515).

constexpr int kFwdBQ = 128;               // query rows a block (64 each)

// keys a K / V stage, stages, and blocks an SM: at DT = 128, 128 keys in
// three stages (225 KB, one block an SM; the S accumulators of two stages,
// O and P take 251 registers; two stages were slower on the H100 at qwen3's
// prefill); at DT = 64, 64 keys in four stages (81 KB, two blocks an SM at
// 128 registers a thread; 128 keys a stage, one block an SM, was slower at
// granite's)
template <int DT>
struct FwdTile {
  static constexpr int kBK = DT > 64 ? 128 : 64;
  static constexpr int kStages = DT > 64 ? 3 : 4;
  static constexpr int kBlocks = DT > 64 ? 1 : 2;
};

// shared memory of the forward: Q resident ([DT / 64][128][64]), the K and
// V ring ([stages][DT / 64][BK][64]), the mbarriers (Q's, then full and
// empty a stage)
template <int DT>
struct FwdSmem {
  static constexpr int kBK = FwdTile<DT>::kBK, kStages = FwdTile<DT>::kStages;
  static constexpr int kQ = kFwdBQ * DT * 2;
  static constexpr int kK = kBK * DT * 2;         // a K or V stage
  static constexpr int q = 0, k = kQ, v = k + kStages * kK;
  static constexpr int bars = v + kStages * kK;
  static constexpr int bytes = bars + 8 * (1 + 2 * kStages) + 1024;
};

// S (64 x BK) = Q K^T of one warpgroup's rows and one K stage, issued and
// committed (not waited for)
template <int DT, int BK>
__device__ __forceinline__ void fwd_scores(float (&s)[BK / 8][4],
                                           const __nv_bfloat16* qt,
                                           const __nv_bfloat16* ks, int wg) {
  const uint64_t qa = desc_k<kFwdBQ>(qt, 64 * wg);
  const uint64_t kb = desc_k<BK>(ks, 0);
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk)
    hop::wgmma_ss(s, qa + kstep<kFwdBQ>(kk), kb + kstep<BK>(kk), kk > 0);
  hop::wgmma_commit();
}

template <int DT>
__global__ void __launch_bounds__(kBwdThreads, FwdTile<DT>::kBlocks)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int B, int Hq, int group, int Sq, int Sk, int d, Strides os,
                float scale_log2, int causal, int pair) {
  using L = FwdSmem<DT>;
  constexpr int BK = L::kBK, kStages = L::kStages;
  constexpr int NP = DT / 64;          // panels of a row
  constexpr int OT = DT / 8;           // n8 tiles of an O row block
  constexpr int NT = BK / 8;           // n8 tiles of an S row block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(sm + L::q);
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(sm + L::k);
  __nv_bfloat16* vt = reinterpret_cast<__nv_bfloat16*>(sm + L::v);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::bars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  // the block index runs over (head, batch) fastest and over the query
  // tiles from the last: every head's longest causal tile starts first
  const int hb = Hq * B;
  const int nq = (Sq + kFwdBQ - 1) / kFwdBQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x / hb)) * kFwdBQ;
  const int h = static_cast<int>(blockIdx.x % Hq);
  const int b = static_cast<int>((blockIdx.x / Hq) % B);
  const int hk = h / group;
  const int offset = Sk - Sq;
  int k_end = Sk;
  if (causal) {
    const int last_q = min(q0 + kFwdBQ, Sq) - 1;
    k_end = max(0, min(Sk, last_q + offset + 1));
  }
  const int ntiles = (k_end + BK - 1) / BK;
  const int wg = hop::warpgroup();
  const int lane = threadIdx.x & 31;

  // stage s takes the K and V rows of key tile j
  auto load_stage = [&](int j, int s) {
    hop::mbar_arrive_expect_tx(&full[s], 2 * L::kK);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      hop::tma_load_4d(kt + (s * NP + p) * BK * 64, &tk, &full[s], 64 * p,
                       j * BK, hk, b);
      hop::tma_load_4d(vt + (s * NP + p) * BK * 64, &tv, &full[s], 64 * p,
                       j * BK, hk, b);
    }
  };

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], kReaders);
    }
    hop::fence_barrier_init();
    if (ntiles > 0) {
      hop::mbar_arrive_expect_tx(q_full, L::kQ);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        hop::tma_load_4d(qt + p * kFwdBQ * 64, &tq, q_full, 64 * p, q0, h, b);
      for (int j = 0; j < min(kStages, ntiles); ++j) load_stage(j, j);
    }
  }
  __syncthreads();

  const int warp = (threadIdx.x >> 5) & 3;   // in the warpgroup
  const int g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + 64 * wg;        // this warpgroup's first query row
  // the key tiles this warpgroup's rows see (the rest it waits for and
  // releases, so that every warp arrives on every stage)
  int k_wg = qw0 < Sq ? Sk : 0;
  if (causal && qw0 < Sq)
    k_wg = max(0, min(Sk, min(qw0 + 64, Sq) - 1 + offset + 1));
  const int nt_wg = min(ntiles, (k_wg + BK - 1) / BK);

  float acc[OT][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int ot = 0; ot < OT; ++ot)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ot][e] = 0.f;

  float sc[NT][4];                     // S, then P, of the current stage
  if (ntiles > 0) hop::mbar_wait(q_full, 0);
  if (nt_wg > 0) {
    hop::mbar_wait(&full[0], 0);
    fwd_scores<DT, BK>(sc, qt, kt, wg);
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
  }
  for (int it = 0; it < ntiles; ++it) {
    const int s = it % kStages;
    if (it < nt_wg) {
      const int k0 = it * BK;
      const bool next = it + 1 < nt_wg;
      float sn[NT][4];                 // S of the next stage, in flight
      if (next) {
        const int s1 = (it + 1) % kStages;
        hop::mbar_wait(&full[s1], ((it + 1) / kStages) & 1);
        fwd_scores<DT, BK>(sn, qt, kt + s1 * NP * BK * 64, wg);
      }
      // the mask (keys past Sk; causal: keys after the row's end), the
      // scale, the running max (a row's four threads by two shuffles)
      const bool whole = k0 + BK <= Sk &&
                         (!causal || qw0 + offset >= k0 + BK - 1);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * scale_log2;
          if (!whole) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int qpos = qw0 + warp * 16 + g + (e >> 1) * 8;
            const bool ok = kpos < Sk && (!causal || qpos + offset >= kpos);
            x = ok ? x : kNegInf;
          }
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = hop::ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = hop::ex2(sc[j][e] - m[e >> 1]);
          sc[j][e] = p;
          l[e >> 1] += p;
        }
      uint32_t pa[NT / 2][4];
      acc_to_a<NT / 2>(pa, sc);
#pragma unroll
      for (int ot = 0; ot < OT; ++ot) {
        acc[ot][0] *= corr[0];
        acc[ot][1] *= corr[0];
        acc[ot][2] *= corr[1];
        acc[ot][3] *= corr[1];
      }
      // O += P V
      const uint64_t vb = desc_mn<BK>(vt + s * NP * BK * 64);
      hop::fence_regs(pa);
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
        hop::wgmma_rs_tb(acc, pa[kk], vb + kk * kMnStep);
      hop::wgmma_commit();
      if (next) {
        hop::wgmma_wait<1>();          // the next S is done, P V may run on
        hop::fence_regs(sn);
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      if (next) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = sn[j][e];
      }
    } else {
      hop::mbar_wait(&full[s], (it / kStages) & 1);
    }
    if (release_last(&empty[s], lane) && it + kStages < ntiles)
      load_stage(it + kStages, s);
  }

  hop::wgmma_wait<0>();                // as in the backward
  hop::fence_regs(acc);
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float den = l[r];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int qpos = qw0 + warp * 16 + g + 8 * r;
    if (qpos >= Sq) continue;
    // a row that sees no key (causal, Sq > Sk): output 0, lse -inf
    const bool sees = !causal || qpos + offset >= 0;
    if (lse != nullptr && t == 0)
      lse[(static_cast<long long>(b) * Hq + h) * Sq + qpos] =
          row_lse(causal, qpos + offset, m[r] + log2f(den), kLn2);
    const float inv = sees && den > 0.f ? 1.f / den : 0.f;
    __nv_bfloat16* orow = ob + static_cast<long long>(qpos) * os.s;
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
      const int col = ot * 8 + 2 * t;
      const float lo = acc[ot][2 * r] * inv, hi = acc[ot][2 * r + 1] * inv;
      if (pair && col + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(lo, hi);
      } else {
        if (col < d) orow[col] = __float2bfloat16(lo);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16(hi);
      }
    }
  }
}

// --- float32: FMAs from shared memory --------------------------------------
//
// 128 threads; thread (tr, tc) = (tid / 8, tid % 8) owns 4 rows 4 tr .. of
// the block's tile and the columns tc + 8 j of each product, as the forward.

constexpr int kFDqBQ = 64;    // dq: query rows a block
constexpr int kFDqBK = 32;    // dq: keys a tile
constexpr int kFKvBK = 64;    // dkdv: keys a block
constexpr int kFKvBQ = 32;    // dkdv: queries a tile

template <int DT>
constexpr size_t dq_fma_smem_bytes() {
  return sizeof(float) * ((DT + 1) * (2 * kFDqBQ + 2 * kFDqBK) +
                          kFDqBQ * (kFDqBK + 1));
}

template <int DT>
constexpr size_t dkdv_fma_smem_bytes() {
  return sizeof(float) * ((DT + 1) * (2 * kFKvBK + 2 * kFKvBQ) +
                          2 * kFKvBK * (kFKvBQ + 1) + 2 * kFKvBQ);
}

// rows [r0, r0 + ROWS) of a (seq, d) float32 slice into a [ROWS][LD] tile,
// zero past nrows and past d
template <int ROWS, int DT>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long ld, int r0, int nrows,
                                              int d, int tid) {
  for (int i = tid; i < ROWS * DT; i += kThreads) {
    const int r = i / DT, c = i % DT;
    dst[r * (DT + 1) + c] =
        (r0 + r < nrows && c < d) ? src[(r0 + r) * ld + c] : 0.f;
  }
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ D,
                float* __restrict__ dq, int group, int Sq, int Sk, int d,
                Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
                float scale, int causal) {
  constexpr int LD = DT + 1;
  constexpr int LDP = kFDqBK + 1;
  constexpr int SC = kFDqBK / 8;       // key columns a thread
  constexpr int OC = DT / 8;           // dq columns a thread
  extern __shared__ float smem[];
  float* qt = smem;                    // [BQ][LD]
  float* dot = qt + kFDqBQ * LD;       // [BQ][LD]
  float* kt = dot + kFDqBQ * LD;       // [BK][LD]
  float* vt = kt + kFDqBK * LD;        // [BK][LD]
  float* dst = vt + kFDqBK * LD;       // [BQ][LDP]

  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const int q0 = blockIdx.x * kFDqBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int offset = Sk - Sq;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  load_rows_f32<kFDqBQ, DT>(qt, q + b * qs.b + h * qs.h, qs.s, q0, Sq, d,
                            tid);
  load_rows_f32<kFDqBQ, DT>(dot, dout + b * dos.b + h * dos.h, dos.s, q0, Sq,
                            d, tid);
  const long long row_base = (static_cast<long long>(b) * gridDim.y + h) * Sq;
  float lr[kRows], dr[kRows], acc[kRows][OC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + tr * kRows + i;
    lr[i] = qpos < Sq ? lse[row_base + qpos] : 0.f;
    dr[i] = qpos < Sq ? D[row_base + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }
  int k_end = Sk;
  if (causal) {
    const int last_q = min(q0 + kFDqBQ, Sq) - 1;
    k_end = max(0, min(Sk, last_q + offset + 1));
  }
  for (int k0 = 0; k0 < k_end; k0 += kFDqBK) {
    __syncthreads();  // the previous tile's k, v and dS are consumed
    load_rows_f32<kFDqBK, DT>(kt, kb, ks.s, k0, Sk, d, tid);
    load_rows_f32<kFDqBK, DT>(vt, vb, vs.s, k0, Sk, d, tid);
    __syncthreads();
    float s[kRows][SC], dp[kRows][SC];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < DT; ++kk) {
      float qv[kRows], dov[kRows], kv[SC], vv[SC];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = qt[(tr * kRows + i) * LD + kk];
        dov[i] = dot[(tr * kRows + i) * LD + kk];
      }
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        kv[j] = kt[(tc + 8 * j) * LD + kk];
        vv[j] = vt[(tc + 8 * j) * LD + kk];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = tr * kRows + i, qpos = q0 + row;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int kpos = k0 + tc + 8 * j;
        const bool ok = kpos < Sk && qpos < Sq &&
                        (!causal || qpos + offset >= kpos);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        dst[row * LDP + tc + 8 * j] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kFDqBK; ++kk) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = dst[(tr * kRows + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float kv = kt[kk * LD + tc + 8 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }
  float* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + tr * kRows + i;
    if (qpos >= Sq) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = tc + 8 * c;
      if (col < d) dqb[qpos * dqs.s + col] = acc[i][c] * scale;
    }
  }
}

template <int DT>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_fma(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ D,
                  float* __restrict__ dk, float* __restrict__ dv, int Hq,
                  int group, int Sq, int Sk, int d, Strides qs, Strides ks,
                  Strides vs, Strides dos, Strides dks, Strides dvs,
                  float scale, int causal) {
  constexpr int LD = DT + 1;
  constexpr int LDP = kFKvBQ + 1;
  constexpr int SC = kFKvBQ / 8;       // query columns a thread
  constexpr int OC = DT / 8;           // dk / dv columns a thread
  extern __shared__ float smem[];
  float* kt = smem;                    // [BK][LD]
  float* vt = kt + kFKvBK * LD;        // [BK][LD]
  float* qt = vt + kFKvBK * LD;        // [BQ][LD]
  float* dot = qt + kFKvBQ * LD;       // [BQ][LD]
  float* pt = dot + kFKvBQ * LD;       // [BK][LDP]  P^T
  float* dst = pt + kFKvBK * LDP;      // [BK][LDP]  dS^T
  float* ls = dst + kFKvBK * LDP;      // [BQ]
  float* dsr = ls + kFKvBQ;            // [BQ]

  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;
  const int k0 = blockIdx.x * kFKvBK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int offset = Sk - Sq;
  load_rows_f32<kFKvBK, DT>(kt, k + b * ks.b + hk * ks.h, ks.s, k0, Sk, d,
                            tid);
  load_rows_f32<kFKvBK, DT>(vt, v + b * vs.b + hk * vs.h, vs.s, k0, Sk, d,
                            tid);
  float dka[kRows][OC], dva[kRows][OC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int q_lo = causal ? max(0, k0 - offset) / kFKvBQ * kFKvBQ : 0;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* dob = dout + b * dos.b + h * dos.h;
    const long long row_base = (static_cast<long long>(b) * Hq + h) * Sq;
    for (int qq0 = q_lo; qq0 < Sq; qq0 += kFKvBQ) {
      __syncthreads();  // the previous tile's q, dO, P and dS are consumed
      load_rows_f32<kFKvBQ, DT>(qt, qb, qs.s, qq0, Sq, d, tid);
      load_rows_f32<kFKvBQ, DT>(dot, dob, dos.s, qq0, Sq, d, tid);
      if (tid < kFKvBQ) {
        const int qpos = qq0 + tid;
        ls[tid] = qpos < Sq ? lse[row_base + qpos] : 0.f;
        dsr[tid] = qpos < Sq ? D[row_base + qpos] : 0.f;
      }
      __syncthreads();
      float s[kRows][SC], dp[kRows][SC];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < DT; ++kk) {
        float kv[kRows], vv[kRows], qv[SC], dov[SC];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kv[i] = kt[(tr * kRows + i) * LD + kk];
          vv[i] = vt[(tr * kRows + i) * LD + kk];
        }
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          qv[j] = qt[(tc + 8 * j) * LD + kk];
          dov[j] = dot[(tc + 8 * j) * LD + kk];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < SC; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = tr * kRows + i, kpos = k0 + row;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int ql = tc + 8 * j, qpos = qq0 + ql;
          const bool ok = kpos < Sk && qpos < Sq &&
                          (!causal || qpos + offset >= kpos);
          const float p = ok ? expf(s[i][j] * scale - ls[ql]) : 0.f;
          pt[row * LDP + ql] = p;
          dst[row * LDP + ql] = p * (dp[i][j] - dsr[ql]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < kFKvBQ; ++qq) {
        float pv[kRows], dsv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pv[i] = pt[(tr * kRows + i) * LDP + qq];
          dsv[i] = dst[(tr * kRows + i) * LDP + qq];
        }
#pragma unroll
        for (int c = 0; c < OC; ++c) {
          const float dov = dot[qq * LD + tc + 8 * c];
          const float qv = qt[qq * LD + tc + 8 * c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            dva[i][c] = fmaf(pv[i], dov, dva[i][c]);
            dka[i][c] = fmaf(dsv[i], qv, dka[i][c]);
          }
        }
      }
    }
  }
  float* dkb = dk + b * dks.b + hk * dks.h;
  float* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kpos = k0 + tr * kRows + i;
    if (kpos >= Sk) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = tc + 8 * c;
      if (col >= d) continue;
      dkb[kpos * dks.s + col] = dka[i][c] * scale;
      dvb[kpos * dvs.s + col] = dva[i][c];
    }
  }
}

// f(DT) for the backward's head-dim tile: the smallest of 16, 32, 64, 128
// that holds d
template <typename F>
int by_tile_bwd(int d, F&& f) {
  if (d <= 16) return f(std::integral_constant<int, 16>());
  if (d <= 32) return f(std::integral_constant<int, 32>());
  if (d <= 64) return f(std::integral_constant<int, 64>());
  if (d <= 128) return f(std::integral_constant<int, 128>());
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// the forward's routes, as the wrapper chooses them (ops.forward_kernel,
// whose FORWARD_KERNELS lists them in this order)
enum FwdRoute { kRouteFma = 0, kRouteMma = 1, kRouteWgmma = 2 };

bool route_fits(int route, int d) {
  return route == kRouteFma || route == kRouteMma ||
         (route == kRouteWgmma && (d == 64 || d == 128));
}

// the wgmma forward: q, k and v read by TMA (each base and each (batch,
// head, seq) stride a multiple of 16 bytes; the wrapper stages a copy of
// an operand that is not); a tensor map that cuTensorMapEncodeTiled
// refuses returns 1000 + its CUresult
template <int DT>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                     int d, Strides qs, Strides ks, Strides vs, Strides os,
                     float scale, int causal, cudaStream_t stream) {
  using L = FwdSmem<DT>;
  const long long blocks =
      static_cast<long long>((Sq + kFwdBQ - 1) / kFwdBQ) * Hq * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int err = hop::encode_bf16_panels(&mq, q, d, Sq, Hq, B, qs.s, qs.h, qs.b,
                                    kFwdBQ);
  if (!err)
    err = hop::encode_bf16_panels(&mk, k, d, Sk, Hkv, B, ks.s, ks.h, ks.b,
                                  L::kBK);
  if (!err)
    err = hop::encode_bf16_panels(&mv, v, d, Sk, Hkv, B, vs.s, vs.h, vs.b,
                                  L::kBK);
  if (err) return err;
  err = set_smem(flash_fwd_wgmma<DT>, L::bytes);
  if (err) return err;
  const int pair = d % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 4 == 0 &&
                   os.b % 2 == 0 && os.h % 2 == 0 && os.s % 2 == 0;
  flash_fwd_wgmma<DT><<<static_cast<unsigned>(blocks), kBwdThreads, L::bytes,
                        stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, B, Hq, Hq / Hkv, Sq,
      Sk, d, os, scale * kLog2e, causal, pair);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: device pointers; lse: a contiguous float32 (B, Hq, Sq) that
// takes each query row's log-sum-exp (the backward's input), or null;
// route: the kernel (FwdRoute: FMAs on float32, mma.sync or wgmma on
// bfloat16; wgmma only at d = 64 or 128); strides in elements, (batch,
// head, seq) for each of q, k, v, o.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int route, int B,
    int Hq, int Hkv, int Sq, int Sk, int d, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    float scale, int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk <= 0 || d <= 0 || !route_fits(route, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma)
    return d == 64 ? launch_fwd_wgmma<64>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk,
                                          d, qs, ks, vs, os, scale, causal, st)
                   : launch_fwd_wgmma<128>(q, k, v, o, lse, B, Hq, Hkv, Sq,
                                           Sk, d, qs, ks, vs, os, scale,
                                           causal, st);
  // cp.async moves 16 bytes (8 bf16) from 16-byte aligned addresses
  const long long strides[] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  bool vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (long long s : strides) vec = vec && s % 8 == 0;
  return by_tile(d, [&](auto tile) {
    constexpr int DT = decltype(tile)::value;
    return route == kRouteMma
               ? launch_mma<DT>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, d, qs, ks,
                                vs, os, scale, causal, vec, st)
               : launch_fma<DT>(q, k, v, o, lse, B, Hq, Hkv, Sq, Sk, d, qs, ks,
                                vs, os, scale, causal, st);
  });
}

// the compiled kernel that a launch of this route (FwdRoute) for head dim d
// runs: its registers a thread, its local memory a thread (spills), and the
// dynamic shared memory the launch requests
extern "C" int flash_attention_attributes(int route, int d, int* regs,
                                          int* local_bytes, long long* smem) {
  if (!route_fits(route, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (route == kRouteWgmma) {
    cudaFuncAttributes attr;
    const cudaError_t err =
        d == 64 ? cudaFuncGetAttributes(&attr, flash_fwd_wgmma<64>)
                : cudaFuncGetAttributes(&attr, flash_fwd_wgmma<128>);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *smem = d == 64 ? FwdSmem<64>::bytes : FwdSmem<128>::bytes;
    return 0;
  }
  return by_tile(d, [&](auto tile) {
    constexpr int DT = decltype(tile)::value;
    cudaFuncAttributes attr;
    const bool mma = route == kRouteMma;
    const cudaError_t err =
        mma ? cudaFuncGetAttributes(&attr, flash_attention_mma<DT>)
            : cudaFuncGetAttributes(&attr, flash_attention_fma<DT>);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *smem = mma ? mma_smem_bytes<DT>() : fma_smem_bytes<DT>();
    return 0;
  });
}

// ---------------------------------------------------------------------------
// backward entries: device pointers, strides in elements ((batch, head, seq)
// for each strided operand); lse and D are contiguous float32 (B, Hq, Sq)
// ---------------------------------------------------------------------------

// D = rowsum(dO o O)
extern "C" int attn_bwd_prep_launch(const void* o, const void* dout, float* D,
                                    int is_bf16, int B, int Hq, int Sq, int d,
                                    long long osb, long long osh,
                                    long long oss, long long dosb,
                                    long long dosh, long long doss,
                                    void* stream) {
  const long long rows = static_cast<long long>(B) * Hq * Sq;
  if (rows <= 0) return 0;
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides os{osb, osh, oss}, dos{dosb, dosh, doss};
  constexpr int kRowsPerBlock = kThreads / 32;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (is_bf16)
    attn_bwd_prep<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), D, rows, Hq, Sq, d, os, dos);
  else
    attn_bwd_prep<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), D,
        rows, Hq, Sq, d, os, dos);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// f(DT) for the wgmma kernels' head-dim tile: 64 or 128 (whole 128-byte
// panels; TMA fills the columns past d with zeros)
template <typename F>
int by_panels(int d, F&& f) {
  if (d <= 64) return f(std::integral_constant<int, 64>());
  if (d <= 128) return f(std::integral_constant<int, 128>());
  return static_cast<int>(cudaErrorInvalidValue);
}

// the four operands' tensor maps, K and V with `kv_rows` a box, Q and dO
// with `q_rows`
int encode_operands(CUtensorMap (&m)[4], const void* q, const void* k,
                    const void* v, const void* dout, int B, int Hq, int Hkv,
                    int Sq, int Sk, int d, const Strides& qs,
                    const Strides& ks, const Strides& vs, const Strides& dos,
                    int q_rows, int kv_rows) {
  int err = hop::encode_bf16_panels(&m[0], q, d, Sq, Hq, B, qs.s, qs.h, qs.b,
                                    q_rows);
  if (!err)
    err = hop::encode_bf16_panels(&m[1], k, d, Sk, Hkv, B, ks.s, ks.h, ks.b,
                                  kv_rows);
  if (!err)
    err = hop::encode_bf16_panels(&m[2], v, d, Sk, Hkv, B, vs.s, vs.h, vs.b,
                                  kv_rows);
  if (!err)
    err = hop::encode_bf16_panels(&m[3], dout, d, Sq, Hq, B, dos.s, dos.h,
                                  dos.b, q_rows);
  return err;
}

// two bf16 columns a store: d even, every stride even, a 4-byte base
bool pair_ok(int d, const void* p, std::initializer_list<Strides> ss) {
  bool ok = d % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 4 == 0;
  for (const Strides& x : ss) ok = ok && x.b % 2 == 0 && x.h % 2 == 0 &&
                                   x.s % 2 == 0;
  return ok;
}

}  // namespace

// dq = scale dS K.  bfloat16 reads q, k, v and dout by TMA: each base and
// each (batch, head, seq) stride a multiple of 16 bytes (ops.py stages a
// copy of an operand that is not); a tensor map that cuTensorMapEncodeTiled
// refuses returns 1000 + its CUresult.
extern "C" int attn_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* D, void* dq, int is_bf16, int B, int Hq,
    int Hkv, int Sq, int Sk, int d, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long dosb, long long dosh,
    long long doss, long long dqsb, long long dqsh, long long dqss,
    float scale, int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      dos{dosb, dosh, doss}, dqs{dqsb, dqsh, dqss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  if (is_bf16) {
    const int pair = pair_ok(d, dq, {dqs});
    return by_panels(d, [&](auto tile) {
      constexpr int DT = decltype(tile)::value;
      CUtensorMap m[4];
      int err = encode_operands(m, q, k, v, dout, B, Hq, Hkv, Sq, Sk, d, qs,
                                ks, vs, dos, kDqBQ, DqTile<DT>::kBK);
      if (err) return err;
      constexpr size_t smem = DqSmem<DT>::bytes;
      err = set_smem(attn_bwd_dq_wgmma<DT>, smem);
      if (err) return err;
      const dim3 grid((Sq + kDqBQ - 1) / kDqBQ, Hq, B);
      attn_bwd_dq_wgmma<DT><<<grid, kBwdThreads, smem, st>>>(
          m[0], m[1], m[2], m[3], lse, D, static_cast<__nv_bfloat16*>(dq),
          Hq, group, Sq, Sk, d, dqs, scale, causal, pair);
      return static_cast<int>(cudaGetLastError());
    });
  }
  return by_tile_bwd(d, [&](auto tile) {
    constexpr int DT = decltype(tile)::value;
    constexpr size_t smem = dq_fma_smem_bytes<DT>();
    int err = set_smem(attn_bwd_dq_fma<DT>, smem);
    if (err) return err;
    const dim3 grid((Sq + kFDqBQ - 1) / kFDqBQ, Hq, B);
    attn_bwd_dq_fma<DT><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        D, static_cast<float*>(dq), group, Sq, Sk, d, qs, ks, vs, dos, dqs,
        scale, causal);
    return static_cast<int>(cudaGetLastError());
  });
}

// dk = scale dS^T Q and dv = P^T dO, each summed over the kv head's group;
// bfloat16 operands as for attn_bwd_dq_launch, and lse and D read by TMA as
// B Hq rows of Sq values row_ld apart (row_ld * 4 a multiple of 16 bytes;
// float32 ignores it: its lse and D are contiguous)
extern "C" int attn_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* D, void* dk, void* dv, int is_bf16, int B,
    int Hq, int Hkv, int Sq, int Sk, int d, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long dosb, long long dosh,
    long long doss, long long dksb, long long dksh, long long dkss,
    long long dvsb, long long dvsh, long long dvss, long long row_ld,
    float scale, int causal, void* stream) {
  if (B <= 0 || Hkv <= 0 || Sk <= 0) return 0;
  if (Hq <= 0 || Hq % Hkv != 0 || Sq <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      dos{dosb, dosh, doss}, dks{dksb, dksh, dkss}, dvs{dvsb, dvsh, dvss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = Hq / Hkv;
  if (is_bf16) {
    CUtensorMap m[4];
    int err = encode_operands(m, q, k, v, dout, B, Hq, Hkv, Sq, Sk, d, qs, ks,
                              vs, dos, kKvBQ, kKvBK);
    if (err) return err;
    CUtensorMap ml, mD;
    const long long rows = static_cast<long long>(B) * Hq;
    err = hop::encode_f32_rows(&ml, lse, Sq, rows, row_ld, kKvBQ);
    if (!err) err = hop::encode_f32_rows(&mD, D, Sq, rows, row_ld, kKvBQ);
    if (err) return err;
    const int pair = pair_ok(d, dk, {dks, dvs}) && pair_ok(d, dv, {});
    return by_panels(d, [&](auto tile) {
      constexpr int DT = decltype(tile)::value;
      constexpr size_t smem = DkdvSmem<DT>::bytes;
      err = set_smem(attn_bwd_dkdv_wgmma<DT>, smem);
      if (err) return err;
      const dim3 grid((Sk + kKvBK - 1) / kKvBK, Hkv, B);
      attn_bwd_dkdv_wgmma<DT><<<grid, kBwdThreads, smem, st>>>(
          m[0], m[1], m[2], m[3], ml, mD, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), Hq, group, Sq, Sk, d, dks, dvs,
          scale, causal, pair);
      return static_cast<int>(cudaGetLastError());
    });
  }
  return by_tile_bwd(d, [&](auto tile) {
    constexpr int DT = decltype(tile)::value;
    constexpr size_t smem = dkdv_fma_smem_bytes<DT>();
    int err = set_smem(attn_bwd_dkdv_fma<DT>, smem);
    if (err) return err;
    const dim3 grid((Sk + kFKvBK - 1) / kFKvBK, Hkv, B);
    attn_bwd_dkdv_fma<DT><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        D, static_cast<float*>(dk), static_cast<float*>(dv), Hq, group, Sq,
        Sk, d, qs, ks, vs, dos, dks, dvs, scale, causal);
    return static_cast<int>(cudaGetLastError());
  });
}

// the compiled backward kernel `which` (0 prep, 1 dkdv, 2 dq) for head dim
// d: registers a thread, local memory a thread (spills), dynamic shared
// memory a launch
extern "C" int attn_bwd_attributes(int is_bf16, int which, int d, int* regs,
                                   int* local_bytes, long long* smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaSuccess;
  size_t bytes = 0;
  const int bad = by_tile_bwd(d, [&](auto tile) {
    constexpr int DT = decltype(tile)::value;
    if (which == 0) {
      err = is_bf16 ? cudaFuncGetAttributes(&attr, attn_bwd_prep<__nv_bfloat16>)
                    : cudaFuncGetAttributes(&attr, attn_bwd_prep<float>);
    } else if (!is_bf16) {
      err = which == 1 ? cudaFuncGetAttributes(&attr, attn_bwd_dkdv_fma<DT>)
                       : cudaFuncGetAttributes(&attr, attn_bwd_dq_fma<DT>);
      bytes = which == 1 ? dkdv_fma_smem_bytes<DT>() : dq_fma_smem_bytes<DT>();
    } else {
      return by_panels(d, [&](auto panels) {
        constexpr int PT = decltype(panels)::value;
        err = which == 1
                  ? cudaFuncGetAttributes(&attr, attn_bwd_dkdv_wgmma<PT>)
                  : cudaFuncGetAttributes(&attr, attn_bwd_dq_wgmma<PT>);
        bytes = which == 1 ? DkdvSmem<PT>::bytes : DqSmem<PT>::bytes;
        return 0;
      });
    }
    return 0;
  });
  if (bad) return bad;
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *smem = static_cast<long long>(bytes);
  return 0;
}
