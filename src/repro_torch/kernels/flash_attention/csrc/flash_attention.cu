// flash_attention: blocked online-softmax GQA attention (FlashAttention's
// forward pass) for bfloat16 inputs on the tensor cores, and for float32
// inputs as float32 FMAs; float32 accumulators in both.
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
// FLOPs (half of it when causal) on O((Sq + Sk) * d) bytes, far above the
// card's balance point, so the products must run on the tensor cores.
//
// bfloat16 (the serving path): mma.sync.m16n8k16 with ldmatrix, FlashAttention
// 2's register dataflow.  Not wgmma: wgmma reads its B operand (and here A)
// from shared memory through swizzled-layout descriptors and wants a
// producer warp feeding a TMA ring; that is the next step (a warp-specialised
// ping-pong), and mma.sync already puts both products on the tensor cores.
//   * One block of 4 warps per (q tile, q head, batch); a warp owns MT
//     16-row m tiles of q (MT = 2, a 128-row tile, for head dims up to 128,
//     so that every K and V fragment read from shared memory feeds two
//     products; MT = 1 at 256, where the accumulator is 128 floats a thread).
//   * K and V tiles of 32 keys come through a ring of two shared-memory
//     stages filled with cp.async (16 bytes a thread, zero-filled past Sk and
//     past d), the next tile's copy in flight while this one is multiplied.
//     The q tile is copied once, with the first K and V tile.  Rows are
//     padded by 16 bytes, so the eight rows of an ldmatrix hit distinct banks.
//   * S = Q K^T: A fragments of Q and B fragments of K by ldmatrix, bf16
//     products into float32 accumulators.
//   * The online softmax runs on the S accumulators in registers, in base 2
//     (scores scaled by scale * log2 e, exp2): a thread holds two rows of
//     each m tile, and a row's max reduces across the quad of threads that
//     holds it (two shuffles).  The denominator is kept per thread and
//     reduced across the quad once, at the end.
//   * O += P V: the S accumulators, rounded to bf16 in registers, are the A
//     fragments of the second product as they lie (FlashAttention 2's
//     layout identity); V's B fragments come by ldmatrix.trans.
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
// What both paths keep from the Pallas kernel:
//   * GQA: q head h reads kv head h / (Hq / Hkv) through the index; K and V
//     are never repeated in memory.
//   * Scores are scaled, then keys past Sk and, when causal, keys after query
//     i + (Sk - Sq) (the mask aligned to the end of the keys) are set to
//     -1e30.  A causal tile that lies wholly after the block's last query is
//     skipped: on every row that sees a key (key 0 is in the first tile)
//     such a tile adds exp(-1e30 - m) = 0.  The output divides by the
//     denominator, or by 1 where it is 0.
//   * q, k, v and the output are read and written through their (batch, head,
//     seq) strides with 64-bit offsets; only the head dim is contiguous.
//   * The head dim is a template tile DT in {16, 32, 64, 128, 256} >= d (a
//     multiple of 16), the columns past d zero.  Dynamic shared memory, set
//     by cudaFuncSetAttribute: bf16 68 KB at DT = 128, 99 KB at 256; float32
//     72.6 KB at 128, 137 KB at 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

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
                    __nv_bfloat16* __restrict__ o, int group, int Sq, int Sk,
                    int d, Strides qs, Strides ks, Strides vs, Strides os,
                    float scale_log2, int causal, int vec) {
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
      den = den == 0.f ? 1.f : den;
      const int qpos = q0 + row0(mt) + g + 8 * r;
      if (qpos >= Sq) continue;
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
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int Sq, int Sk, int d, Strides qs, Strides ks,
               Strides vs, Strides os, float scale, int causal, int vec,
               cudaStream_t stream) {
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
      Hq / Hkv, Sq, Sk, d, qs, ks, vs, os, scale * kLog2e, causal, vec);
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
                    int group, int Sq, int Sk, int d, Strides qs, Strides ks,
                    Strides vs, Strides os, float scale, int causal) {
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
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = tc + 8 * c;
      if (col < d) ob[qpos * os.s + col] = acc[i][c] / den;
    }
  }
}

template <int DT>
int launch_fma(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int Sq, int Sk, int d, Strides qs, Strides ks,
               Strides vs, Strides os, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<DT>();
  auto kern = flash_attention_fma<DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kFBQ - 1) / kFBQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq / Hkv, Sq, Sk,
      d, qs, ks, vs, os, scale, causal);
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

}  // namespace

// q, k, v, o: device pointers; is_bf16 selects bfloat16 (else float32);
// strides in elements, (batch, head, seq) for each of q, k, v, o.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int Hq, int Hkv, int Sq, int Sk, int d, long long qsb, long long qsh,
    long long qss, long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh, long long oss,
    float scale, int causal, void* stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Sk <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // cp.async moves 16 bytes (8 bf16) from 16-byte aligned addresses
  const long long strides[] = {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss};
  bool vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (long long s : strides) vec = vec && s % 8 == 0;
  return by_tile(d, [&](auto tile) {
    constexpr int DT = decltype(tile)::value;
    return is_bf16 ? launch_mma<DT>(q, k, v, o, B, Hq, Hkv, Sq, Sk, d, qs, ks,
                                    vs, os, scale, causal, vec, st)
                   : launch_fma<DT>(q, k, v, o, B, Hq, Hkv, Sq, Sk, d, qs, ks,
                                    vs, os, scale, causal, st);
  });
}

// the compiled kernel that a launch for head dim d runs: its registers a
// thread, its local memory a thread (spills), and the dynamic shared memory
// the launch requests
extern "C" int flash_attention_attributes(int is_bf16, int d, int* regs,
                                          int* local_bytes, long long* smem) {
  return by_tile(d, [&](auto tile) {
    constexpr int DT = decltype(tile)::value;
    cudaFuncAttributes attr;
    const cudaError_t err =
        is_bf16 ? cudaFuncGetAttributes(&attr, flash_attention_mma<DT>)
                : cudaFuncGetAttributes(&attr, flash_attention_fma<DT>);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *smem = is_bf16 ? mma_smem_bytes<DT>() : fma_smem_bytes<DT>();
    return 0;
  });
}
