// ssd_scan: the Mamba2 SSD chunked scan (state-space duality) for float32 or
// bfloat16 inputs, float32 arithmetic throughout.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py
// (_ssd_kernel, launched by ssd_scan_padded).  That kernel walks a
// (batch, head, chunk) grid whose chunk axis runs in order on one core,
// carrying the state h (N x P) in VMEM scratch from one chunk to the next.
// Blocks of a CUDA grid run in no order, so here one block per (batch, head)
// loops over the chunks itself and keeps h in shared memory.
//
// Per chunk of length L, with cum the in-chunk prefix sum of log a:
//   intra:  y_i  = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) x_j
//   inter:  y_i += exp(cum_i) (c_i . h)
//   state:  h    = exp(cum_L) h + sum_j exp(cum_L - cum_j) b_j x_j^T
// The state update comes after every row of y has read the old h.
//
// Design: 256 threads a block; everything staged in shared memory as float32.
//   * The chunk's x (L x P) and b (L x N) rows and h (N x P) stay resident;
//     c and the score tile are taken 16 rows at a time, so the largest case
//     (L = N = P = 128) needs 212 KB, under the 227 KB a block may have
//     (dynamic shared memory, after cudaFuncSetAttribute).  mamba2's
//     L = N = 128, P = 64 needs 146 KB.
//   * Rows are padded so that the float4 reads of a warp hit distinct banks:
//     b and c rows hold N rounded up to 8, plus 4 (a row stride of 16 bytes
//     mod 128); x and h rows hold P rounded up to 4.  The padding is zero, so
//     the contractions run over whole float4s.
//   * The scores exp(cum_i - cum_j) are computed only for i >= j (for i < j
//     the exponent is positive and may overflow; the Pallas kernel zeroes it
//     with where); elsewhere the tile holds 0.  A row tile reads only the
//     score columns j <= its last row.
//   * b and c are read for the head's state group h / (H / G), as the
//     BlockSpec index maps do.  x, b and c are read through their (batch,
//     seq, head or group) strides with 64-bit offsets; loga (B, S, H) and y
//     (B, S, H, P) are dense.  S is a multiple of L (the wrapper pads with
//     a = 1 and zero x, b, c, so padded steps pass the state through).
//
// Bound on the card: at mamba2's shapes the bytes (x and y once, b, c, loga)
// and the operations (about 10.5 MFLOP per (batch, head, chunk) at L = N =
// 128, P = 64) come to about 50 us each at the bf16 tensor-core peak.  This
// first kernel does its products as float32 FMAs from shared memory, one
// block per (batch, head) with its chunks in sequence (B*H blocks, S/L
// dependent steps each), so it runs far above that bound; splitting the
// chunks across blocks (intra-chunk terms in parallel, then a scan over the
// chunk states) and the tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 16;        // rows of y (and of c and the scores) per tile
constexpr int kNB = 8;        // state rows per thread in the state update

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, s, h;   // batch, seq, head (x) or state group (b, c)
};

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// Shared-memory layout, in floats: x [L4][PP], b [L4][NS], h [NP][PP],
// c [kR][NS], scores [kR][L4], then cum, exp(cum) and exp(cum_L - cum),
// [L4] each.  Every array starts 16-byte aligned.
struct Layout {
  int NP, NS, PP, L4;
  __host__ __device__ Layout(int L, int N, int P)
      : NP(round_up(N, kNB)), NS(round_up(N, kNB) + 4), PP(round_up(P, 4)),
        L4(round_up(L, 4)) {}
  __host__ __device__ size_t floats() const {
    return static_cast<size_t>(L4) * PP + static_cast<size_t>(L4) * NS +
           static_cast<size_t>(NP) * PP + kR * NS + kR * L4 + 3 * L4;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ loga,
                const T* __restrict__ bm, const T* __restrict__ cm,
                T* __restrict__ y, int S, int H, int rep, int P, int N, int L,
                Strides xs, Strides bs, Strides cs) {
  extern __shared__ float4 smem4[];
  const Layout lay(L, N, P);
  const int NP = lay.NP, NS = lay.NS, PP = lay.PP, L4 = lay.L4;
  float* xt = reinterpret_cast<float*>(smem4);   // [L4][PP]
  float* bt = xt + L4 * PP;                      // [L4][NS]
  float* ht = bt + L4 * NS;                      // [NP][PP]
  float* ct = ht + NP * PP;                      // [kR][NS]
  float* st = ct + kR * NS;                      // [kR][L4]
  float* cum = st + kR * L4;                     // [L4]
  float* ecum = cum + L4;                        // exp(cum)
  float* wdec = ecum + L4;                       // exp(cum_L - cum)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int bb = bh / H;
  const int hh = bh % H;
  const int g = hh / rep;
  const int Q = PP / 4;                          // float4 columns of x, h, y

  const T* xb = x + bb * xs.b + hh * xs.h;
  const T* bg = bm + bb * bs.b + g * bs.h;
  const T* cg = cm + bb * cs.b + g * cs.h;
  const float* lb = loga + static_cast<long long>(bb) * S * H + hh;
  T* yb = y + (static_cast<long long>(bb) * S * H + hh) * P;
  const long long ys = static_cast<long long>(H) * P;   // y's seq stride

  for (int i = tid; i < NP * PP; i += kThreads) ht[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();  // the previous chunk's x, b and h readers are done

    // stage the chunk: x and b rows, zero past L and in the padding
    for (int i = tid; i < L4 * PP; i += kThreads) {
      const int j = i / PP, p = i % PP;
      xt[i] = (j < L && p < P) ? to_f(xb[(c0 + j) * xs.s + p]) : 0.f;
    }
    for (int i = tid; i < L4 * NS; i += kThreads) {
      const int j = i / NS, n = i % NS;
      bt[i] = (j < L && n < N) ? to_f(bg[(c0 + j) * bs.s + n]) : 0.f;
    }
    // cum: warp 0 scans log a, four steps a lane (L4 <= 128)
    if (tid < 32) {
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * lane + t;
        run += (j < L) ? lb[static_cast<long long>(c0 + j) * H] : 0.f;
        v[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float excl = incl - run;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * lane + t;
        if (j < L4) cum[j] = excl + v[t];
      }
      __syncwarp();
      const float cL = cum[L - 1];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 4 * lane + t;
        if (j < L4) {
          ecum[j] = expf(cum[j]);
          wdec[j] = expf(cL - cum[j]);
        }
      }
    }
    __syncthreads();

    for (int i0 = 0; i0 < L; i0 += kR) {
      // c rows i0 .. i0 + kR - 1
      for (int i = tid; i < kR * NS; i += kThreads) {
        const int r = i / NS, n = i % NS;
        const int row = i0 + r;
        ct[i] = (row < L && n < N) ? to_f(cg[(c0 + row) * cs.s + n]) : 0.f;
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
        const float out[4] = {fmaf(ei, inter.x, acc.x),
                              fmaf(ei, inter.y, acc.y),
                              fmaf(ei, inter.z, acc.z),
                              fmaf(ei, inter.w, acc.w)};
        T* yr = yb + (c0 + i) * ys;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (4 * q + t < P) yr[4 * q + t] = from_f<T>(out[t]);
      }
      __syncthreads();  // c and the scores are reused by the next row tile
    }

    // state: h = exp(cum_L) h + sum_j exp(cum_L - cum_j) b_j x_j^T; a thread
    // takes kNB state rows and four columns
    const float decay = ecum[L - 1];
    for (int e = tid; e < (NP / kNB) * Q; e += kThreads) {
      const int n0 = (e / Q) * kNB, q = e % Q;
      float4 acc[kNB];
#pragma unroll
      for (int k = 0; k < kNB; ++k) {
        const float4 hv = ld4(ht + (n0 + k) * PP + 4 * q);
        acc[k] = make_float4(decay * hv.x, decay * hv.y, decay * hv.z,
                             decay * hv.w);
      }
      for (int j = 0; j < L; ++j) {
        float4 xv = ld4(xt + j * PP + 4 * q);
        const float w = wdec[j];
        xv = make_float4(w * xv.x, w * xv.y, w * xv.z, w * xv.w);
        const float4 b0 = ld4(bt + j * NS + n0);
        const float4 b1 = ld4(bt + j * NS + n0 + 4);
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
      for (int k = 0; k < kNB; ++k)
        *reinterpret_cast<float4*>(ht + (n0 + k) * PP + 4 * q) = acc[k];
    }
  }
}

template <typename T>
int launch(const void* x, const float* loga, const void* b, const void* c,
           void* y, int B, int S, int H, int G, int P, int N, int L,
           Strides xs, Strides bs, Strides cs, cudaStream_t stream) {
  const size_t smem = Layout(L, N, P).floats() * sizeof(float);
  auto kern = ssd_scan_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), loga, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), S, H, H / G, P, N, L, xs,
      bs, cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, b, c, y: device pointers; is_bf16 selects bfloat16 (else float32) for
// x, b, c and y; loga is float32 (B, S, H), y dense (B, S, H, P); S a
// multiple of L; strides in elements, (batch, seq, head) for x and
// (batch, seq, group) for b and c.
extern "C" int ssd_scan_launch(const void* x, const void* loga, const void* b,
                               const void* c, void* y, int is_bf16, int B,
                               int S, int H, int G, int P, int N, int L,
                               long long xsb, long long xss, long long xsh,
                               long long bsb, long long bss, long long bsh,
                               long long csb, long long css, long long csh,
                               void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || P <= 0) return 0;
  if (G <= 0 || H % G != 0 || N <= 0 || L <= 0 || L > 128 || N > 128 ||
      P > 128 || S % L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides xs{xsb, xss, xsh}, bs{bsb, bss, bsh}, cs{csb, css, csh};
  const float* la = static_cast<const float*>(loga);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, la, b, c, y, B, S, H, G, P, N, L, xs, bs,
                                 cs, st);
  return launch<float>(x, la, b, c, y, B, S, H, G, P, N, L, xs, bs, cs, st);
}
