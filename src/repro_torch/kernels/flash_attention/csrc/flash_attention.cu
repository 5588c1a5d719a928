// flash_attention: blocked online-softmax GQA attention (FlashAttention's
// forward pass) for float32 or bfloat16 inputs, float32 accumulators.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (_attn_kernel, launched by flash_attention_padded).  That kernel walks a
// (batch, q head, q block, k block) grid whose last axis runs in order on one
// core, carrying the running max, denominator and accumulator in VMEM
// scratch from one k block to the next.  Blocks of a CUDA grid run in no
// order, so here the k-tile loop runs inside the block and the running state
// stays in registers.
//
// Design: one block of 128 threads per (q tile of 64 rows, q head, batch).
//   * The q tile is staged once in shared memory as float32; each k tile of
//     32 keys and its v tile are staged in turn.  The staged rows are padded
//     by one float so that the threads of a warp read distinct banks.
//   * Thread (tr, tc) = (tid / 8, tid % 8) owns q rows 4tr..4tr+3: the
//     scores of key columns tc + 8j of the tile, and output columns tc + 8j
//     of the head dim.  A row's running max and denominator are reduced over
//     its 8 threads, which are neighbouring lanes of one warp (shuffles).
//   * GQA: q head h reads kv head h / (Hq / Hkv) through the index; K and V
//     are never repeated in memory.
//   * Masking as the Pallas kernel: scores are scaled, then keys past Sk and,
//     when causal, keys after query i + (Sk - Sq) (the mask aligned to the end
//     of the keys) are set to -1e30.  A causal tile that lies wholly after the
//     tile's last query is skipped: on every row that sees a key (key 0 is in
//     the first tile) such a tile adds exp(-1e30 - m) = 0, so skipping it
//     changes nothing.  The output divides by the denominator, or by 1 where it
//     is 0, as the Pallas kernel does.
//   * q, k, v and the output are read and written through their (batch, head,
//     seq) strides with 64-bit offsets; only the head dim is contiguous.
//   * The head dim is a template tile DT in {16, 32, 64, 128, 256} >= d, the
//     columns past d staged as zeros.  Shared memory is 72.6 KB at DT = 128
//     and 137 KB at DT = 256, taken as dynamic shared memory after
//     cudaFuncSetAttribute.
//
// Bound on the card: operations.  Attention does 4 * B * Hq * Sq * Sk * d
// FLOPs (half of it when causal) on O((Sq + Sk) * d) bytes, far above the
// card's balance point.  This first kernel does them as float32 FMAs from
// shared memory, not on the tensor cores (wgmma or mma.sync), so it runs far
// under the bf16 tensor-core bound; the tensor-core version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // q rows per block
constexpr int kBK = 32;       // keys per k tile
constexpr int kThreads = 128;
constexpr int kRows = 4;      // q rows per thread
constexpr float kNegInf = -1e30f;

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
  long long b, h, s;
};

template <int DT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (DT + 1) + kBK * (DT + 1) + kBK * DT +
                          kBQ * (kBK + 1));
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

template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int group,
                       int Sq, int Sk, int d, Strides qs, Strides ks,
                       Strides vs, Strides os, float scale, int causal) {
  constexpr int LD = DT + 1;           // padded row of the q and k tiles
  constexpr int LDP = kBK + 1;         // padded row of the p tile
  constexpr int SC = kBK / 8;          // score columns per thread
  constexpr int OC = DT / 8;           // output columns per thread
  extern __shared__ float smem[];
  float* qt = smem;                    // [kBQ][LD]
  float* kt = qt + kBQ * LD;           // [kBK][LD]
  float* vt = kt + kBK * LD;           // [kBK][DT]
  float* pt = vt + kBK * DT;           // [kBQ][LDP]

  const int tid = threadIdx.x;
  const int tr = tid >> 3;
  const int tc = tid & 7;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int offset = Sk - Sq;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < kBQ * DT; i += kThreads) {
    const int r = i / DT, c = i % DT;
    float x = 0.f;
    if (q0 + r < Sq && c < d) x = to_f(qb[(q0 + r) * qs.s + c]);
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
    const int last_q = min(q0 + kBQ, Sq) - 1;
    k_end = max(0, min(Sk, last_q + offset + 1));
  }

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int i = tid; i < kBK * DT; i += kThreads) {
      const int r = i / DT, c = i % DT;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Sk && c < d) {
        kx = to_f(kb[(k0 + r) * ks.s + c]);
        vx = to_f(vb[(k0 + r) * vs.s + c]);
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
    for (int kk = 0; kk < kBK; ++kk) {
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

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qpos = q0 + tr * kRows + i;
    if (qpos >= Sq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = tc + 8 * c;
      if (col < d) ob[qpos * os.s + col] = from_f<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int DT>
int launch_tile(const void* q, const void* k, const void* v, void* o, int B,
                int Hq, int Hkv, int Sq, int Sk, int d, Strides qs, Strides ks,
                Strides vs, Strides os, float scale, int causal,
                cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DT>();
  auto kern = flash_attention_kernel<T, DT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq / Hkv, Sq, Sk, d, qs,
      ks, vs, os, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Sk, int d, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal,
           cudaStream_t stream) {
  if (d <= 16)
    return launch_tile<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, d, qs, ks, vs,
                              os, scale, causal, stream);
  if (d <= 32)
    return launch_tile<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, d, qs, ks, vs,
                              os, scale, causal, stream);
  if (d <= 64)
    return launch_tile<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, d, qs, ks, vs,
                              os, scale, causal, stream);
  if (d <= 128)
    return launch_tile<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, d, qs, ks, vs,
                               os, scale, causal, stream);
  if (d <= 256)
    return launch_tile<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, d, qs, ks, vs,
                               os, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, d, qs, ks,
                                 vs, os, scale, causal, st);
  return launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, d, qs, ks, vs, os,
                       scale, causal, st);
}
