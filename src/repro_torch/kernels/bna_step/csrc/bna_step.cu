// bna_step: one lock-step iteration of the filled-matrix BNA decomposition
// (paper Algorithm 1) over a (B, w, w) stack of demand matrices, in int32
// or int64 (one template, two C entries).
//
// Replaces the TPU kernel src/repro/kernels/bna_step/bna_step.py
// (_bna_step_kernel, launched by bna_step_padded).  That kernel gathers the
// matched demand with a one-hot broadcast-compare over the whole w x w tile,
// a VPU trick that reads all w^2 entries.  Here the gather is direct.
//
// Design: one block per matrix, at most 1024 threads (a block's limit).  A
// thread holds PER senders s = threadIdx.x + j * blockDim.x, j < PER (and,
// for the receiver-side terms, the receivers of the same indices), PER a
// template argument: the least power of two with w <= 1024 * PER, so any w
// runs and each sender's match, matched entry, row and col sit in registers
// through the step (PER = 1, one sender a thread, up to w = 1024).  Per
// matrix:
//   1. dm = d[b, s, match[s]]: one gathered load per sender;
//      real = match[s] != -1 && dm > 0; receivers of real edges are flagged
//      in shared memory.
//   2. t = min(dm over real senders, D - row over the other senders,
//      D - col over receivers not flagged): a block min reduction.
//   3. Transmit: d is updated IN PLACE, at the matched entries only; row,
//      col and D are updated in place too.
//   4. invalid[s] = match[s] != -1 && dm - t*real == 0 &&
//      (row'[s] >= D' || col'[match[s]] >= D') && D' > 0, with col' read from
//      shared memory at match[s].
// Outputs go into one packed int32 row per matrix, [t | D' | piece | invalid]
// (2 + 2w values), so the host copies one buffer back per step.
//
// Bound on the card: memory, and tiny.  A step moves O(B * w) words (the
// gathered d entries and their write-back, row, col, match, D, the packed
// output), not O(B * w^2); at the planning path's shapes (B <= a few dozen,
// w <= 256) it is launch-bound.  Drained matrices (D = 0, match = -1) come
// out as fixed points with t = 0.  The sentinel is the type's largest value
// (INT32_MAX, as on the TPU, or INT64_MAX, as in the reference's numpy step).
//
// The wrapper stages int32 while max D < 2^31 - 1 and int64 past it, so the
// arithmetic is exact in either instance; every offset is 64-bit, so the
// stack's element count has no limit of its own.  Shared memory holds two
// values of w (the receiver flags and col'); past 48 KB (w > 3072 in int64,
// 6144 in int32) the launch asks for it as dynamic shared memory, and past
// the card's 227 KB a block the launch fails and the wrapper raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNoMatch = -1;
constexpr int kMaxThreads = 1024;  // a block's limit

// the sentinel: the type's largest value
template <typename T> struct Big;
template <> struct Big<int32_t> { static constexpr int32_t value = 2147483647; };
template <> struct Big<int64_t> {
  static constexpr int64_t value = 9223372036854775807LL;
};

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v = tmin(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int PER>
__global__ void bna_step_kernel(T* __restrict__ d, T* __restrict__ row,
                                T* __restrict__ col, T* __restrict__ D,
                                const T* __restrict__ match,
                                T* __restrict__ out, int w) {
  constexpr T kBig = Big<T>::value;
  extern __shared__ __align__(8) unsigned char smem_raw[];
  T* recv = reinterpret_cast<T*>(smem_raw);  // [w]: receiver transmits
  T* col_new = recv + w;                     // [w]: col after the step
  __shared__ T warp_part[32];

  const int b = blockIdx.x;
  const int64_t base = static_cast<int64_t>(b) * w;
  const T Dv = D[b];

  // this thread's senders s = threadIdx.x + j * blockDim.x, j < PER
  T ms[PER], dm[PER], row_s[PER], col_s[PER];
  bool real[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int s = threadIdx.x + j * blockDim.x;
    ms[j] = kNoMatch;
    dm[j] = row_s[j] = col_s[j] = 0;
    if (s < w) {
      ms[j] = match[base + s];
      row_s[j] = row[base + s];
      col_s[j] = col[base + s];
      if (ms[j] != kNoMatch) dm[j] = d[(base + s) * w + ms[j]];
      recv[s] = 0;
    }
    real[j] = ms[j] != kNoMatch && dm[j] > 0;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER; ++j)
    if (real[j]) recv[ms[j]] = 1;
  __syncthreads();

  T local = kBig;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int s = threadIdx.x + j * blockDim.x;
    if (s < w) {
      local = tmin(local, real[j] ? dm[j] : Dv - row_s[j]);
      if (!recv[s]) local = tmin(local, Dv - col_s[j]);
    }
  }
  local = warp_min(local);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = local;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    T v = lane < nwarps ? warp_part[lane] : kBig;
    v = warp_min(v);
    if (lane == 0) warp_part[0] = v;
  }
  __syncthreads();
  const T t = warp_part[0];
  const T Dn = Dv - t;

#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int s = threadIdx.x + j * blockDim.x;
    if (s < w) {
      T coln = col_s[j];
      if (real[j]) {
        d[(base + s) * w + ms[j]] = dm[j] - t;
        row_s[j] -= t;
        row[base + s] = row_s[j];
      }
      if (recv[s]) {
        coln -= t;
        col[base + s] = coln;
      }
      col_new[s] = coln;
    }
  }
  __syncthreads();
  T* o = out + static_cast<int64_t>(b) * (2 + 2 * w);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int s = threadIdx.x + j * blockDim.x;
    if (s < w) {
      const T dmn = real[j] ? dm[j] - t : dm[j];
      int inv = 0;
      if (ms[j] != kNoMatch && dmn == 0 && Dn > 0)
        inv = (row_s[j] >= Dn) || (col_new[ms[j]] >= Dn);
      o[2 + s] = real[j] ? ms[j] : kNoMatch;
      o[2 + w + s] = inv;
    }
  }
  if (threadIdx.x == 0) {
    o[0] = t;
    o[1] = Dn;
    D[b] = Dn;
  }
}

template <typename T, int PER>
int launch_per(T* d, T* row, T* col, T* D, const T* match, T* out, int B,
               int w, cudaStream_t stream) {
  const int threads = ((w + PER - 1) / PER + 31) / 32 * 32;
  const size_t shmem = 2 * static_cast<size_t>(w) * sizeof(T);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bna_step_kernel<T, PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bna_step_kernel<T, PER><<<B, threads, shmem, stream>>>(d, row, col, D,
                                                         match, out, w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(void* d, void* row, void* col, void* D, void* match, void* out,
           int B, int w, void* stream) {
  if (B <= 0) return 0;
  T* const a[] = {static_cast<T*>(d), static_cast<T*>(row),
                  static_cast<T*>(col), static_cast<T*>(D)};
  const T* m = static_cast<const T*>(match);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // senders per thread: the least power of two that keeps the block within
  // 1024 threads (past 32, 2w values exceed a block's shared memory anyway)
  const int need = (w + kMaxThreads - 1) / kMaxThreads;
  if (need <= 1)
    return launch_per<T, 1>(a[0], a[1], a[2], a[3], m, o, B, w, st);
  if (need <= 2)
    return launch_per<T, 2>(a[0], a[1], a[2], a[3], m, o, B, w, st);
  if (need <= 4)
    return launch_per<T, 4>(a[0], a[1], a[2], a[3], m, o, B, w, st);
  if (need <= 8)
    return launch_per<T, 8>(a[0], a[1], a[2], a[3], m, o, B, w, st);
  if (need <= 16)
    return launch_per<T, 16>(a[0], a[1], a[2], a[3], m, o, B, w, st);
  if (need <= 32)
    return launch_per<T, 32>(a[0], a[1], a[2], a[3], m, o, B, w, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

__global__ void empty_kernel() {}

}  // namespace

// An empty kernel of one warp, launched the way bna_step_launch launches:
// what a launch costs on the card, the floor under K1's time.
extern "C" int bna_step_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bna_step_launch(void* d, void* row, void* col, void* D,
                               void* match, void* out, int B, int w,
                               void* stream) {
  return launch<int32_t>(d, row, col, D, match, out, B, w, stream);
}

extern "C" int bna_step_launch_i64(void* d, void* row, void* col, void* D,
                                   void* match, void* out, int B, int w,
                                   void* stream) {
  return launch<int64_t>(d, row, col, D, match, out, B, w, stream);
}
