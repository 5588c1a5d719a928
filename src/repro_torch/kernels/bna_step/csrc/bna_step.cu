// bna_step: one lock-step iteration of the filled-matrix BNA decomposition
// (paper Algorithm 1) over a (B, w, w) int32 stack of demand matrices.
//
// Replaces the TPU kernel src/repro/kernels/bna_step/bna_step.py
// (_bna_step_kernel, launched by bna_step_padded).  That kernel gathers the
// matched demand with a one-hot broadcast-compare over the whole w x w tile,
// a VPU trick that reads all w^2 entries.  Here the gather is direct.
//
// Design: one block per matrix, one thread per sender row s (and, for the
// receiver-side terms, per receiver s).  Per matrix:
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
// out as fixed points with t = 0.  The sentinel is INT32_MAX, as on the TPU.
//
// All arithmetic is int32 and exact under the wrapper's guard (max D and
// the element count below 2^31 - 1); offsets into d are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNoMatch = -1;
constexpr int32_t kBig = 2147483647;

__device__ __forceinline__ int32_t warp_min(int32_t v) {
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

__global__ void bna_step_kernel(int32_t* __restrict__ d,
                                int32_t* __restrict__ row,
                                int32_t* __restrict__ col,
                                int32_t* __restrict__ D,
                                const int32_t* __restrict__ match,
                                int32_t* __restrict__ out, int w) {
  extern __shared__ int32_t smem[];
  int32_t* recv = smem;          // [w]: receiver transmits this step
  int32_t* col_new = smem + w;   // [w]: col after the step
  __shared__ int32_t warp_part[32];

  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const int64_t base = static_cast<int64_t>(b) * w;
  const int32_t Dv = D[b];

  int32_t ms = kNoMatch, dm = 0, row_s = 0, col_s = 0;
  bool real = false;
  if (s < w) {
    ms = match[base + s];
    row_s = row[base + s];
    col_s = col[base + s];
    if (ms != kNoMatch) dm = d[(base + s) * w + ms];
    real = (ms != kNoMatch) && (dm > 0);
    recv[s] = 0;
  }
  __syncthreads();
  if (real) recv[ms] = 1;
  __syncthreads();

  int32_t local = kBig;
  if (s < w) {
    local = real ? dm : Dv - row_s;
    if (!recv[s]) local = min(local, Dv - col_s);
  }
  local = warp_min(local);
  const int lane = s & 31, warp = s >> 5;
  if (lane == 0) warp_part[warp] = local;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    int32_t v = lane < nwarps ? warp_part[lane] : kBig;
    v = warp_min(v);
    if (lane == 0) warp_part[0] = v;
  }
  __syncthreads();
  const int32_t t = warp_part[0];
  const int32_t Dn = Dv - t;

  int32_t rown = row_s;
  if (s < w) {
    int32_t coln = col_s;
    if (real) {
      d[(base + s) * w + ms] = dm - t;
      rown -= t;
      row[base + s] = rown;
    }
    if (recv[s]) {
      coln -= t;
      col[base + s] = coln;
    }
    col_new[s] = coln;
  }
  __syncthreads();
  int32_t* o = out + static_cast<int64_t>(b) * (2 + 2 * w);
  if (s < w) {
    const int32_t dmn = real ? dm - t : dm;
    int inv = 0;
    if (ms != kNoMatch && dmn == 0 && Dn > 0)
      inv = (rown >= Dn) || (col_new[ms] >= Dn);
    o[2 + s] = real ? ms : kNoMatch;
    o[2 + w + s] = inv;
  }
  if (s == 0) {
    o[0] = t;
    o[1] = Dn;
    D[b] = Dn;
  }
}

}  // namespace

extern "C" int bna_step_launch(void* d, void* row, void* col, void* D,
                               void* match, void* out, int B, int w,
                               void* stream) {
  if (B <= 0) return 0;
  const int threads = ((w + 31) / 32) * 32;
  const size_t shmem = 2 * static_cast<size_t>(w) * sizeof(int32_t);
  bna_step_kernel<<<B, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(d), static_cast<int32_t*>(row),
      static_cast<int32_t*>(col), static_cast<int32_t*>(D),
      static_cast<const int32_t*>(match), static_cast<int32_t*>(out), w);
  return static_cast<int>(cudaGetLastError());
}
