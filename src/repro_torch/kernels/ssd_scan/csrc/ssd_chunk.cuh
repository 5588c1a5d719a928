// ssd_chunk.cuh: what the ssd_scan library's sources share: the (batch,
// seq, head or group) strides and the dimensions the wrappers pass, and the
// in-chunk prefix sums of log a that every kernel of the forward and of the
// backward starts from.
#pragma once

namespace {

struct Strides {
  long long b, s, h;   // batch, seq, head (x) or state group (b, c)
};

struct Dims {
  int S, H, rep, P, N, L, nC;
};

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// cum[0 .. 128) = prefix sums of log a over the chunk's L steps (held flat
// past L): one warp, four steps a lane
__device__ __forceinline__ void chunk_cum(float* cum, const float* lb, int H,
                                          int L, int lane) {
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = 4 * lane + t;
    run += (j < L) ? lb[static_cast<long long>(j) * H] : 0.f;
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
  for (int t = 0; t < 4; ++t) cum[4 * lane + t] = excl + v[t];
}

}  // namespace
