// ssd_scan_bwd_mma: K5's backward for bfloat16 inputs on the tensor cores,
// a third source of the ssd_scan library (ssd_scan_bwd.cu's entry points
// dispatch bf16 here; float32 keeps its FMA kernels there).  It computes
// what ssd_scan_bwd.cu's note writes out (the G_c, the gradients of the
// states leaving the chunks; dx, da, db, dc) in five kernels, numbered 5-9
// by ssd_bwd_kernel_name:
//
//   5. state   one block a (head, batch), a warp 16 rows of the N x P
//              state: it walks the chunks from the last with G in its
//              accumulators, G_(c-1) = e^tot_c G_c + sum_i e^cum_i c_i
//              dy_i^T, so U_c never goes to device memory (the FMA route
//              writes it and reads it back in a second pass).  c and dy
//              come by cp.async, two chunks in flight.  Each G_c leaves
//              rounded to TF32, as the forward's pass rounds its states: the
//              chunk kernels' products take both as they lie.
//   6-8. dx, db, dc   one kernel a role, a block a (slice of kHeads heads of
//              one state group, chunk, batch) walking its heads in order
//              with the next head's x, dy and G or h in flight by cp.async
//              (two stages; one where the shapes leave no room).  The
//              group's B and C stay in shared memory.  A warp owns 16 rows
//              of the chunk:
//                6  dx = (C B^T o E)^T dY + diag(e^(tot-cum)) B G, and the
//                   terms of dla it sees (Q's row and column sums, x_j . its
//                   inter-chunk dx, e^tot <h, G>), their prefix sums to da
//                7  db = (dY X^T o E)^T C + diag(e^(tot-cum)) X G^T, summed
//                   over the slice's heads in the accumulators
//                8  dc = (dY X^T o E) B + diag(e^cum) dY h^T, likewise, and
//                   the suffix sums of e^cum_i c_i . (h dy_i), dla's last
//                   term, to a (B, S, H) scratch
//              One kernel for the three spilled: db's and dc's accumulators
//              stay live across the heads, which left dx's work no room.
//   9. finish  db, dc = the slices' partials summed in slice order; da =
//              (the two dla parts) / a above the floor, 0 at and under it.
//
// The products, all mma.sync with float32 accumulators:
//   * C B^T (as its transpose B C^T for dx) and dY X^T (as X dY^T for dx and
//     db) have bf16 operands straight from shared memory: m16n8k16 bf16 with
//     ldmatrix fragments, exact products.  A warp computes only the 32-column
//     score tiles that reach its rows' side of the diagonal.
//   * Every product with an operand the kernels made is TF32 (m16n8k8): the
//     decayed triangles times dY, C and B; (e^(tot-cum) b) G; (e^(tot-cum)
//     x) G^T; (e^cum dy) h^T; (e^cum c)^T dy in kernel 5.  The bf16
//     operands are exact in TF32; G and h come rounded; the scaled rows are
//     rounded once as their fragments are built.  The decayed scores leave
//     the bf16 product as C fragments and enter the TF32 product as A
//     fragments as they lie, through the forward's key permutation (k = t
//     <-> key 2t, k = t + 4 <-> key 2t + 1); ldmatrix.trans then hands each
//     thread keys 2t and 2t + 1 of the other operand's column, four n8 tiles
//     an instruction, and ldmatrix reads G and h ([n][k], float32) two n8
//     tiles an instruction.
//   * The decay of a score tile that lies wholly off the diagonal is a
//     product of two factors <= 1, one a column's from a per-head table, one
//     a row's (decay_t, decay_n): two exponentials a thread, not sixteen.
//   * dla from the fragments: Q's row sums by shuffles within each quad, its
//     column sums by shuffles across the quads and then across the row tiles
//     in order through shared memory; the prefix and suffix sums over the
//     chunk as warp scans.  No loop over L runs on one thread.
// mma.sync and not wgmma: a warp's rows own a ragged triangle whose decayed
// scores stay in its registers from one product to the next (the forward
// chose the same, ssd_scan.cu), and db's and dc's walk over heads keeps them
// in the accumulators, which a warpgroup-wide wgmma tile would not leave room
// for beside the scores.
//
// Determinism: no atomics; the state walk runs in chunk order, a slice's
// heads in head order, the slices in slice order, every reduction as a fixed
// shuffle tree or in a fixed order of warps.  Two runs give the same bits.
//
// Shapes: L, N, P <= 128 (N and P padded with zeros to 128 and 64 or 128 in
// shared memory, L to 16 or 32); any G dividing H, S a multiple of L; x, b
// and c through their strides.  The loads are cp.async (16 bytes) where every
// row is 16-byte aligned and N, P are multiples of 8, else element by element
// into the same tiles: no copy on the host.  Every kernel here fits 255
// registers with no local memory (tests/test_torch_cuda.py reads them).
//
// Bound on the card at mamba2-2.7b's training shape (B = 4, S = 4096, H =
// 80, G = 1, N = 128, P = 64, L = 128): bytes for both wrappers
// (chip_smoke.py's ssd_bwd_bounds).  The role kernels each read x, dy and G
// or h and write dx or the partials: 10 slices of db and dc, (B, S, 10, N)
// float32, 84 MB each, against 671 MB each for the FMA route's per-head
// partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../flash_attention/csrc/tensor_core.cuh"
#include "ssd_chunk.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxL = 128;
constexpr int kHeads = 8;            // heads a chunk block walks
constexpr int kNT = kMaxL / 8;       // n8 tiles of db, dc (N padded to 128)
constexpr int kHv = 4;               // float4 of h a thread has in flight
constexpr size_t kSmemMax = 232448;  // shared memory a block may request
constexpr float kFloor = 1e-37f;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// the low and the high bf16 of a register, as float32 (TF32-exact) bits
__device__ __forceinline__ uint32_t lo_bits(uint32_t r) { return r << 16; }
__device__ __forceinline__ uint32_t hi_bits(uint32_t r) {
  return r & 0xffff0000u;
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the A fragment (TF32) of rows r0 + g and r0 + g + 8, scaled by s0 and s1,
// at k = k0 + t and k0 + t + 4, from a bf16 tile with row stride ld
__device__ __forceinline__ void scaled_a(uint32_t (&a)[4], const bf16* tile,
                                         int ld, int r0, int k0, float s0,
                                         float s1, int g, int t) {
  const bf16* p0 = tile + (r0 + g) * ld + k0 + t;
  const bf16* p1 = p0 + 8 * ld;
  a[0] = tc::to_tf32(s0 * bf(p0[0]));
  a[1] = tc::to_tf32(s1 * bf(p1[0]));
  a[2] = tc::to_tf32(s0 * bf(p0[4]));
  a[3] = tc::to_tf32(s1 * bf(p1[4]));
}

// s = rows r0 .. r0 + 15 of A times rows c0 .. c0 + 31 of Bm, transposed
// (the score tile of 32 columns, s[q] the n8 tile of columns c0 + 8q ..):
// both bf16 [row][k] with row strides lda and ldb, k < K
template <int K>
__device__ __forceinline__ void scores(float (&s)[4][4], const bf16* A,
                                       int lda, int r0, const bf16* Bm,
                                       int ldb, int c0, int lane) {
  zero(s);
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    tc::ldmatrix_x4(a, A + (r0 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      tc::ldmatrix_x4(b, Bm + (c0 + np * 16 + (lane >> 4) * 8 + (lane & 7)) *
                                  ldb + k0 + ((lane >> 3) & 1) * 8);
      tc::mma_bf16(s[2 * np], a, b[0], b[1]);
      tc::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// e^(cum_i - cum_j) where j <= i < L, else 0: the decay of the pair
__device__ __forceinline__ float decay(const float* cum, int i, int j, int L) {
  return (j <= i && i < L) ? __expf(cum[i] - cum[j]) : 0.f;
}

// s o E^T on a transposed score tile: rows j = r0 + g (+ 8), columns i = ib
// + 8q + 2t (+ 1); pairs i >= j, i < L kept.  Where every column comes after
// every row, E = U_i e^(cum_ib - cum_j) with U_i = e^(cum_i - cum_ib) (the
// head's, per 32-step block), two exponentials a thread, both factors <= 1
// (cum does not rise); the padded columns have zero scores.  On the
// diagonal block each pair's own exponential.
__device__ __forceinline__ void decay_t(float (&s)[4][4], const float* cum,
                                        const float* U, int r0, int ib, int L,
                                        int g, int t) {
  if (ib > r0) {
    const float v0 = __expf(cum[ib] - cum[r0 + g]);
    const float v1 = __expf(cum[ib] - cum[r0 + g + 8]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float u0 = U[ib + q * 8 + 2 * t], u1 = U[ib + q * 8 + 2 * t + 1];
      s[q][0] *= u0 * v0;
      s[q][1] *= u1 * v0;
      s[q][2] *= u0 * v1;
      s[q][3] *= u1 * v1;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[q][e] *= decay(cum, ib + q * 8 + 2 * t + (e & 1),
                         r0 + g + (e >> 1) * 8, L);
  }
}

// s o E on a score tile: rows i = r0 + g (+ 8), columns j = jb + 8q + 2t
// (+ 1); pairs j <= i < L kept.  Where every column comes before every row,
// E = e^(cum_i - cum_(jb+31)) W_j with W_j = e^(cum_(jb+31) - cum_j) (the
// head's, per 32-step block), as decay_t.
__device__ __forceinline__ void decay_n(float (&s)[4][4], const float* cum,
                                        const float* W, int r0, int jb, int L,
                                        int g, int t) {
  if (jb + 32 <= r0) {
    const float u0 = __expf(cum[r0 + g] - cum[jb + 31]);
    const float u1 = __expf(cum[r0 + g + 8] - cum[jb + 31]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float w0 = W[jb + q * 8 + 2 * t], w1 = W[jb + q * 8 + 2 * t + 1];
      s[q][0] *= u0 * w0;
      s[q][1] *= u0 * w1;
      s[q][2] *= u1 * w0;
      s[q][3] *= u1 * w1;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[q][e] *= decay(cum, r0 + g + (e >> 1) * 8,
                         jb + q * 8 + 2 * t + (e & 1), L);
  }
}

// acc[nt] += m Bm[c0 .. c0 + 31][nt * 8 ..]: m a 16 x 32 score tile as C
// fragments, Bm bf16 [row][col] with stride ld; TF32, the score accumulators
// as A fragments through the key permutation (k = t <-> key 2t, k = t + 4
// <-> key 2t + 1), Bm's fragments by ldmatrix.trans (a thread gets keys 2t
// and 2t + 1 of column g, four n8 tiles an instruction)
template <int NT>
__device__ __forceinline__ void tri_product(float (&acc)[NT][4],
                                            const float (&m)[4][4],
                                            const bf16* Bm, int ld, int c0,
                                            int lane) {
  static_assert(NT % 4 == 0, "four n8 tiles a load");
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t a[4] = {tc::to_tf32(m[q][0]), tc::to_tf32(m[q][2]),
                           tc::to_tf32(m[q][1]), tc::to_tf32(m[q][3])};
    const bf16* row = Bm + (c0 + q * 8 + (lane & 7)) * ld + (lane >> 3) * 8;
#pragma unroll
    for (int n4 = 0; n4 < NT / 4; ++n4) {
      uint32_t r[4];
      tc::ldmatrix_x4_trans(r, row + n4 * 32);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tc::mma_tf32(acc[4 * n4 + j], a, lo_bits(r[j]), hi_bits(r[j]));
    }
  }
}

// acc[nt] += a F[nt * 8 ..][k0 .. k0 + 7]^T: F float32 [n][k] (row stride
// ld, 4 mod 32 floats), its fragments by ldmatrix (a 32-bit element a
// thread, two n8 tiles an instruction)
template <int NT>
__device__ __forceinline__ void product_nk(float (&acc)[NT][4],
                                           const uint32_t (&a)[4],
                                           const float* F, int ld, int k0,
                                           int lane) {
  static_assert(NT % 2 == 0, "two n8 tiles a load");
  const float* row = F + ((lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                     ((lane >> 3) & 1) * 4;
#pragma unroll
  for (int n2 = 0; n2 < NT / 2; ++n2) {
    uint32_t r[4];
    tc::ldmatrix_x4(r, row + n2 * 16 * ld);
    tc::mma_tf32(acc[2 * n2], a, r[0], r[1]);
    tc::mma_tf32(acc[2 * n2 + 1], a, r[2], r[3]);
  }
}

__device__ __forceinline__ void put(float* p, float v0, float v1, bool pair,
                                    bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (second) p[1] = v1;
  }
}

__device__ __forceinline__ void put(bf16* p, float v0, float v1, bool pair,
                                    bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
    if (second) p[1] = __float2bfloat16(v1);
  }
}

// rows r0 + g and r0 + g + 8 (< R) and columns nt * 8 + 2t, + 1 (< C) of a
// warp's accumulator tile to dst (row stride ld); a pair at a time where C
// is even (dst's rows then start at even elements)
template <int NT, typename T>
__device__ __forceinline__ void store_acc(const float (&acc)[NT][4], T* dst,
                                          long long ld, int r0, int R, int C,
                                          int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= R) continue;
    T* dr = dst + row * ld;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (col < C)
        put(dr + col, acc[nt][2 * h], acc[nt][2 * h + 1], C % 2 == 0,
            col + 1 < C);
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 5: the state gradients, one block a (head, batch)
// ---------------------------------------------------------------------------

// A stage: c [L16][CS] and dy [L16][YS] (bf16, N and P padded with zeros to
// 128 and PW); then e^cum [2][128] and the chunks' decay [2].  CS, YS = 8
// mod 64 elements: ldmatrix rows 16 bytes apart mod 128.
template <int PW>
struct StateMmaLayout {
  static constexpr int CS = kMaxL + 8, YS = PW + 8;
  int L16;
  __host__ __device__ explicit StateMmaLayout(const Dims& d)
      : L16(round_up(d.L, 16)) {}
  __host__ __device__ size_t stage() const {
    return 2 * static_cast<size_t>(L16) * (CS + YS);
  }
  __host__ __device__ size_t bytes() const {
    return 2 * stage() + (2 * kMaxL + 4) * 4;
  }
};

// PTM: n8 tiles of the state a warp holds (8 for P <= 64, else 16).  The
// product's k (the chunk step i) is permuted within each 8 as the chunk
// kernels' (k = t <-> i = 2t, k = t + 4 <-> i = 2t + 1), so that
// ldmatrix.trans gives both operands' fragments: a thread gets steps 2t and
// 2t + 1 of a column of c (the A operand, state row n) and of dy.
template <int PTM>
__global__ void __launch_bounds__(kThreads, PTM == 8 ? 2 : 1)
ssd_bwd_state_mma(const bf16* __restrict__ cm, const bf16* __restrict__ dy,
                  const float* __restrict__ loga,
                  const float* __restrict__ decay_in,
                  float* __restrict__ grads, Dims dm, Strides cs, int vec) {
  constexpr int PW = PTM * 8;
  using Lay = StateMmaLayout<PW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Lay lay(dm);
  float* ecum_all = reinterpret_cast<float*>(smem_raw + 2 * lay.stage());
  float* dec = ecum_all + 2 * kMaxL;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int grp = hh / dm.rep;
  const int n0 = 16 * warp;                 // this warp's state rows
  const bool active = n0 < dm.N;
  const long long hp = static_cast<long long>(dm.H) * dm.P;
  const long long np = static_cast<long long>(dm.N) * dm.P;

  auto ctile = [&](int s) {
    return reinterpret_cast<bf16*>(smem_raw + s * lay.stage());
  };
  auto ytile = [&](int s) { return ctile(s) + lay.L16 * Lay::CS; };
  // chunk ci's c and dy into stage s (one cp.async group), and its e^cum
  // and decay (warp 0)
  auto load = [&](int ci, int s) {
    const int c0 = ci * dm.L;
    const long long row0 = static_cast<long long>(bb) * dm.S + c0;
    tc::stage<kThreads>(ctile(s), Lay::CS, cm + bb * cs.b + grp * cs.h +
                        c0 * cs.s, cs.s, dm.L, dm.N, lay.L16, kMaxL, vec,
                        tid);
    tc::stage<kThreads>(ytile(s), Lay::YS, dy + row0 * hp +
                        static_cast<long long>(hh) * dm.P, hp, dm.L, dm.P,
                        lay.L16, PW, vec, tid);
    tc::cp_async_commit();
    if (warp == 0) {
      float* ec = ecum_all + s * kMaxL;
      chunk_cum(ec, loga + row0 * dm.H + hh, dm.H, dm.L, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) ec[4 * lane + r] = expf(ec[4 * lane + r]);
      if (lane == 0)
        dec[s] = decay_in[(static_cast<long long>(bb) * dm.nC + ci) * dm.H +
                          hh];
    }
  };

  float acc[PTM][4];                        // G of the chunk being left
  zero(acc);
  load(dm.nC - 1, 0);
  if (dm.nC > 1) load(dm.nC - 2, 1);
  for (int k = 0; k < dm.nC; ++k) {
    const int ci = dm.nC - 1 - k, s = k & 1;
    if (k + 1 < dm.nC) tc::cp_async_wait<1>();
    else tc::cp_async_wait<0>();
    __syncthreads();
    if (active) {
      // G_ci, the gradient of the state leaving chunk ci, rounded to TF32
      float out[PTM][4];
#pragma unroll
      for (int pt = 0; pt < PTM; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[pt][e] = __uint_as_float(tc::to_tf32(acc[pt][e]));
      store_acc(out, grads + ((static_cast<long long>(bb) * dm.nC + ci) *
                              dm.H + hh) * np, dm.P, n0, dm.N, dm.P, g, t);
      // G_(ci-1) = e^tot G_ci + sum_i e^cum_i c_i dy_i^T: A[n][i] = e^cum_i
      // c_i[n] (TF32), B[i][p] = dy_i[p]; 16 steps i a pass
      const float ed = expf(dec[s]);
#pragma unroll
      for (int pt = 0; pt < PTM; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pt][e] *= ed;
      const bf16* crow = ctile(s) + ((lane & 7) + ((lane >> 4) << 3)) *
                                        Lay::CS + n0 + ((lane >> 3) & 1) * 8;
      const bf16* yrow = ytile(s) + ((lane & 7) + ((lane >> 4) << 3)) *
                                        Lay::YS + ((lane >> 3) & 1) * 8;
      const float* ec = ecum_all + s * kMaxL;
      for (int k0 = 0; k0 < lay.L16; k0 += 16) {
        uint32_t cr[4];
        tc::ldmatrix_x4_trans(cr, crow + k0 * Lay::CS);
        uint32_t a[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {       // steps k0 + 8h .. k0 + 8h + 7
          const float e0 = ec[k0 + 8 * h + 2 * t];
          const float e1 = ec[k0 + 8 * h + 2 * t + 1];
          a[h][0] = tc::to_tf32(e0 * __uint_as_float(lo_bits(cr[2 * h])));
          a[h][1] = tc::to_tf32(e0 * __uint_as_float(lo_bits(cr[2 * h + 1])));
          a[h][2] = tc::to_tf32(e1 * __uint_as_float(hi_bits(cr[2 * h])));
          a[h][3] = tc::to_tf32(e1 * __uint_as_float(hi_bits(cr[2 * h + 1])));
        }
#pragma unroll
        for (int p2 = 0; p2 < PTM / 2; ++p2) {
          uint32_t yr[4];
          tc::ldmatrix_x4_trans(yr, yrow + k0 * Lay::YS + p2 * 16);
          tc::mma_tf32(acc[2 * p2], a[0], lo_bits(yr[0]), hi_bits(yr[0]));
          tc::mma_tf32(acc[2 * p2 + 1], a[0], lo_bits(yr[1]), hi_bits(yr[1]));
          tc::mma_tf32(acc[2 * p2], a[1], lo_bits(yr[2]), hi_bits(yr[2]));
          tc::mma_tf32(acc[2 * p2 + 1], a[1], lo_bits(yr[3]), hi_bits(yr[3]));
        }
      }
    }
    __syncthreads();                        // stage s is read: refill it
    if (k + 2 < dm.nC) load(ci - 2, s);
  }
}

// ---------------------------------------------------------------------------
// kernels 6-8: the chunk gradients, one kernel a role
// ---------------------------------------------------------------------------

// B and C [L32][BS] (bf16, the group's, for the whole walk; N padded with
// zeros to 128); per stage X and dY [L32][XS] (bf16; P padded to PW) and F
// [128][FS] (float32: G for roles 0 and 1, h for role 2); then, for each
// head of the walk, cum and its decay factors within each 32-step block (U
// for roles 0 and 1, W for role 2: decay_t, decay_n) [kHeads][128] each;
// the column sums of Q^T a row tile [kWarps][128]; Q's row sums, and x .
// inter dx (role 0) or c . inter dc (role 2), [128] each; a slot a warp.
// BS, XS = 8 mod 64 elements: ldmatrix rows 16 bytes apart mod 128, and the
// scalar fragment reads of a warp on distinct banks.  F's stride is 8 mod
// 32 floats for role 0 (scalar reads as [k][n]) and 4 mod 32 for roles 1
// and 2 (ldmatrix as [n][k]).  Rows are padded to a multiple of 32, the
// width of a score tile.
template <int PW>
struct ChunkMmaLayout {
  static constexpr int BS = kMaxL + 8, XS = PW + 8, FS = PW + 8;
  int L32, nstage;
  __host__ __device__ explicit ChunkMmaLayout(const Dims& d)
      : L32(round_up(d.L, 32)),
        nstage(group() + 2 * stage() + small() <= kSmemMax ? 2 : 1) {}
  __host__ __device__ size_t group() const {
    return 2 * static_cast<size_t>(L32) * BS * 2;
  }
  __host__ __device__ size_t stage() const {
    return 2 * static_cast<size_t>(L32) * XS * 2 +
           static_cast<size_t>(kMaxL) * FS * 4;
  }
  __host__ __device__ static constexpr size_t small() {
    return ((2 * kHeads + kWarps + 2) * kMaxL + kWarps) * 4;
  }
  __host__ __device__ size_t bytes() const {
    return group() + nstage * stage() + small();
  }
};

// what a role's code sees of the block
struct Chunk {
  int L, N, P, H, hh, warp, lane, g, t, r0, tid;
  bool active, vecf;
  long long row0;            // the chunk's first (batch, seq) row
  const bf16 *Bt, *Ct, *Xs, *Ys;
  const float *Fs, *cum, *fac;
  float *colpart, *colq, *rsum, *red;
};

// role 0: dx of head hh, and the terms of dla it sees, to dla
template <int PTM>
__device__ __forceinline__ void role_dx(const Chunk& k, const float* hb,
                                        bf16* dx, float* dla) {
  constexpr int PW = PTM * 8;
  using Lay = ChunkMmaLayout<PW>;
  const int g = k.g, t = k.t, r0 = k.r0, lane = k.lane;
  const float* cum = k.cum;
  // <h, G>: h from device memory, kHv float4 a thread in flight across each
  // product, G from shared memory (P % 4 == 0 and h 16-byte aligned, else
  // element by element at the end)
  const int NP = k.N * k.P;
  float hg = 0.f;
  float4 hv[kHv];
  int e4 = k.tid;                           // the batch's first float4
  auto fetch = [&]() {
#pragma unroll
    for (int j = 0; j < kHv; ++j) {
      const int e = 4 * (e4 + j * kThreads);
      hv[j] = e < NP ? __ldg(reinterpret_cast<const float4*>(hb + e))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto consume = [&]() {
#pragma unroll
    for (int j = 0; j < kHv; ++j) {
      const int e = 4 * (e4 + j * kThreads);
      if (e < NP) {
        const int n = e / k.P, p = e - n * k.P;
        const float4 gv =
            *reinterpret_cast<const float4*>(k.Fs + n * Lay::FS + p);
        hg = fmaf(hv[j].x, gv.x, hg);
        hg = fmaf(hv[j].y, gv.y, hg);
        hg = fmaf(hv[j].z, gv.z, hg);
        hg = fmaf(hv[j].w, gv.w, hg);
      }
    }
    e4 += kHv * kThreads;
  };
  if (k.vecf) fetch();
  float acc[PTM][4];
  zero(acc);
  if (k.active) {
    const float tot = cum[k.L - 1];
    const float w0 = expf(tot - cum[r0 + g]), w1 = expf(tot - cum[r0 + g + 8]);
    // (e^(tot - cum_j) b_j) G, TF32: A[j][n], B[n][p] = G[n][p]
#pragma unroll 4
    for (int k0 = 0; k0 < kMaxL; k0 += 8) {
      uint32_t a[4];
      scaled_a(a, k.Bt, Lay::BS, r0, k0, w0, w1, g, t);
      const float* g0 = k.Fs + (k0 + t) * Lay::FS + g;
      const float* g1 = g0 + 4 * Lay::FS;
#pragma unroll
      for (int pt = 0; pt < PTM; ++pt)
        tc::mma_tf32(acc[pt], a, __float_as_uint(g0[pt * 8]),
                     __float_as_uint(g1[pt * 8]));
    }
    // x_j . (its inter-chunk dx)
    const bf16* x0 = k.Xs + (r0 + g) * Lay::XS + 2 * t;
    const bf16* x1 = x0 + 8 * Lay::XS;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int pt = 0; pt < PTM; ++pt) {
      s0 += acc[pt][0] * bf(x0[pt * 8]) + acc[pt][1] * bf(x0[pt * 8 + 1]);
      s1 += acc[pt][2] * bf(x1[pt * 8]) + acc[pt][3] * bf(x1[pt * 8 + 1]);
    }
    s0 = quad_sum(s0);
    s1 = quad_sum(s1);
    if (t == 0) {
      k.rsum[r0 + g] = s0;
      k.rsum[r0 + g + 8] = s1;
    }
  }
  if (k.vecf) {
    consume();
    fetch();
  }
  if (k.active) {
    // the triangle i >= j, 32 columns i at a time: S1^T = B C^T, S2^T = X
    // dY^T (bf16), Q^T's sums, dx += (S1^T o E^T) dY (TF32)
    float q0 = 0.f, q1 = 0.f;               // Q's column sums, rows g, g + 8
    for (int ib = r0 & ~31; ib < k.L; ib += 32) {
      float s1[4][4], s2[4][4];
      scores<kMaxL>(s1, k.Bt, Lay::BS, r0, k.Ct, Lay::BS, ib, lane);
      scores<PW>(s2, k.Xs, Lay::XS, r0, k.Ys, Lay::XS, ib, lane);
      decay_t(s1, cum, k.fac, r0, ib, k.L, g, t);
      const bool diag = ib <= r0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float col[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = r0 + g + (e >> 1) * 8;
          const int i = ib + q * 8 + 2 * t + (e & 1);
          // Q^T = S1^T o S2^T o E^T at i > j (i < j is 0 in s1 already)
          const float qv = diag && i == j ? 0.f : s1[q][e] * s2[q][e];
          if (e >> 1) q1 += qv;
          else q0 += qv;
          col[e & 1] += qv;
        }
        // this warp's part of Q's row sums at columns i (over its rows j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = col[c];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (lane < 4)
            k.colpart[r0 * (kMaxL / 16) + ib + q * 8 + 2 * lane + c] = v;
        }
      }
      tri_product(acc, s1, k.Ys, Lay::XS, ib, lane);
    }
    q0 = quad_sum(q0);
    q1 = quad_sum(q1);
    if (t == 0) {
      k.colq[r0 + g] = q0;
      k.colq[r0 + g + 8] = q1;
    }
    const long long hp = static_cast<long long>(k.H) * k.P;
    store_acc(acc, dx + k.row0 * hp + static_cast<long long>(k.hh) * k.P, hp,
              r0, k.L, k.P, g, t);
  }
  if (k.vecf) {
    consume();
    while (4 * e4 < NP) {
      fetch();
      consume();
    }
  } else {
    for (int e = k.tid; e < NP; e += kThreads) {
      const int n = e / k.P, p = e - n * k.P;
      hg = fmaf(hb[e], k.Fs[n * Lay::FS + p], hg);
    }
  }
  // a shuffle tree a warp, the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    hg += __shfl_xor_sync(0xffffffffu, hg, off);
  if (lane == 0) k.red[k.warp] = hg;
  __syncthreads();
  // dla_t (but for the suffix of role 2) = sum_(s<t) (colq_s - rowq_s +
  // rsum_s) + e^tot <h, G>: warp 0, four steps a lane
  if (k.warp == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += k.red[w];
    const float carry = expf(cum[k.L - 1]) * total;
    float v[4];
    float run = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int tt = 4 * lane + r;
      float val = 0.f;
      if (tt < k.L) {
        float rowq = 0.f;           // sum_(j<t) Q_tj, row tiles in order
        for (int w = 0; w <= (tt >> 4); ++w) rowq += k.colpart[w * kMaxL + tt];
        val = k.colq[tt] - rowq + k.rsum[tt];
      }
      v[r] = run;
      run += val;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const float excl = incl - run;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int tt = 4 * lane + r;
      if (tt < k.L)
        dla[(k.row0 + tt) * k.H + k.hh] = excl + v[r] + carry;
    }
  }
}

// role 1: acc += this head's db, rows i >= j of the triangle
template <int PTM>
__device__ __forceinline__ void role_db(const Chunk& k, float (&acc)[kNT][4]) {
  constexpr int PW = PTM * 8;
  using Lay = ChunkMmaLayout<PW>;
  if (!k.active) return;
  const int g = k.g, t = k.t, r0 = k.r0, lane = k.lane;
  const float* cum = k.cum;
  const float tot = cum[k.L - 1];
  const float w0 = expf(tot - cum[r0 + g]), w1 = expf(tot - cum[r0 + g + 8]);
  // (e^(tot - cum_j) x_j) G^T, TF32: A[j][p], B[p][n] = G[n][p]
#pragma unroll
  for (int kk = 0; kk < PTM; ++kk) {
    uint32_t a[4];
    scaled_a(a, k.Xs, Lay::XS, r0, kk * 8, w0, w1, g, t);
    product_nk(acc, a, k.Fs, Lay::FS - 4, kk * 8, lane);
  }
  // (S2^T o E^T) C, S2^T = X dY^T
  for (int ib = r0 & ~31; ib < k.L; ib += 32) {
    float s2[4][4];
    scores<PW>(s2, k.Xs, Lay::XS, r0, k.Ys, Lay::XS, ib, lane);
    decay_t(s2, cum, k.fac, r0, ib, k.L, g, t);
    tri_product(acc, s2, k.Ct, Lay::BS, ib, lane);
  }
}

// role 2: acc += this head's dc, rows j <= i of the triangle; the suffix
// sums of c_i . (its inter-chunk dc) to dsuf
template <int PTM>
__device__ __forceinline__ void role_dc(const Chunk& k, float (&acc)[kNT][4],
                                        float* dsuf) {
  constexpr int PW = PTM * 8;
  using Lay = ChunkMmaLayout<PW>;
  const int g = k.g, t = k.t, r0 = k.r0, lane = k.lane;
  const float* cum = k.cum;
  if (k.active) {
    const float e0 = expf(cum[r0 + g]), e1 = expf(cum[r0 + g + 8]);
    // (e^cum_i dy_i) h^T, TF32: A[i][p], B[p][n] = h[n][p]; kG n8 tiles at
    // a time, each dotted with c before it joins acc
    constexpr int kG = PTM == 8 ? 8 : 4;    // n8 tiles a group
    float is0 = 0.f, is1 = 0.f;
#pragma unroll
    for (int ng = 0; ng < kNT; ng += kG) {
      float tmp[kG][4];
      zero(tmp);
#pragma unroll 4
      for (int kk = 0; kk < PTM; ++kk) {
        uint32_t a[4];
        scaled_a(a, k.Ys, Lay::XS, r0, kk * 8, e0, e1, g, t);
        product_nk(tmp, a, k.Fs + ng * 8 * (Lay::FS - 4), Lay::FS - 4,
                   kk * 8, lane);
      }
      const bf16* c0 = k.Ct + (r0 + g) * Lay::BS + ng * 8 + 2 * t;
      const bf16* c1 = c0 + 8 * Lay::BS;
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        is0 += tmp[q][0] * bf(c0[q * 8]) + tmp[q][1] * bf(c0[q * 8 + 1]);
        is1 += tmp[q][2] * bf(c1[q * 8]) + tmp[q][3] * bf(c1[q * 8 + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ng + q][e] += tmp[q][e];
      }
    }
    is0 = quad_sum(is0);
    is1 = quad_sum(is1);
    if (t == 0) {
      k.rsum[r0 + g] = is0;
      k.rsum[r0 + g + 8] = is1;
    }
    // (S2 o E) B, S2 = dY X^T, columns j <= i
    for (int jb = 0; jb <= r0; jb += 32) {
      float s2[4][4];
      scores<PW>(s2, k.Ys, Lay::XS, r0, k.Xs, Lay::XS, jb, lane);
      decay_n(s2, cum, k.fac, r0, jb, k.L, g, t);
      tri_product(acc, s2, k.Bt, Lay::BS, jb, lane);
    }
  }
  __syncthreads();
  // sum_(i>=t) e^cum_i c_i . (h dy_i): warp 0, four steps a lane, from the
  // last
  if (k.warp == 0) {
    float v[4];
    float run = 0.f;
#pragma unroll
    for (int r = 3; r >= 0; --r) {
      const int tt = 4 * lane + r;
      run += tt < k.L ? k.rsum[tt] : 0.f;
      v[r] = run;
    }
    float incl = run;                       // over this lane and the later
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float dn = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += dn;
    }
    const float after = incl - run;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int tt = 4 * lane + r;
      if (tt < k.L) dsuf[(k.row0 + tt) * k.H + k.hh] = after + v[r];
    }
  }
}

// a chunk kernel's operands, one struct for the three roles' kernels
struct ChunkArgs {
  const bf16 *x, *bm, *cm, *dy;
  const float *loga, *states, *grads;
  bf16* dx;
  float *dla, *dsuf, *dbp, *dcp;
  Dims dm;
  Strides xs, bs, cs;
  int parts, vec, vecf;
};

// one block of role ROLE: grid x = slice, then chunk (a chunk's slices
// neighbours); y = batch and group
template <int ROLE, int PTM>
__device__ __forceinline__ void chunk_body(const ChunkArgs& p) {
  constexpr int PW = PTM * 8;
  using Lay = ChunkMmaLayout<PW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Dims& dm = p.dm;
  const Lay lay(dm);
  Chunk k;
  k.tid = threadIdx.x;
  k.warp = k.tid >> 5;
  k.lane = k.tid & 31;
  k.g = k.lane >> 2;
  k.t = k.lane & 3;
  // warp w owns rows 16 w' .. 16 w' + 15 with w' = w for w < 4, else 11 -
  // w: the two warps of a scheduler (w, w + 4) hold a long and a short row
  // of the triangle's score tiles, five tiles of 32 columns between them at
  // L = 128
  k.r0 = 16 * (k.warp < 4 ? k.warp : 11 - k.warp);
  k.active = k.r0 < dm.L;
  k.vecf = p.vecf != 0;
  k.L = dm.L;
  k.N = dm.N;
  k.P = dm.P;
  k.H = dm.H;
  const int sl = blockIdx.x % p.parts, cc = blockIdx.x / p.parts;
  const int G = dm.H / dm.rep;
  const int bb = blockIdx.y / G, grp = blockIdx.y % G;
  const int h0 = grp * dm.rep + sl * kHeads;
  const int nh = min(kHeads, dm.rep - sl * kHeads);
  const int c0 = cc * dm.L;
  k.row0 = static_cast<long long>(bb) * dm.S + c0;
  const long long hp = static_cast<long long>(dm.H) * dm.P;
  const long long npq = static_cast<long long>(dm.N) * dm.P;

  bf16* Bt = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ct = Bt + lay.L32 * Lay::BS;
  float* small = reinterpret_cast<float*>(smem_raw + lay.group() +
                                          lay.nstage * lay.stage());
  float* cumall = small;                    // [kHeads][128]
  float* facall = cumall + kHeads * kMaxL;  // [kHeads][128]
  k.colpart = facall + kHeads * kMaxL;      // [kWarps][128]
  k.colq = k.colpart + kWarps * kMaxL;
  k.rsum = k.colq + kMaxL;
  k.red = k.rsum + kMaxL;
  k.Bt = Bt;
  k.Ct = Ct;
  auto xtile = [&](int s) {
    return reinterpret_cast<bf16*>(smem_raw + lay.group() + s * lay.stage());
  };
  auto ytile = [&](int s) { return xtile(s) + lay.L32 * Lay::XS; };
  auto ftile = [&](int s) {
    return reinterpret_cast<float*>(ytile(s) + lay.L32 * Lay::XS);
  };
  auto sbase = [&](int hh) {
    return ((static_cast<long long>(bb) * dm.nC + cc) * dm.H + hh) * npq;
  };
  // head hh's x, dy and G (roles 0, 1) or h (role 2) into stage s
  auto load = [&](int hh, int s) {
    tc::stage<kThreads>(xtile(s), Lay::XS, p.x + bb * p.xs.b + hh * p.xs.h +
                        c0 * p.xs.s, p.xs.s, dm.L, dm.P, lay.L32, PW, p.vec,
                        k.tid);
    tc::stage<kThreads>(ytile(s), Lay::XS, p.dy + k.row0 * hp +
                        static_cast<long long>(hh) * dm.P, hp, dm.L, dm.P,
                        lay.L32, PW, p.vec, k.tid);
    tc::stage<kThreads>(ftile(s), ROLE == 0 ? Lay::FS : Lay::FS - 4,
                        (ROLE == 2 ? p.states : p.grads) + sbase(hh),
                        static_cast<long long>(dm.P), dm.N, dm.P, kMaxL, PW,
                        p.vecf, k.tid);
    tc::cp_async_commit();
  };

  if (ROLE != 1)                            // role 1 reads no B
    tc::stage<kThreads>(Bt, Lay::BS, p.bm + bb * p.bs.b + grp * p.bs.h +
                        c0 * p.bs.s, p.bs.s, dm.L, dm.N, lay.L32, kMaxL,
                        p.vec, k.tid);
  tc::stage<kThreads>(Ct, Lay::BS, p.cm + bb * p.cs.b + grp * p.cs.h +
                      c0 * p.cs.s, p.cs.s, dm.L, dm.N, lay.L32, kMaxL, p.vec,
                      k.tid);
  load(h0, 0);                              // one group with B and C
  if (lay.nstage == 2 && nh > 1) load(h0 + 1, 1);
  if (k.warp < nh) {                        // warp w: head h0 + w
    float* cw = cumall + k.warp * kMaxL;
    chunk_cum(cw, p.loga + k.row0 * dm.H + h0 + k.warp, dm.H, dm.L, k.lane);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * k.lane + r;
      facall[k.warp * kMaxL + i] = ROLE == 2 ? __expf(cw[i | 31] - cw[i])
                                             : __expf(cw[i] - cw[i & ~31]);
    }
  }

  float acc[kNT][4];                        // db (role 1) or dc (role 2)
  zero(acc);
  for (int hi = 0; hi < nh; ++hi) {
    const int s = lay.nstage == 2 ? (hi & 1) : 0;
    if (lay.nstage == 1 && hi > 0) load(h0 + hi, 0);
    if (lay.nstage == 2 && hi + 1 < nh) tc::cp_async_wait<1>();
    else tc::cp_async_wait<0>();
    __syncthreads();
    k.hh = h0 + hi;
    k.cum = cumall + hi * kMaxL;
    k.fac = facall + hi * kMaxL;
    k.Xs = xtile(s);
    k.Ys = ytile(s);
    k.Fs = ftile(s);
    if constexpr (ROLE == 0)
      role_dx<PTM>(k, p.states + sbase(k.hh), p.dx, p.dla);
    else if constexpr (ROLE == 1)
      role_db<PTM>(k, acc);
    else
      role_dc<PTM>(k, acc, p.dsuf);
    __syncthreads();                        // stage s is read: refill it
    if (lay.nstage == 2 && hi + 2 < nh) load(h0 + hi + 2, s);
  }
  if (ROLE == 0 || !k.active) return;
  // this slice's db or dc: (B, S, G, parts, N) float32
  const long long ld = static_cast<long long>(G) * p.parts * dm.N;
  float* part = (ROLE == 1 ? p.dbp : p.dcp) +
                (k.row0 * G + grp) * p.parts * dm.N +
                static_cast<long long>(sl) * dm.N;
  store_acc(acc, part, ld, k.r0, dm.L, dm.N, k.g, k.t);
}

// the three roles as kernels of their own, so that each has the registers
// of its own work
template <int PTM>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_dx_mma(ChunkArgs p) {
  chunk_body<0, PTM>(p);
}

template <int PTM>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_db_mma(ChunkArgs p) {
  chunk_body<1, PTM>(p);
}

template <int PTM>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_dc_mma(ChunkArgs p) {
  chunk_body<2, PTM>(p);
}

// ---------------------------------------------------------------------------
// kernel 9: the slices summed, da finished
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish(const float* __restrict__ dbp, const float* __restrict__ dcp,
               bf16* __restrict__ db, bf16* __restrict__ dc,
               const float* __restrict__ a, float* __restrict__ dla,
               const float* __restrict__ dsuf, long long n_bc, long long n_a,
               int parts, int N) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e < n_bc) {
    const long long rg = e / N;            // (b s) G + g
    const long long base = rg * parts * N + (e - rg * N);
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < parts; ++r) {
      sb += dbp[base + static_cast<long long>(r) * N];
      sc += dcp[base + static_cast<long long>(r) * N];
    }
    db[e] = __float2bfloat16(sb);
    dc[e] = __float2bfloat16(sc);
  } else if (e - n_bc < n_a) {
    const long long i = e - n_bc;
    const float av = a[i];
    dla[i] = av > kFloor ? (dla[i] + dsuf[i]) / av : 0.f;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int PTM>
int state_t(const bf16* c, const bf16* dy, const float* loga,
            const float* decay, float* grads, int B, const Dims& dm,
            Strides cs, int vec, cudaStream_t st) {
  const size_t smem = StateMmaLayout<PTM * 8>(dm).bytes();
  cudaError_t err = allow_smem(ssd_bwd_state_mma<PTM>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_state_mma<PTM><<<dim3(dm.H, B), kThreads, smem, st>>>(
      c, dy, loga, decay, grads, dm, cs, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int PTM>
int chunk_t(const ChunkArgs& p, const float* a, bf16* db, bf16* dc, int B,
            int G, cudaStream_t st) {
  const Dims& dm = p.dm;
  const size_t smem = ChunkMmaLayout<PTM * 8>(dm).bytes();
  const dim3 grid(p.parts * dm.nC, B * G);
  void (*const kerns[])(ChunkArgs) = {ssd_bwd_dx_mma<PTM>, ssd_bwd_db_mma<PTM>,
                                      ssd_bwd_dc_mma<PTM>};
  for (auto kern : kerns) {
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<grid, kThreads, smem, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_bc = static_cast<long long>(B) * dm.S * G * dm.N;
  const long long n_a = static_cast<long long>(B) * dm.S * dm.H;
  const long long blocks = (n_bc + n_a + kThreads - 1) / kThreads;
  ssd_bwd_finish<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      p.dbp, p.dcp, db, dc, a, p.dla, p.dsuf, n_bc, n_a, p.parts, dm.N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Entry points for ssd_scan_bwd.cu (C++ linkage, this library only; plain
// types in their signatures, as the structs above are this source's own)
namespace ssd_bwd_mma {

int parts(int rep) { return (rep + kHeads - 1) / kHeads; }

int state(const void* c, const void* dy, const void* loga, const void* decay,
          void* grads, int B, int S, int H, int G, int P, int N, int L,
          long long csb, long long css, long long csh, cudaStream_t st) {
  const Dims dm{S, H, H / G, P, N, L, S / L};
  const Strides cs{csb, css, csh};
  const long long strides[] = {csb, css, csh};
  bool vec = N % 8 == 0 && P % 8 == 0 && aligned16(c) && aligned16(dy);
  for (long long s : strides) vec = vec && s % 8 == 0;
  const bf16* cp = static_cast<const bf16*>(c);
  const bf16* yp = static_cast<const bf16*>(dy);
  const float* lp = static_cast<const float*>(loga);
  const float* dp = static_cast<const float*>(decay);
  float* gp = static_cast<float*>(grads);
  return P <= 64 ? state_t<8>(cp, yp, lp, dp, gp, B, dm, cs, vec, st)
                 : state_t<16>(cp, yp, lp, dp, gp, B, dm, cs, vec, st);
}

int chunk(const void* x, const void* a, const void* loga, const void* b,
          const void* c, const void* dy, const void* states,
          const void* grads, void* dx, void* da, void* dsuf, void* dbp,
          void* dcp, void* db, void* dc, int B, int S, int H, int G, int P,
          int N, int L, long long xsb, long long xss, long long xsh,
          long long bsb, long long bss, long long bsh, long long csb,
          long long css, long long csh, cudaStream_t st) {
  const Dims dm{S, H, H / G, P, N, L, S / L};
  const Strides xs{xsb, xss, xsh}, bs{bsb, bss, bsh}, cs{csb, css, csh};
  const long long strides[] = {xsb, xss, xsh, bsb, bss, bsh, csb, css, csh};
  bool vec = N % 8 == 0 && P % 8 == 0 && aligned16(x) && aligned16(b) &&
             aligned16(c) && aligned16(dy);
  for (long long s : strides) vec = vec && s % 8 == 0;
  const bool vecf = P % 4 == 0 && aligned16(states) && aligned16(grads);
  const ChunkArgs p{static_cast<const bf16*>(x), static_cast<const bf16*>(b),
                    static_cast<const bf16*>(c), static_cast<const bf16*>(dy),
                    static_cast<const float*>(loga),
                    static_cast<const float*>(states),
                    static_cast<const float*>(grads), static_cast<bf16*>(dx),
                    static_cast<float*>(da), static_cast<float*>(dsuf),
                    static_cast<float*>(dbp), static_cast<float*>(dcp), dm, xs,
                    bs, cs, parts(dm.rep), vec ? 1 : 0, vecf ? 1 : 0};
  const float* af = static_cast<const float*>(a);
  bf16* dbo = static_cast<bf16*>(db);
  bf16* dco = static_cast<bf16*>(dc);
  return P <= 64 ? chunk_t<8>(p, af, dbo, dco, B, G, st)
                 : chunk_t<16>(p, af, dbo, dco, B, G, st);
}

// kernel 5 (state), 6, 7, 8 (the chunk's dx, db, dc roles) or 9 (finish):
// its name, its function as a launch at (L, N, P) runs it, and the dynamic
// shared memory that launch requests (ssd_scan_bwd.cu's bwd_kernel, the
// table of the backward's kernels); false for another number
bool entry(int kernel, int L, int N, int P, const char** name,
           const void** fn, long long* smem) {
  const Dims dm{L, 1, 1, P, N, L, 1};
  const bool narrow = P <= 64;
  *smem = static_cast<long long>(narrow ? ChunkMmaLayout<64>(dm).bytes()
                                        : ChunkMmaLayout<128>(dm).bytes());
  switch (kernel) {
    case 5:
      *name = "ssd_bwd_state_mma";
      *fn = narrow ? reinterpret_cast<const void*>(ssd_bwd_state_mma<8>)
                   : reinterpret_cast<const void*>(ssd_bwd_state_mma<16>);
      *smem = static_cast<long long>(narrow
                                         ? StateMmaLayout<64>(dm).bytes()
                                         : StateMmaLayout<128>(dm).bytes());
      return true;
    case 6:
      *name = "ssd_bwd_dx_mma";
      *fn = narrow ? reinterpret_cast<const void*>(ssd_bwd_dx_mma<8>)
                   : reinterpret_cast<const void*>(ssd_bwd_dx_mma<16>);
      return true;
    case 7:
      *name = "ssd_bwd_db_mma";
      *fn = narrow ? reinterpret_cast<const void*>(ssd_bwd_db_mma<8>)
                   : reinterpret_cast<const void*>(ssd_bwd_db_mma<16>);
      return true;
    case 8:
      *name = "ssd_bwd_dc_mma";
      *fn = narrow ? reinterpret_cast<const void*>(ssd_bwd_dc_mma<8>)
                   : reinterpret_cast<const void*>(ssd_bwd_dc_mma<16>);
      return true;
    case 9:
      *name = "ssd_bwd_finish";
      *fn = reinterpret_cast<const void*>(ssd_bwd_finish);
      *smem = 0;
      return true;
    default:
      return false;
  }
}

}  // namespace ssd_bwd_mma
