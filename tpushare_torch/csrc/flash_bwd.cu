// Flash-attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel, with a plain C interface that
// tpushare_torch/kernels/flash_bwd.py loads through ctypes.
//
// Replaces the TPU kernels of tpushare/workloads/attention.py:
// - flash_bwd_dq_kernel   <- _flash_bwd_dq_kernel (shared math _bwd_common)
// - flash_bwd_dkdv_kernel <- _flash_bwd_dkdv_kernel
// both launched by _flash_bwd_pallas. They compute the same functions over
// q [B,H,S,D] and k/v [B,Hkv,Skv,D] (GQA: query head h reads kv head
// h / (H/Hkv), and the kv heads are never expanded):
//   P  = exp(S - LSE),  S = q_s K^T            (q_s: q pre-scaled by D^-0.5)
//   dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(dO * O)
//   dq = D^-0.5 * sum_j dS K          (dq kernel)
//   dv = sum_{i,g} P^T dO,  dk = sum_{i,g} dS^T q_s   (dk/dv kernel)
// The wrapper prepares q_s, dO in q's dtype, the LSE with -inf clamped to
// +1e30 (so P is exactly 0 on rows that see no key) and delta, as the
// reference does outside its kernels.
//
// The reference contract it keeps:
// - scores and dP are fp32 out of products of storage-dtype tiles;
// - P stays fp32 for dS and is rounded to dO's dtype before the dV product;
// - dS is rounded to k's dtype before both products that read it;
// - dq leaves the kernel rounded to q's dtype, then is scaled by D^-0.5 in
//   fp32 and rounded again (the reference's dqs.astype, then * scale);
// - causal: the dq kernel's kv loop stops at the diagonal tile and the
//   dk/dv kernel's q loop starts at it; window: the dq loop starts at the
//   window floor's tile and the dk/dv loop ends at the last q tile whose
//   window reaches the kv tile;
// - ragged S and Skv: padded keys are masked in the dq kernel (their dk/dv
//   rows are never written), padded query rows get LSE +1e30 and delta 0 so
//   their P and dS are exactly 0.
// No atomics: each block owns its outputs and sums in a fixed order, so
// two launches give bitwise the same gradients.
//
// Design. The TPU kernels carry their accumulators across sequential grid
// axes. Here one block of the dq kernel owns one (q tile, head, batch) and
// walks its kv tiles; one block of the dk/dv kernel owns one (kv tile, kv
// head, batch) and walks (q tile i, group member g), so the GQA group sum
// happens inside the block. Tiles are 64 x 64 (the TPU's 512 x 512 do not
// fit 227 KB of shared memory): two tiles from global memory stay for the
// whole block (q and dO, or k and v), two are streamed, and the fp32 score
// and dP tiles, the rounded P and dS tiles and the fp32 accumulators live
// in shared memory (dq: 157 KB, dk/dv: 191 KB at bf16, D=128, one block a
// SM). In fp32 the P and dS tiles overwrite the score and dP tiles in
// place, and the dk/dv accumulators live in registers, which keeps fp32 at
// D=128 under the 227 KB. bf16 runs the four products on the tensor cores
// through WMMA 16x16x16 fragments with fp32 accumulation; fp32 runs them
// as scalar FMAs.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the
// dq kernel does 6*D FLOPs and the dk/dv kernel 8*D for each visible
// (query, key) pair and head; at the training shape (B1 H32 Hkv8 S1023
// D128 bf16 causal) that is 12.9 and 17.2 GFLOP over 29.6 and 25.4 MB,
// 435 and 677 operations per byte against the card's 295: both are bound
// by operations (0.013 and 0.017 ms), within 2.3x of the bytes bound.
// This first version is far from that bound: every tile
// passes through shared memory between products, loads are synchronous
// (no cp.async or TMA), WMMA issues mma.sync and not wgmma, and the dk/dv
// grid (Skv/64 * Hkv * B blocks, 128 at the training shape) fills less
// than one wave of 132 SMs. Its times beside the bound are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows a tile
constexpr int BK = 64;         // keys a tile
constexpr int NTHREADS = 128;  // four warps; warp w owns tile rows 16w..16w+15
constexpr size_t kMaxSmem = 232448;  // 227 KB, what one block may use

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;       // pre-scaled q [B,H,S,D]
  const void* k;       // [B,Hkv,Skv,D]
  const void* v;
  const void* dout;    // dO in q's dtype [B,H,S,D]
  const float* lse;    // [B,H,S] contiguous, -inf clamped to +1e30
  const float* delta;  // [B,H,S] contiguous
  void* out0;          // dq [B,H,S,D], or dk [B,Hkv,Skv,D]; contiguous
  void* out1;          // dv [B,Hkv,Skv,D] contiguous (dk/dv kernel only)
  int B, H, Hkv, S, Skv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  int causal;
  int window;  // 0 = no window
  float scale;
  int vec;  // every q/k/v/dO row start is 16-byte aligned
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Shared-memory layout of one block of either kernel. Row pitches are
// padded: bf16 tiles by 8 elements (WMMA needs a pitch that is a multiple
// of 16 bytes), fp32 input tiles by 1 (the scalar products read rows
// across a half-warp, and an odd pitch puts them in distinct banks).
template <typename T, int D>
struct Layout {
  static constexpr bool kTensorCore = sizeof(T) == 2;
  static constexpr int LDT = D + (kTensorCore ? 8 : 1);  // q, k, v, dO tiles
  static constexpr int LDS = BK + 4;                      // fp32 S, dP tiles
  static constexpr int LDP = kTensorCore ? BK + 8 : LDS;  // P, dS tiles
  static constexpr int LDA = D + 4;                       // fp32 accumulators
  static constexpr size_t tile = align128(sizeof(T) * 64 * LDT);
  static constexpr size_t t0 = 0;
  static constexpr size_t t1 = t0 + tile;
  static constexpr size_t t2 = t1 + tile;
  static constexpr size_t t3 = t2 + tile;
  static constexpr size_t s_off = t3 + tile;
  static constexpr size_t dp_off = align128(s_off + sizeof(float) * 64 * LDS);
  static constexpr size_t sdp_end = align128(dp_off + sizeof(float) * 64 * LDS);
  // fp32: P and dS overwrite S and dP in place (same pitch)
  static constexpr size_t p_off = kTensorCore ? sdp_end : s_off;
  static constexpr size_t ds_off =
      kTensorCore ? align128(p_off + sizeof(T) * 64 * LDP) : dp_off;
  static constexpr size_t pds_end =
      kTensorCore ? align128(ds_off + sizeof(T) * 64 * LDP) : sdp_end;
  static constexpr size_t row_off = pds_end;  // lse[64], delta[64]
  static constexpr size_t acc_off = align128(row_off + sizeof(float) * 128);
  static constexpr size_t acc = align128(sizeof(float) * 64 * LDA);
  static constexpr size_t dq_bytes = acc_off + acc;
  // fp32 keeps the dk/dv accumulators in registers
  static constexpr size_t dkdv_bytes = acc_off + (kTensorCore ? 2 * acc : 0);
  static_assert(dq_bytes <= kMaxSmem, "dq kernel exceeds shared memory");
  static_assert(dkdv_bytes <= kMaxSmem, "dk/dv kernel exceeds shared memory");
};

// Copy a 64-row tile of D columns from global memory into shared memory,
// zero-filling rows >= rows_valid.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride,
                                          int rows_valid, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  if (vec) {
    for (int idx = threadIdx.x; idx < 64 * VPR; idx += NTHREADS) {
      const int r = idx / VPR;
      const int c = (idx % VPR) * VEC;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid) {
        raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      }
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[r * LD + c + e] = vals[e];
    }
  } else {
    for (int idx = threadIdx.x; idx < 64 * D; idx += NTHREADS) {
      const int r = idx / D;
      const int c = idx % D;
      dst[r * LD + c] = r < rows_valid ? src[r * row_stride + c] : from_f<T>(0.f);
    }
  }
}

// LSE and delta of query rows i0..i0+63 of head h; rows past S get LSE
// +1e30 and delta 0, so their P and dS are exactly 0.
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const Params& p, int b, int h,
                                          int i0) {
  if (threadIdx.x < BQ) {
    const int r = i0 + threadIdx.x;
    const long long off = (static_cast<long long>(b) * p.H + h) * p.S + r;
    lse_s[threadIdx.x] = r < p.S ? p.lse[off] : 1e30f;
    delta_s[threadIdx.x] = r < p.S ? p.delta[off] : 0.f;
  }
}

// ---- C[64 x 64] = A[64 x D] B[64 x D]^T into an fp32 tile -----------------

template <int D>
__device__ __forceinline__ void nt_tc(const bf16* A, const bf16* Bm,
                                      float* C) {
  using namespace nvcuda;
  using L = Layout<bf16, D>;
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, A + warp * 16 * L::LDT + kk, L::LDT);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      // B stored [row][d] row-major is B^T in column-major order
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, Bm + n * 16 * L::LDT + kk, L::LDT);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::store_matrix_sync(C + warp * 16 * L::LDS + n * 16, acc[n], L::LDS,
                            wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void nt_scalar(const float* A, const float* Bm,
                                          float* C) {
  using L = Layout<float, D>;
  // thread (ty, tx) owns rows ty + 8i and columns tx + 16j
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = A[(ty + 8 * i) * L::LDT + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bm[(tx + 16 * j) * L::LDT + d];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      C[(ty + 8 * i) * L::LDS + tx + 16 * j] = acc[i][j];
}

// ---- Acc[64 x D] += P[64 x 64] V[64 x D] -----------------------------------

template <int D>
__device__ __forceinline__ void nn_tc(const bf16* P, const bf16* V,
                                      float* Acc) {
  using namespace nvcuda;
  using L = Layout<bf16, D>;
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[BK / 16];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wmma::load_matrix_sync(a[kk], P + warp * 16 * L::LDP + kk * 16, L::LDP);
  }
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    float* out = Acc + warp * 16 * L::LDA + n * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, out, L::LDA, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, V + kk * 16 * L::LDT + n * 16, L::LDT);
      wmma::mma_sync(acc, a[kk], b, acc);
    }
    wmma::store_matrix_sync(out, acc, L::LDA, wmma::mem_row_major);
  }
}

// fp32 with the accumulator in registers: thread (ty, tx) owns rows
// ty + 8i and columns tx + 16c of Acc
template <int D>
__device__ __forceinline__ void nn_scalar(const float* P, const float* V,
                                          float (&acc)[8][D / 16]) {
  using L = Layout<float, D>;
  constexpr int NC = D / 16;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  for (int kk = 0; kk < BK; ++kk) {
    float a[8], b[NC];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = P[(ty + 8 * i) * L::LDP + kk];
#pragma unroll
    for (int c = 0; c < NC; ++c) b[c] = V[kk * L::LDT + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
}

// fp32 with the accumulator in shared memory (the dq kernel)
template <int D>
__device__ __forceinline__ void nn_scalar_smem(const float* P, const float* V,
                                               float* Acc) {
  using L = Layout<float, D>;
  constexpr int NC = D / 16;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      acc[i][c] = Acc[(ty + 8 * i) * L::LDA + tx + 16 * c];
  nn_scalar<D>(P, V, acc);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      Acc[(ty + 8 * i) * L::LDA + tx + 16 * c] = acc[i][c];
}

// ---- P and dS from the S and dP tiles ---------------------------------------
// dS = round_T(P * (dP - delta)) and, with WANT_P, round_T(P), where
// P = exp(S - LSE) in fp32. KT: the tiles are transposed (rows are keys,
// columns query rows), as in the dk/dv kernel. MASK: an edge tile (padded
// keys, the causal diagonal, the window floor); interior tiles run without
// any compare. Two threads a row, 32 columns each; in fp32 each element is
// read and overwritten in place by the same thread.
template <typename T, int D, bool KT, bool MASK, bool WANT_P>
__device__ __forceinline__ void grad_tile(const float* Ss, const float* dPs,
                                          T* Ps, T* dSs, const float* lse_s,
                                          const float* delta_s, int q0,
                                          int k0, const Params& p) {
  using L = Layout<T, D>;
  constexpr int HALF = BK / 2;
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
#pragma unroll 8
  for (int c = 0; c < HALF; ++c) {
    const int cc = half * HALF + c;
    const int qi = KT ? cc : r;
    const int ki = KT ? r : cc;
    float s = Ss[r * L::LDS + cc];
    if (MASK) {
      const int gq = q0 + qi;
      const int gk = k0 + ki;
      bool vis = gk < p.Skv;
      if (p.causal) vis = vis && gk <= gq;
      if (p.window > 0) vis = vis && gk >= gq - (p.window - 1);
      if (!vis) s = -INFINITY;
    }
    const float pr = expf(s - lse_s[qi]);  // masked entries give exactly 0
    const float ds = pr * (dPs[r * L::LDS + cc] - delta_s[qi]);
    if (WANT_P) Ps[r * L::LDP + cc] = from_f<T>(pr);
    dSs[r * L::LDP + cc] = from_f<T>(ds);
  }
}

// ---- dq: one block per (q tile, head, batch) --------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(Params p) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::t0);
  T* dOs = reinterpret_cast<T*>(smem + L::t1);
  T* Ks = reinterpret_cast<T*>(smem + L::t2);
  T* Vs = reinterpret_cast<T*>(smem + L::t3);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  T* dSs = reinterpret_cast<T*>(smem + L::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::row_off);
  float* delta_s = lse_s + BQ;
  float* dQ = reinterpret_cast<float*>(smem + L::acc_off);

  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const bool vec = p.vec != 0;
  const int q_valid = min(BQ, p.S - i0);

  load_tile<T, D, L::LDT>(Qs, qg + i0 * p.q_ss, p.q_ss, q_valid, vec);
  load_tile<T, D, L::LDT>(dOs, dog + i0 * p.do_ss, p.do_ss, q_valid, vec);
  load_rows(lse_s, delta_s, p, b, h, i0);
  for (int idx = threadIdx.x; idx < BQ * L::LDA; idx += NTHREADS) {
    dQ[idx] = 0.f;
  }

  // kv tiles this q tile can see: [j_begin, j_end)
  const int last_row = i0 + BQ - 1;
  const int n_kv = (p.Skv + BK - 1) / BK;
  const int j_end = p.causal ? min(n_kv, last_row / BK + 1) : n_kv;
  const int j_begin = p.window > 0 ? max(i0 - (p.window - 1), 0) / BK : 0;

  for (int j = j_begin; j < j_end; ++j) {
    const int j0 = j * BK;
    const bool edge = (j0 + BK > p.Skv) ||
                      (p.causal && j0 + BK - 1 > i0) ||
                      (p.window > 0 && j0 < last_row - (p.window - 1));
    const int kv_valid = min(BK, p.Skv - j0);
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/dS
    load_tile<T, D, L::LDT>(Ks, kg + j0 * p.k_ss, p.k_ss, kv_valid, vec);
    load_tile<T, D, L::LDT>(Vs, vg + j0 * p.v_ss, p.v_ss, kv_valid, vec);
    __syncthreads();
    if constexpr (L::kTensorCore) {
      nt_tc<D>(Qs, Ks, Ss);
      nt_tc<D>(dOs, Vs, dPs);
    } else {
      nt_scalar<D>(Qs, Ks, Ss);
      nt_scalar<D>(dOs, Vs, dPs);
    }
    __syncthreads();
    if (edge) {
      grad_tile<T, D, false, true, false>(Ss, dPs, nullptr, dSs, lse_s,
                                          delta_s, i0, j0, p);
    } else {
      grad_tile<T, D, false, false, false>(Ss, dPs, nullptr, dSs, lse_s,
                                           delta_s, i0, j0, p);
    }
    __syncthreads();
    if constexpr (L::kTensorCore) {
      nn_tc<D>(dSs, Ks, dQ);
    } else {
      nn_scalar_smem<D>(dSs, Ks, dQ);
    }
  }
  __syncthreads();

  // dq in q's dtype, then scaled in fp32 and rounded again; rows past S
  // are not written
  T* dqg = static_cast<T*>(p.out0) +
           (static_cast<long long>(b) * p.H + h) * p.S * D;
  for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D;
    const int c = idx % D;
    if (i0 + r < p.S) {
      const float rounded = to_f(from_f<T>(dQ[r * L::LDA + c]));
      dqg[static_cast<long long>(i0 + r) * D + c] =
          from_f<T>(rounded * p.scale);
    }
  }
}

// ---- dk/dv: one block per (kv tile, kv head, batch) -------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkdv_kernel(Params p) {
  using L = Layout<T, D>;
  constexpr int NC = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L::t0);
  T* Vs = reinterpret_cast<T*>(smem + L::t1);
  T* Qs = reinterpret_cast<T*>(smem + L::t2);
  T* dOs = reinterpret_cast<T*>(smem + L::t3);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  T* Ps = reinterpret_cast<T*>(smem + L::p_off);
  T* dSs = reinterpret_cast<T*>(smem + L::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::row_off);
  float* delta_s = lse_s + BQ;
  float* dK = reinterpret_cast<float*>(smem + L::acc_off);
  float* dV = reinterpret_cast<float*>(smem + L::acc_off + L::acc);
  float dk_r[8][NC];  // fp32 only: the accumulators in registers
  float dv_r[8][NC];

  const int j0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.Hkv;
  const bool vec = p.vec != 0;
  const int kv_valid = min(BK, p.Skv - j0);

  load_tile<T, D, L::LDT>(
      Ks, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh + j0 * p.k_ss,
      p.k_ss, kv_valid, vec);
  load_tile<T, D, L::LDT>(
      Vs, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh + j0 * p.v_ss,
      p.v_ss, kv_valid, vec);
  if constexpr (L::kTensorCore) {
    for (int idx = threadIdx.x; idx < BK * L::LDA; idx += NTHREADS) {
      dK[idx] = 0.f;
      dV[idx] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dk_r[i][c] = 0.f;
        dv_r[i][c] = 0.f;
      }
  }

  // q tiles that see this kv tile: [i_begin, i_end)
  const int n_q = (p.S + BQ - 1) / BQ;
  const int i_begin = p.causal ? j0 / BQ : 0;
  const int i_end =
      p.window > 0 ? min(n_q, (j0 + BK + p.window - 2) / BQ + 1) : n_q;

  for (int i = i_begin; i < i_end; ++i) {
    const int i0 = i * BQ;
    const int q_valid = min(BQ, p.S - i0);
    // padded keys need no mask here: their dk/dv rows are not written
    const bool edge = (p.causal && j0 + BK - 1 > i0) ||
                      (p.window > 0 && j0 < i0 + BQ - 1 - (p.window - 1));
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      __syncthreads();  // the previous step's readers are done with Qs/dOs
      load_tile<T, D, L::LDT>(Qs,
                              static_cast<const T*>(p.q) + b * p.q_sb +
                                  h * p.q_sh + i0 * p.q_ss,
                              p.q_ss, q_valid, vec);
      load_tile<T, D, L::LDT>(dOs,
                              static_cast<const T*>(p.dout) + b * p.do_sb +
                                  h * p.do_sh + i0 * p.do_ss,
                              p.do_ss, q_valid, vec);
      load_rows(lse_s, delta_s, p, b, h, i0);
      __syncthreads();
      if constexpr (L::kTensorCore) {
        nt_tc<D>(Ks, Qs, Ss);
        nt_tc<D>(Vs, dOs, dPs);
      } else {
        nt_scalar<D>(Ks, Qs, Ss);
        nt_scalar<D>(Vs, dOs, dPs);
      }
      __syncthreads();
      if (edge) {
        grad_tile<T, D, true, true, true>(Ss, dPs, Ps, dSs, lse_s, delta_s,
                                          i0, j0, p);
      } else {
        grad_tile<T, D, true, false, true>(Ss, dPs, Ps, dSs, lse_s, delta_s,
                                           i0, j0, p);
      }
      __syncthreads();
      if constexpr (L::kTensorCore) {
        nn_tc<D>(Ps, dOs, dV);
        nn_tc<D>(dSs, Qs, dK);
      } else {
        nn_scalar<D>(Ps, dOs, dv_r);
        nn_scalar<D>(dSs, Qs, dk_r);
      }
    }
  }
  __syncthreads();

  // emit in k's dtype; keys past Skv are not written
  const long long base = (static_cast<long long>(b) * p.Hkv + hk) * p.Skv * D;
  T* dkg = static_cast<T*>(p.out0) + base;
  T* dvg = static_cast<T*>(p.out1) + base;
  if constexpr (L::kTensorCore) {
    for (int idx = threadIdx.x; idx < BK * D; idx += NTHREADS) {
      const int r = idx / D;
      const int c = idx % D;
      if (r < kv_valid) {
        const long long off = static_cast<long long>(j0 + r) * D + c;
        dkg[off] = from_f<T>(dK[r * L::LDA + c]);
        dvg[off] = from_f<T>(dV[r * L::LDA + c]);
      }
    }
  } else {
    const int ty = threadIdx.x >> 4;
    const int tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i;
      if (r < kv_valid) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const long long off =
              static_cast<long long>(j0 + r) * D + tx + 16 * c;
          dkg[off] = from_f<T>(dk_r[i][c]);
          dvg[off] = from_f<T>(dv_r[i][c]);
        }
      }
    }
  }
}

template <typename T, int D>
int launch(int kernel, const Params& p, cudaStream_t stream) {
  using L = Layout<T, D>;
  cudaError_t err;
  if (kernel == 0) {
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::dq_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((p.S + BQ - 1) / BQ, p.H, p.B);
    flash_bwd_dq_kernel<T, D><<<grid, NTHREADS, L::dq_bytes, stream>>>(p);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::dkdv_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((p.Skv + BK - 1) / BK, p.Hkv, p.B);
    flash_bwd_dkdv_kernel<T, D><<<grid, NTHREADS, L::dkdv_bytes, stream>>>(
        p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int kernel, int head_dim, const Params& p,
               cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(kernel, p, stream);
    case 32: return launch<T, 32>(kernel, p, stream);
    case 64: return launch<T, 64>(kernel, p, stream);
    case 128: return launch<T, 128>(kernel, p, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// kernel: 0 = dq (out0 = dq), 1 = dk/dv (out0 = dk, out1 = dv).
// dtype: 0 = fp32, 1 = bf16. Strides are in elements; the last dimension
// of q, k, v and dout must be contiguous; lse, delta and the outputs are
// contiguous. Returns 0, a cudaError_t value, or -1 for a (kernel, dtype,
// head_dim) this library was not built for.
int tpushare_flash_bwd(int device, int kernel, int dtype, int head_dim,
                       const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* out0, void* out1, int B,
                       int H, int Hkv, int S, int Skv, long long q_sb,
                       long long q_sh, long long q_ss, long long k_sb,
                       long long k_sh, long long k_ss, long long v_sb,
                       long long v_sh, long long v_ss, long long do_sb,
                       long long do_sh, long long do_ss, int causal,
                       int window, float scale, int vec, void* stream) {
  if (kernel != 0 && kernel != 1) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{q,     k,     v,     dout,  lse,   delta, out0,   out1,
           B,     H,     Hkv,   S,     Skv,   q_sb,  q_sh,   q_ss,
           k_sb,  k_sh,  k_ss,  v_sb,  v_sh,  v_ss,  do_sb,  do_sh,
           do_ss, causal, window, scale, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(kernel, head_dim, p, s);
  if (dtype == 1) return dispatch_d<bf16>(kernel, head_dim, p, s);
  return -1;
}

const char* tpushare_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
