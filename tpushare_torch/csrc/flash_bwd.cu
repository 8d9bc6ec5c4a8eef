// Flash-attention backward for Hopper (sm_90a): the dq kernel (K2) and
// the dk/dv kernel (K3), with a plain C interface that
// tpushare_torch/kernels/flash_bwd.py loads through ctypes.
//
// Replaces the TPU kernels of tpushare/workloads/attention.py:
// - dq    <- _flash_bwd_dq_kernel (shared math _bwd_common)
// - dk/dv <- _flash_bwd_dkdv_kernel
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
// The reference contract both designs keep:
// - scores and dP are fp32 out of products of storage-dtype tiles;
// - P stays fp32 for dS and is rounded to dO's dtype before the dV product;
// - dS is rounded to k's dtype before both products that read it;
// - dq leaves the accumulator rounded to q's dtype, then is scaled by
//   D^-0.5 in fp32 and rounded again (the reference's dqs.astype, then
//   * scale);
// - causal: the dq kernel's kv loop stops at the diagonal tile and the
//   dk/dv kernel's q loop starts at it; window: the dq loop starts at the
//   window floor's tile and the dk/dv loop ends at the last q tile whose
//   window reaches the kv tile; interior tiles run without any compare,
//   edge tiles (pad, causal diagonal, window floor) with them;
// - ragged S and Skv: padded keys are masked in the dq kernel (their dk/dv
//   rows are never written), padded query rows get LSE +1e30 and delta 0
//   (guarded loads, never a bulk copy past row S) so their P and dS are
//   exactly 0.
// No atomics: each CTA owns its outputs and sums in a fixed order, so
// two launches give bitwise the same gradients. The two-kernel split is
// the reference's: fusing dq into the dk/dv kernel would need dq atomics
// or a serialised reduction.
//
// What bounds them on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s):
// the dq kernel does 6*D FLOPs and the dk/dv kernel 8*D for each visible
// (query, key) pair and head; at the training shape (B1 H32 Hkv8 S1023
// D128 bf16 causal) that is 12.9 and 17.2 GFLOP over 29.6 and 25.4 MB,
// 435 and 677 operations per byte against the card's 295: both are bound
// by operations (0.013 and 0.017 ms). The first design (WMMA, every tile
// through shared memory, synchronous loads, four block barriers a tile
// step) took 9-10 us a tile step; the bf16 design below removes that
// chain, as flash_fwd.cu's did for the forward.
//
// bf16: the Hopper design (flash_bwd_dq_tc_kernel, flash_bwd_dkdv_tc_kernel;
// the building blocks are hopper.cuh's, shared with the forward).
// - Both: 384 threads, a producer warpgroup whose one thread issues TMA
//   loads through 4-D tensor maps over the caller's strides into a ring
//   of STAGES = 3 stages with full and empty mbarriers (plain loads into
//   the same swizzled layout for rows off 16-byte alignment or stride-0
//   views), and two wgmma consumer warpgroups; every accumulator lives in
//   registers, and no group is in flight between two tile steps.
//   setmaxnreg: 40/232 in dq; 72/216 in dk/dv, whose producer also loads
//   the LSE and delta rows and spilled at 40 and 56.
// - dq: one CTA per (128-row q tile, head, batch), q tiles longest-first;
//   Q and dO stay, K_j and V_j stream. Each consumer warpgroup owns 64
//   rows: S = Q K^T and dP = dO V^T (m64n64k16, both operands K-major from
//   shared memory) go in flight together, P = exp(S - LSE) runs while dP
//   finishes, dS = P (dP - delta) is packed to bf16 in registers and is
//   the A operand of dQ += dS K (m64nNk16, K MN-major). LSE and delta of a
//   thread's two rows stay in registers. Registers at D = 128: S 32, dP
//   32, dQ 64, dS 16.
// - dk/dv: one CTA per (kv tile of 64 keys, kv head, batch), kv tile 0
//   (the longest causal q loop) first; K and V stay, (Q_i, dO_i, LSE_i,
//   delta_i) of every (q tile i, group member g) stream, so the GQA sum
//   is inside the CTA in a fixed order. Products in transposed space
//   (rows keys): dK and dV together (128 fp32 registers a thread at D =
//   128) beside S^T and dP^T would not fit the 168 registers ptxas
//   allocates a 384-thread kernel, so the two consumer warpgroups work on
//   the same 64 keys split by output. Warpgroup 0: S^T = K Q_i^T, P^T, dV
//   += P^T dO_i; warpgroup 1: dP^T = V dO_i^T, dS^T, dK += dS^T Q_i. P^T
//   goes from 0 to 1 in fp32 through two shared-memory buffers with full
//   and empty mbarriers (the m64n64 fragments map threads alike, so
//   thread t reads what thread t wrote); each warpgroup issues two of the
//   four products. Two variants measured slower on the card and were not
//   kept: K4's overlap inside each warpgroup (the next step's first
//   product issued with this step's second), and warpgroup 1 recomputing
//   S^T instead of receiving P^T.
// - dk/dv with a GQA group G of 2, 4 or 8: a thread-block cluster of G
//   CTAs shares one (kv tile, kv head), CTA r walking group member r only
//   (at llama-8b, 512 CTAs of at most 16 steps instead of 128 of at most
//   64, under one wave). Each CTA leaves its fp32 dK and dV partials in
//   its own shared memory, and CTA r sums rows [64r/G, 64(r+1)/G) of all
//   G partials in the order 0..G-1 through distributed shared memory:
//   deterministic, with no atomics and no global workspace. Other groups
//   (1 at ViT-B/16) keep the whole group in one CTA.
// - Tiles: 64 keys at every head dim (the plain versions' block); the
//   swizzle per D is the forward's. Shared memory at D = 128: dq Q 32 KB
//   + dO 32 + 3 x (K 16 + V 16) = 160 KB; dk/dv K 16 + V 16 + 3 x (Q 16 +
//   dO 16) + P 32 = 160 KB, the partials over the Q/dO ring.
//
// fp32 keeps the first design's scalar kernels (flash_bwd_dq_kernel,
// flash_bwd_dkdv_kernel): the tensor cores have no full-fp32 mode and
// fp32 lies on no main path. 64 x 64 tiles in shared memory, scalar FMA
// products, the dk/dv accumulators in registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

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
  int vec;  // q/k/v/dO are TMA-able (kernels/flash.py:tma_eligible)
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Shared-memory layout of one fp32 block of either kernel. Input rows
// are padded by one element (the scalar products read rows across a
// half-warp, and an odd pitch puts them in distinct banks); P and dS
// overwrite S and dP in place, and the dk/dv accumulators live in
// registers, which keeps D=128 under the 227 KB.
template <typename T, int D>
struct Layout {
  static_assert(sizeof(T) == 4, "the scalar kernels are fp32 only");
  static constexpr int LDT = D + 1;   // q, k, v, dO tiles
  static constexpr int LDS = BK + 4;  // S, dP tiles
  static constexpr int LDP = LDS;     // P, dS tiles (in place)
  static constexpr int LDA = D + 4;   // the dq accumulator
  static constexpr size_t tile = align128(sizeof(T) * 64 * LDT);
  static constexpr size_t t0 = 0;
  static constexpr size_t t1 = t0 + tile;
  static constexpr size_t t2 = t1 + tile;
  static constexpr size_t t3 = t2 + tile;
  static constexpr size_t s_off = t3 + tile;
  static constexpr size_t dp_off = align128(s_off + sizeof(float) * 64 * LDS);
  static constexpr size_t sdp_end = align128(dp_off + sizeof(float) * 64 * LDS);
  static constexpr size_t p_off = s_off;
  static constexpr size_t ds_off = dp_off;
  static constexpr size_t row_off = sdp_end;  // lse[64], delta[64]
  static constexpr size_t acc_off = align128(row_off + sizeof(float) * 128);
  static constexpr size_t acc = align128(sizeof(float) * 64 * LDA);
  static constexpr size_t dq_bytes = acc_off + acc;
  static constexpr size_t dkdv_bytes = acc_off;
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
    nt_scalar<D>(Qs, Ks, Ss);
    nt_scalar<D>(dOs, Vs, dPs);
    __syncthreads();
    if (edge) {
      grad_tile<T, D, false, true, false>(Ss, dPs, nullptr, dSs, lse_s,
                                          delta_s, i0, j0, p);
    } else {
      grad_tile<T, D, false, false, false>(Ss, dPs, nullptr, dSs, lse_s,
                                           delta_s, i0, j0, p);
    }
    __syncthreads();
    nn_scalar_smem<D>(dSs, Ks, dQ);
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
  float dk_r[8][NC];  // the accumulators in registers
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
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk_r[i][c] = 0.f;
      dv_r[i][c] = 0.f;
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
      nt_scalar<D>(Ks, Qs, Ss);
      nt_scalar<D>(Vs, dOs, dPs);
      __syncthreads();
      if (edge) {
        grad_tile<T, D, true, true, true>(Ss, dPs, Ps, dSs, lse_s, delta_s,
                                          i0, j0, p);
      } else {
        grad_tile<T, D, true, false, true>(Ss, dPs, Ps, dSs, lse_s, delta_s,
                                           i0, j0, p);
      }
      __syncthreads();
      nn_scalar<D>(Ps, dOs, dv_r);
      nn_scalar<D>(dSs, Qs, dk_r);
    }
  }
  __syncthreads();

  // emit in k's dtype; keys past Skv are not written
  const long long base = (static_cast<long long>(b) * p.Hkv + hk) * p.Skv * D;
  T* dkg = static_cast<T*>(p.out0) + base;
  T* dvg = static_cast<T*>(p.out1) + base;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (r < kv_valid) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const long long off = static_cast<long long>(j0 + r) * D + tx + 16 * c;
        dkg[off] = from_f<T>(dk_r[i][c]);
        dvg[off] = from_f<T>(dv_r[i][c]);
      }
    }
  }
}

// ============================================================================
// bf16: the Hopper design (TMA producer, wgmma consumers)
// ============================================================================

namespace tc {

using namespace hopper;

constexpr int STAGES = 3;         // ring depth
constexpr int THREADS = 384;      // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int DQ_ROWS = 128;      // query rows of a dq CTA
constexpr float L2E = 1.4426950408889634f;
// whether query `query` sees key `key`
__device__ __forceinline__ bool visible(int key, int query, const Params& p) {
  bool vis = key < p.Skv;
  if (p.causal) vis = vis && key <= query;
  if (p.window > 0) vis = vis && key >= query - (p.window - 1);
  return vis;
}

// ---- dq ------------------------------------------------------------------------

// Shared-memory layout of one dq CTA at head dim D: Q and dO of its 128
// rows, a ring of K and V tiles.
template <int D>
struct DqTile : Swz<D> {
  static constexpr uint32_t q_bytes = DQ_ROWS * D * 2;
  static constexpr uint32_t kv_bytes = BK * D * 2;
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t do_off = q_bytes;
  static constexpr uint32_t k_off = 2 * q_bytes;
  static constexpr uint32_t v_off = k_off + STAGES * kv_bytes;
  static constexpr uint32_t bar_off = v_off + STAGES * kv_bytes;
  // barriers: q_full (Q and dO), full_k[STAGES], full_v[STAGES],
  // empty[STAGES]
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 3 * STAGES);
  static constexpr uint32_t alloc = bytes + 1024;  // room to align the base
  static_assert(q_bytes % 1024 == 0 && kv_bytes % 1024 == 0,
                "tiles must keep the 1024-byte swizzle period");
  static_assert(alloc <= kMaxSmem, "dq layout over 227 KB");
};

// Q and dO once, then K_j and V_j of kv tiles [jb, je) into the ring.
// With TMA one thread issues every load; otherwise the warpgroup loads and
// each of its threads arrives.
template <int D>
__device__ __forceinline__ void dq_produce(
    const CUtensorMap* tq, const CUtensorMap* tdo, const CUtensorMap* tk,
    const CUtensorMap* tv, const Params& p, unsigned char* smem,
    uint32_t base, int i0, int h, int hk, int b, int jb, int je, int tid) {
  using T = DqTile<D>;
  const uint32_t q_full = base + T::bar_off;
  auto full_k = [&](int s) { return q_full + 8 * (1 + s); };
  auto full_v = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * STAGES + s); };
  auto k_tile = [&](int s) { return T::k_off + s * T::kv_bytes; };
  auto v_tile = [&](int s) { return T::v_off + s * T::kv_bytes; };
  if (p.vec) {
    if (tid != 0) return;
    mbar_expect_tx(q_full, 2 * T::q_bytes);
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) {
      tma_load_4d(base + T::q_off + c * DQ_ROWS * T::SW, tq, q_full,
                  c * T::CW, i0, h, b);
      tma_load_4d(base + T::do_off + c * DQ_ROWS * T::SW, tdo, q_full,
                  c * T::CW, i0, h, b);
    }
    for (int j = jb, t = 0; j < je; ++j, ++t) {
      const int s = t % STAGES;
      mbar_wait(empty(s), ((t / STAGES) & 1) ^ 1);
      mbar_expect_tx(full_k(s), T::kv_bytes);
#pragma unroll
      for (int c = 0; c < T::NCH; ++c) {
        tma_load_4d(base + k_tile(s) + c * BK * T::SW, tk, full_k(s),
                    c * T::CW, j * BK, hk, b);
      }
      mbar_expect_tx(full_v(s), T::kv_bytes);
#pragma unroll
      for (int c = 0; c < T::NCH; ++c) {
        tma_load_4d(base + v_tile(s) + c * BK * T::SW, tv, full_v(s),
                    c * T::CW, j * BK, hk, b);
      }
    }
    return;
  }
  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* dog =
      static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_plain<D>(smem, T::q_off, qg, p.q_ss, i0, p.S, DQ_ROWS, tid);
  load_plain<D>(smem, T::do_off, dog, p.do_ss, i0, p.S, DQ_ROWS, tid);
  mbar_arrive(q_full);
  for (int j = jb, t = 0; j < je; ++j, ++t) {
    const int s = t % STAGES;
    mbar_wait(empty(s), ((t / STAGES) & 1) ^ 1);
    load_plain<D>(smem, k_tile(s), kg, p.k_ss, j * BK, p.Skv, BK, tid);
    mbar_arrive(full_k(s));
    load_plain<D>(smem, v_tile(s), vg, p.v_ss, j * BK, p.Skv, BK, tid);
    mbar_arrive(full_v(s));
  }
}

// P = exp(S - LSE) on the score fragment of a tile at key j0, in place,
// with the compares only where MASK (an edge tile). Fragment layout of an
// m64nN accumulator: thread `lane` of warp `warp` holds rows 16*warp +
// lane/4 (h = 0) and +8 (h = 1) of the warpgroup's 64, and in each n8
// block i the columns 8i + 2(lane%4) and +1; element e of the array is
// block e/4, row h = (e/2)%2, column offset e%2. nlse is -LSE * log2(e)
// of the thread's two rows; masked entries give exactly 0.
template <bool MASK>
__device__ __forceinline__ void dq_probs(float (&s)[32], int row0, int j0,
                                         int lane, const float (&nlse)[2],
                                         const Params& p) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int hh = (e >> 1) & 1;
    if (MASK) {
      const int key = j0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      if (!visible(key, row0 + 8 * hh, p)) s[e] = -INFINITY;
    }
    s[e] = ex2(fmaf(s[e], L2E, nlse[hh]));
  }
}

// A consumer warpgroup of the dq kernel: 64 query rows over kv tiles
// [jb, je). Per tile: S = Q K^T and dP = dO V^T in flight together, P
// while dP finishes, dS = P (dP - delta) packed to bf16 in registers as
// the A operand of dQ += dS K (K MN-major), dQ an fp32 register
// accumulator for the CTA's whole life.
template <int D>
__device__ __forceinline__ void dq_consume(const Params& p, uint32_t base,
                                           int i0, int h, int b, int jb,
                                           int je, int w, int wt) {
  using T = DqTile<D>;
  constexpr int NO = T::CW / 2;  // dQ floats a chunk
  const int warp = wt / 32;
  const int lane = wt % 32;
  const int i0w = i0 + 64 * w;
  const int row0 = i0w + 16 * warp + lane / 4;
  const uint32_t bars = base + T::bar_off;
  // LSE and delta of the thread's two rows; rows past S get LSE +1e30 and
  // delta 0, so their P and dS are exactly 0
  float nlse[2], dlt[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + 8 * hh;
    const long long off = (static_cast<long long>(b) * p.H + h) * p.S + r;
    nlse[hh] = -(r < p.S ? p.lse[off] : 1e30f) * L2E;
    dlt[hh] = r < p.S ? p.delta[off] : 0.f;
  }
  float dq[T::NCH][NO];
#pragma unroll
  for (int c = 0; c < T::NCH; ++c)
#pragma unroll
    for (int e = 0; e < NO; ++e) dq[c][e] = 0.f;
  mbar_wait(bars, 0);

  const int n = je - jb;
  for (int t = 0; t < n; ++t) {
    const int st = t % STAGES;
    const uint32_t ph = (t / STAGES) & 1;
    const uint32_t kt = base + T::k_off + st * T::kv_bytes;
    const uint32_t vt = base + T::v_off + st * T::kv_bytes;
    // opaque on every tile, so the compiler derives the k-steps from one
    // register pair here instead of holding all of them across the loop
    uint64_t dqd = make_desc<D>(base + T::q_off + 64 * w * T::SW);
    uint64_t ddo = make_desc<D>(base + T::do_off + 64 * w * T::SW);
    asm volatile("" : "+l"(dqd));
    asm volatile("" : "+l"(ddo));
    const uint64_t dkd = make_desc<D>(kt);
    const uint64_t dvd = make_desc<D>(vt);
    float s[32], dp[32];
    mbar_wait(bars + 8 * (1 + st), ph);
    wgmma_fence();
    wgmma_ss_n64_first(s, dqd, dkd);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) {
      wgmma_ss_n64(s, dqd + kstep<D>(DQ_ROWS, kk), dkd + kstep<D>(BK, kk));
    }
    wgmma_commit();
    mbar_wait(bars + 8 * (1 + STAGES + st), ph);
    wgmma_ss_n64_first(dp, ddo, dvd);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) {
      wgmma_ss_n64(dp, ddo + kstep<D>(DQ_ROWS, kk), dvd + kstep<D>(BK, kk));
    }
    wgmma_commit();
    fence_regs(s);
    fence_regs(dp);
    wgmma_wait<1>();  // the scores, issued first
    fence_regs(s);
    const int j0 = (jb + t) * BK;
    const bool edge = (j0 + BK > p.Skv) || (p.causal && j0 + BK - 1 > i0w) ||
                      (p.window > 0 && j0 < i0w + 63 - (p.window - 1));
    if (edge) {
      dq_probs<true>(s, row0, j0, lane, nlse, p);
    } else {
      dq_probs<false>(s, row0, j0, lane, nlse, p);
    }
    wgmma_wait<0>();
    fence_regs(dp);
    // dS rounded to bf16: the A fragments of dQ += dS K, in the
    // accumulator's layout, 16 keys at a time
    uint32_t ds[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = 8 * kk + 2 * q;
        const float d = dlt[(e >> 1) & 1];
        ds[kk][q] = pack_bf16(s[e] * (dp[e] - d), s[e + 1] * (dp[e + 1] - d));
      }
      fence_regs(ds[kk]);
    }
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) fence_regs(dq[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
        wgmma_rs(dq[c], ds[kk], v_desc<D>(kt, kk, c));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) fence_regs(dq[c]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(ds[kk]);
    if (lane == 0) mbar_arrive(bars + 8 * (1 + 2 * STAGES + st));
  }

  // dq in bf16, then scaled in fp32 and rounded again; rows past S are
  // not written
  bf16* dqg = static_cast<bf16*>(p.out0) +
              (static_cast<long long>(b) * p.H + h) * p.S * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= p.S) continue;
    bf16* orow = dqg + static_cast<long long>(row) * D;
#pragma unroll
    for (int c = 0; c < T::NCH; ++c)
#pragma unroll
      for (int i = 0; i < T::CW / 8; ++i) {
        const int e = 4 * i + 2 * hh;
        const float x0 = __bfloat162float(__float2bfloat16_rn(dq[c][e]));
        const float x1 = __bfloat162float(__float2bfloat16_rn(dq[c][e + 1]));
        *reinterpret_cast<__nv_bfloat162*>(
            orow + c * T::CW + 8 * i + 2 * (lane & 3)) =
            __floats2bfloat162_rn(x0 * p.scale, x1 * p.scale);
      }
  }
}

// K2, bf16: one CTA per (128-row q tile, head, batch)
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ Params p) {
  using T = DqTile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  // the q tile is the grid's slowest axis, the last (longest causal) first
  const int i0 = (gridDim.z - 1 - blockIdx.z) * DQ_ROWS;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (p.H / p.Hkv);
  // kv tiles this q tile can see: [jb, je)
  const int n_kv = (p.Skv + BK - 1) / BK;
  const int je = p.causal ? min(n_kv, (i0 + DQ_ROWS - 1) / BK + 1) : n_kv;
  const int jb = p.window > 0 ? max(i0 - (p.window - 1), 0) / BK : 0;
  if (tid == 0) {
    const uint32_t fill = p.vec ? 1 : WG;  // TMA: one arrival and the bytes
    const uint32_t bars = base + T::bar_off;
    mbar_init(bars, fill);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * (1 + s), fill);
      mbar_init(bars + 8 * (1 + STAGES + s), fill);
      mbar_init(bars + 8 * (1 + 2 * STAGES + s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup index, broadcast so the compiler sees it warp-uniform
  // (otherwise it serialises every wgmma under the branch below)
  const int role = __shfl_sync(0xffffffffu, tid / WG, 0);
  // one if/else for the kernel's whole life, so setmaxnreg applies
  if (role == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    dq_produce<D>(&tq, &tdo, &tk, &tv, p, smem, base, i0, h, hk, b, jb, je,
                  tid);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    dq_consume<D>(p, base, i0, h, b, jb, je, role - 1, tid % WG);
  }
}

// ---- dk/dv ---------------------------------------------------------------------

// Shared-memory layout of one dk/dv CTA at head dim D: its K and V tiles,
// a ring of (Q_i, dO_i) tiles with the LSE and delta of their 64 rows,
// and two fp32 buffers through which the P^T warpgroup hands P^T to the
// dS^T warpgroup, each with a full and an empty mbarrier (every thread of
// the writing or reading warpgroup arrives).
template <int D>
struct DkvTile : Swz<D> {
  static constexpr uint32_t tile = BK * D * 2;  // 64 rows, BQ == BK
  static constexpr uint32_t k_off = 0;
  static constexpr uint32_t v_off = tile;
  static constexpr uint32_t q_off = 2 * tile;                // + stage * tile
  static constexpr uint32_t do_off = q_off + STAGES * tile;  // + stage * tile
  static constexpr uint32_t p_bytes = BK * BQ * 4;
  static constexpr uint32_t p_off = do_off + STAGES * tile;  // + buf * p_bytes
  static constexpr uint32_t row_bytes = 2 * BQ * 4;          // lse, delta
  static constexpr uint32_t row_off = p_off + 2 * p_bytes;   // + stage * ...
  static constexpr uint32_t bar_off = row_off + STAGES * row_bytes;
  // barriers: kv_full (K and V), full[STAGES], empty[STAGES], and the
  // P^T hand-off's p_full[2], p_empty[2]
  static constexpr uint32_t p_full = 8 * (1 + 2 * STAGES);
  static constexpr uint32_t p_empty = p_full + 16;
  static constexpr uint32_t bytes = bar_off + p_empty + 16;
  static constexpr uint32_t alloc = bytes + 1024;  // room to align the base
  // with a cluster, the fp32 dV (w = 0) and dK (w = 1) partials of the
  // CTA's 64 keys, rows padded by 4 floats, over the (then idle) ring
  static constexpr int PITCH = D + 4;
  static constexpr uint32_t part_off = q_off;
  static constexpr uint32_t part_bytes = BK * PITCH * 4;
  static_assert(2 * part_bytes <= 2 * STAGES * tile, "partials over the ring");
  static_assert(BQ == BK, "q and kv tiles share the tile layout");
  static_assert(tile % 1024 == 0, "tiles must keep the swizzle period");
  static_assert(alloc <= kMaxSmem, "dk/dv layout over 227 KB");
};

// LSE and delta of query rows i0..i0+63 of head h into stage s, read by
// `loaders` threads with guarded loads: rows past S get LSE +1e30 and
// delta 0
template <int D>
__device__ __forceinline__ void dkdv_rows(unsigned char* smem, int s,
                                          const Params& p, int b, int h,
                                          int i0, int tid, int loaders) {
  using T = DkvTile<D>;
  float* r = reinterpret_cast<float*>(smem + T::row_off + s * T::row_bytes);
  for (int idx = tid; idx < 2 * BQ; idx += loaders) {
    const int row = i0 + idx % BQ;
    const long long off = (static_cast<long long>(b) * p.H + h) * p.S + row;
    if (idx < BQ) {
      r[idx] = row < p.S ? p.lse[off] : 1e30f;
    } else {
      r[idx] = row < p.S ? p.delta[off] : 0.f;
    }
  }
}

// K and V once, then (Q_i, dO_i, LSE_i, delta_i) of the n = (ie - ib) * gp
// steps t (q tile ib + t / gp, query head h0 + t % gp) into the ring.
// LSE and delta are read with guarded loads (rows past S get +1e30 and 0)
// by the producer's first warp, or its whole warpgroup when TMA cannot
// read the tiles; every loading thread arrives on the stage's barrier.
template <int D>
__device__ __forceinline__ void dkdv_produce(
    const CUtensorMap* tq, const CUtensorMap* tdo, const CUtensorMap* tk,
    const CUtensorMap* tv, const Params& p, unsigned char* smem,
    uint32_t base, int j0, int hk, int h0, int b, int ib, int n, int gp,
    int tid) {
  using T = DkvTile<D>;
  const uint32_t kv_full = base + T::bar_off;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + STAGES + s); };
  const int loaders = p.vec ? 32 : WG;
  if (tid >= loaders) return;
  if (p.vec) {
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * T::tile);
#pragma unroll
      for (int c = 0; c < T::NCH; ++c) {
        tma_load_4d(base + T::k_off + c * BK * T::SW, tk, kv_full, c * T::CW,
                    j0, hk, b);
        tma_load_4d(base + T::v_off + c * BK * T::SW, tv, kv_full, c * T::CW,
                    j0, hk, b);
      }
    }
    for (int t = 0; t < n; ++t) {
      const int s = t % STAGES;
      const int i0 = (ib + t / gp) * BQ;
      const int h = h0 + t % gp;
      mbar_wait(empty(s), ((t / STAGES) & 1) ^ 1);
      dkdv_rows<D>(smem, s, p, b, h, i0, tid, loaders);
      if (tid == 0) {
        mbar_expect_tx(full(s), 2 * T::tile);
#pragma unroll
        for (int c = 0; c < T::NCH; ++c) {
          tma_load_4d(base + T::q_off + s * T::tile + c * BQ * T::SW, tq,
                      full(s), c * T::CW, i0, h, b);
          tma_load_4d(base + T::do_off + s * T::tile + c * BQ * T::SW, tdo,
                      full(s), c * T::CW, i0, h, b);
        }
      } else {
        mbar_arrive(full(s));
      }
    }
    return;
  }
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_plain<D>(smem, T::k_off, kg, p.k_ss, j0, p.Skv, BK, tid);
  load_plain<D>(smem, T::v_off, vg, p.v_ss, j0, p.Skv, BK, tid);
  mbar_arrive(kv_full);
  for (int t = 0; t < n; ++t) {
    const int s = t % STAGES;
    const int i0 = (ib + t / gp) * BQ;
    const int h = h0 + t % gp;
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* dog =
        static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    mbar_wait(empty(s), ((t / STAGES) & 1) ^ 1);
    load_plain<D>(smem, T::q_off + s * T::tile, qg, p.q_ss, i0, p.S, BQ,
                  tid);
    load_plain<D>(smem, T::do_off + s * T::tile, dog, p.do_ss, i0, p.S, BQ,
                  tid);
    dkdv_rows<D>(smem, s, p, b, h, i0, tid, loaders);
    mbar_arrive(full(s));
  }
}

// The two consumer warpgroups of the dk/dv kernel work on the same 64
// keys, split by output, in transposed space (rows keys, columns the q
// tile's 64 queries):
// - w = 0: S^T = K Q_i^T, P^T = exp(S^T - LSE) in fp32, handed to w = 1
//   through a shared-memory buffer, then rounded to bf16 as the A operand
//   of dV += P^T dO_i (dO_i MN-major);
// - w = 1: dP^T = V dO_i^T, dS^T = P^T (dP^T - delta) rounded to bf16 as
//   the A operand of dK += dS^T Q_i (Q_i MN-major).
// The two m64n64 fragments have the same thread mapping, so thread t
// reads P^T where thread t wrote it. LSE and delta vary along the
// columns: each thread reads its 16 columns' values per step.
template <int D>
__device__ __forceinline__ void dkdv_consume(const Params& p,
                                             unsigned char* smem,
                                             uint32_t base, int j0, int hk,
                                             int b, int ib, int n, int gp,
                                             int cl, int w, int wt) {
  using T = DkvTile<D>;
  constexpr int NO = T::CW / 2;  // accumulator floats a chunk
  const int warp = wt / 32;
  const int lane = wt % 32;
  const int key0 = j0 + 16 * warp + lane / 4;  // fragment row h = 0
  const uint32_t bars = base + T::bar_off;
  float acc[T::NCH][NO];  // dV (w = 0) or dK (w = 1)
#pragma unroll
  for (int c = 0; c < T::NCH; ++c)
#pragma unroll
    for (int e = 0; e < NO; ++e) acc[c][e] = 0.f;
  mbar_wait(bars, 0);  // K and V

  for (int t = 0; t < n; ++t) {
    const int st = t % STAGES;
    const uint32_t ph = (t / STAGES) & 1;
    const int i0 = (ib + t / gp) * BQ;
    const uint32_t qt = base + T::q_off + st * T::tile;
    const uint32_t dot = base + T::do_off + st * T::tile;
    uint64_t da = make_desc<D>(base + (w == 0 ? T::k_off : T::v_off));
    asm volatile("" : "+l"(da));
    const uint64_t db = make_desc<D>(w == 0 ? qt : dot);
    float x[32];  // S^T (w = 0) or dP^T (w = 1)
    mbar_wait(bars + 8 * (1 + st), ph);
    wgmma_fence();
    wgmma_ss_n64_first(x, da, db);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) {
      wgmma_ss_n64(x, da + kstep<D>(BK, kk), db + kstep<D>(BQ, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(x);
    // this step's column values: LSE (w = 0) or delta (w = 1) of queries
    // 8i + 2(lane%4) and +1
    const float* cv = reinterpret_cast<const float*>(
                          smem + T::row_off + st * T::row_bytes) +
                      w * BQ + 2 * (lane & 3);
    float col[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 v2 = *reinterpret_cast<const float2*>(cv + 8 * i);
      col[2 * i] = v2.x;
      col[2 * i + 1] = v2.y;
    }
    const int buf = t & 1;
    float* pb = reinterpret_cast<float*>(smem + T::p_off + buf * T::p_bytes) +
                wt;
    uint32_t a[BK / 16][4];  // P^T or dS^T in bf16, the A fragments
    if (w == 0) {
      const bool edge =
          (p.causal && j0 + BK - 1 > i0) ||
          (p.window > 0 && j0 < i0 + BQ - 1 - (p.window - 1));
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int ci = 2 * (e >> 2) + (e & 1);
        if (edge) {
          const int query = i0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
          if (!visible(key0 + 8 * ((e >> 1) & 1), query, p)) x[e] = -INFINITY;
        }
        // masked entries and padded query rows give exactly 0
        x[e] = ex2(fmaf(x[e], L2E, -col[ci] * L2E));
      }
      // buffer `buf` was last read at step t - 2 (a fresh barrier passes
      // the wait of the first two steps)
      mbar_wait(bars + T::p_empty + 8 * buf, ((t >> 1) & 1) ^ 1);
#pragma unroll
      for (int e = 0; e < 32; ++e) pb[e * WG] = x[e];
      mbar_arrive(bars + T::p_full + 8 * buf);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a[kk][q] = pack_bf16(x[8 * kk + 2 * q], x[8 * kk + 2 * q + 1]);
    } else {
      mbar_wait(bars + T::p_full + 8 * buf, (t >> 1) & 1);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = 8 * kk + 2 * q;
          const int ci = 2 * (e >> 2);
          a[kk][q] = pack_bf16(pb[e * WG] * (x[e] - col[ci]),
                               pb[(e + 1) * WG] * (x[e + 1] - col[ci + 1]));
        }
      mbar_arrive(bars + T::p_empty + 8 * buf);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(a[kk]);
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) fence_regs(acc[c]);
    const uint32_t bt = w == 0 ? dot : qt;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
        wgmma_rs(acc[c], a[kk], v_desc<D>(bt, kk, c, BQ));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) fence_regs(acc[c]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(a[kk]);
    if (lane == 0) mbar_arrive(bars + 8 * (1 + STAGES + st));
  }
  if (cl > 1) {
    // the partial sums of this CTA's group members, for dkdv_reduce();
    // both warpgroups are done with the ring first
    named_barrier(1, 2 * WG);
    float* part = reinterpret_cast<float*>(smem + T::part_off +
                                           w * T::part_bytes);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* prow = part + (16 * warp + lane / 4 + 8 * hh) * T::PITCH;
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
#pragma unroll
        for (int i = 0; i < T::CW / 8; ++i) {
          const int e = 4 * i + 2 * hh;
          *reinterpret_cast<float2*>(prow + c * T::CW + 8 * i +
                                     2 * (lane & 3)) =
              make_float2(acc[c][e], acc[c][e + 1]);
        }
    }
    return;
  }
  // emit in bf16; keys past Skv are not written
  bf16* outg = static_cast<bf16*>(w == 0 ? p.out1 : p.out0) +
               (static_cast<long long>(b) * p.Hkv + hk) * p.Skv * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = key0 + 8 * hh;
    if (key >= p.Skv) continue;
    bf16* orow = outg + static_cast<long long>(key) * D;
#pragma unroll
    for (int c = 0; c < T::NCH; ++c)
#pragma unroll
      for (int i = 0; i < T::CW / 8; ++i) {
        const int e = 4 * i + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(
            orow + c * T::CW + 8 * i + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[c][e], acc[c][e + 1]);
      }
  }
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// every thread of the cluster: writes before it are seen after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The cluster's sum of the dV and dK partials: CTA r of cl owns keys
// [r * 64 / cl, (r + 1) * 64 / cl) of the tile and adds, for each, the
// partials of CTAs 0, 1, ..., cl - 1 in that order (distributed shared
// memory), so every element is summed in one fixed order with no
// atomics; keys past Skv are not written. Called by the consumer
// warpgroups (ct: 0..255) between two cluster barriers.
template <int D>
__device__ __forceinline__ void dkdv_reduce(const Params& p,
                                            unsigned char* smem, int j0,
                                            int hk, int b, int r, int cl,
                                            int ct) {
  using T = DkvTile<D>;
  const int rows = BK / cl;
  const int per = rows * D / 4;  // float4s of one tensor
  const uint32_t local = smem_u32(smem + T::part_off);
  const long long base =
      (static_cast<long long>(b) * p.Hkv + hk) * p.Skv * D;
  for (int idx = ct; idx < 2 * per; idx += 2 * WG) {
    const int w = idx / per;  // 0: dV, 1: dK
    const int rem = idx % per;
    const int row = r * rows + rem / (D / 4);
    const int col = 4 * (rem % (D / 4));
    if (j0 + row >= p.Skv) continue;
    const uint32_t off = w * T::part_bytes + (row * T::PITCH + col) * 4;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int src = 0; src < cl; ++src) {
      uint32_t remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(remote)
                   : "r"(local + off), "r"(src));
      float v[4];
      asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                   : "r"(remote)
                   : "memory");
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e] += v[e];
    }
    bf16* out = static_cast<bf16*>(w == 0 ? p.out1 : p.out0) + base +
                static_cast<long long>(j0 + row) * D + col;
    reinterpret_cast<__nv_bfloat162*>(out)[0] =
        __floats2bfloat162_rn(sum[0], sum[1]);
    reinterpret_cast<__nv_bfloat162*>(out)[1] =
        __floats2bfloat162_rn(sum[2], sum[3]);
  }
}

// K3, bf16: one CTA per (kv tile, kv head, batch), or a cluster of cl
// CTAs that split the GQA group and sum their partials (dkdv_reduce)
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ Params p) {
  using T = DkvTile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  // the kv tile is the grid's slowest axis, tile 0 (the longest causal q
  // loop) first
  const int j0 = blockIdx.z * BK;
  // a cluster of cl CTAs along x shares one (kv tile, kv head); CTA r
  // walks group members [r * gp, (r + 1) * gp)
  const int cl = cluster_nctarank();
  const int r = cluster_ctarank();
  const int hk = blockIdx.x / cl;
  const int b = blockIdx.y;
  const int G = p.H / p.Hkv;
  const int gp = G / cl;
  // q tiles that see this kv tile: [ib, ie), each for gp query heads
  const int n_q = (p.S + BQ - 1) / BQ;
  const int ib = p.causal ? j0 / BQ : 0;
  const int ie =
      p.window > 0 ? min(n_q, (j0 + BK + p.window - 2) / BQ + 1) : n_q;
  const int n = max(ie - ib, 0) * gp;
  if (tid == 0) {
    const uint32_t bars = base + T::bar_off;
    mbar_init(bars, p.vec ? 1 : WG);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * (1 + s), p.vec ? 32 : WG);
      mbar_init(bars + 8 * (1 + STAGES + s), CONSUMER_WARPS);
    }
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(bars + T::p_full + 8 * buf, WG);
      mbar_init(bars + T::p_empty + 8 * buf, WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int role = __shfl_sync(0xffffffffu, tid / WG, 0);
  // the producer walks (q tile, group member) and loads rows itself: at
  // 40 or 56 registers it spills, at 72 it does not (128 * 72 + 256 * 216
  // = 64,512, the 168 x 384 the launch allocates)
  if (role == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    dkdv_produce<D>(&tq, &tdo, &tk, &tv, p, smem, base, j0, hk,
                    hk * G + r * gp, b, ib, n, gp, tid);
    if (cl > 1) {
      cluster_sync();  // the partials are written
      cluster_sync();  // and read
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
    dkdv_consume<D>(p, smem, base, j0, hk, b, ib, n, gp, cl, role - 1,
                    tid % WG);
    if (cl > 1) {
      cluster_sync();
      dkdv_reduce<D>(p, smem, j0, hk, b, r, cl, tid - WG);
      cluster_sync();  // no CTA leaves while another reads its partials
    }
  }
}

}  // namespace tc

// ============================================================================
// host: tensor maps, launches, dispatch
// ============================================================================

constexpr int ERR_UNSUPPORTED = -1;  // a (kernel, dtype, head_dim) not built
constexpr int ERR_TENSOR_MAP = -2;   // the CUDA driver refused a tensor map

template <int D>
int launch_tc(int kernel, Params p, cudaStream_t stream) {
  CUtensorMap maps[4];  // q, dO, k, v
  memset(maps, 0, sizeof(maps));
  const int q_rows = kernel == 0 ? tc::DQ_ROWS : BQ;
  if (p.vec) {
    const bool ok =
        hopper::encode_map<D>(&maps[0], p.q, p.S, p.H, p.B, p.q_ss, p.q_sh,
                              p.q_sb, q_rows) &&
        hopper::encode_map<D>(&maps[1], p.dout, p.S, p.H, p.B, p.do_ss,
                              p.do_sh, p.do_sb, q_rows) &&
        hopper::encode_map<D>(&maps[2], p.k, p.Skv, p.Hkv, p.B, p.k_ss,
                              p.k_sh, p.k_sb, BK) &&
        hopper::encode_map<D>(&maps[3], p.v, p.Skv, p.Hkv, p.B, p.v_ss,
                              p.v_sh, p.v_sb, BK);
    if (!ok) return ERR_TENSOR_MAP;
  }
  cudaError_t err;
  if (kernel == 0) {
    using T = tc::DqTile<D>;
    err = cudaFuncSetAttribute(tc::flash_bwd_dq_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(T::alloc));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(p.H, p.B, (p.S + tc::DQ_ROWS - 1) / tc::DQ_ROWS);
    tc::flash_bwd_dq_tc_kernel<D><<<grid, tc::THREADS, T::alloc, stream>>>(
        maps[0], maps[1], maps[2], maps[3], p);
  } else {
    using T = tc::DkvTile<D>;
    err = cudaFuncSetAttribute(tc::flash_bwd_dkdv_tc_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(T::alloc));
    if (err != cudaSuccess) return static_cast<int>(err);
    // split the GQA group over a cluster of G CTAs where it is 2, 4 or
    // 8 (at most 8 CTAs are portable); other groups stay in one CTA
    const int G = p.H / p.Hkv;
    const int cl = G == 2 || G == 4 || G == 8 ? G : 1;
    dim3 grid(p.Hkv * cl, p.B, (p.Skv + BK - 1) / BK);
    if (cl == 1) {
      tc::flash_bwd_dkdv_tc_kernel<D>
          <<<grid, tc::THREADS, T::alloc, stream>>>(maps[0], maps[1],
                                                     maps[2], maps[3], p);
    } else {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = grid;
      cfg.blockDim = dim3(tc::THREADS);
      cfg.dynamicSmemBytes = T::alloc;
      cfg.stream = stream;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = cl;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelEx(&cfg, tc::flash_bwd_dkdv_tc_kernel<D>,
                               maps[0], maps[1], maps[2], maps[3], p);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// fp32: the scalar kernels
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

// the design by dtype: 1 = bf16 (Hopper), 0 = fp32 (scalar)
template <int D>
int launch_d(int kernel, int dtype, const Params& p, cudaStream_t stream) {
  if (dtype == 1) return launch_tc<D>(kernel, p, stream);
  if (dtype == 0) return launch<float, D>(kernel, p, stream);
  return ERR_UNSUPPORTED;
}

}  // namespace

extern "C" {

// kernel: 0 = dq (out0 = dq), 1 = dk/dv (out0 = dk, out1 = dv).
// dtype: 0 = fp32, 1 = bf16. Strides are in elements; the last dimension
// of q, k, v and dout must be contiguous; lse, delta and the outputs are
// contiguous; vec = 1 when q, k, v and dout are TMA-able
// (kernels/flash.py:tma_eligible). Returns 0, a cudaError_t value, -1 for
// a (kernel, dtype, head_dim) this library was not built for, or -2 when
// the CUDA driver refused a tensor map.
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
  if (kernel != 0 && kernel != 1) return ERR_UNSUPPORTED;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{q,     k,     v,     dout,  lse,   delta, out0,   out1,
           B,     H,     Hkv,   S,     Skv,   q_sb,  q_sh,   q_ss,
           k_sb,  k_sh,  k_ss,  v_sb,  v_sh,  v_ss,  do_sb,  do_sh,
           do_ss, causal, window, scale, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_d<16>(kernel, dtype, p, s);
    case 32: return launch_d<32>(kernel, dtype, p, s);
    case 64: return launch_d<64>(kernel, dtype, p, s);
    case 128: return launch_d<128>(kernel, dtype, p, s);
    default: return ERR_UNSUPPORTED;
  }
}

const char* tpushare_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
