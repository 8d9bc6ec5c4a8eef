// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// that tpushare_torch/kernels/flash.py loads through ctypes.
//
// Two kernels: flash_fwd_kernel (K1, below) and its pipelined variant
// flash_fwd_pipelined_kernel (K4, further below, with its own note), which
// returns bitwise K1's results.
//
// K1 replaces the TPU kernel tpushare/workloads/attention.py:_flash_kernel
// (launched by _flash_call). It computes the same function: causal or
// non-causal attention over q [B,H,S,D] and k/v [B,Hkv,Skv,D], optional
// sliding window, GQA-native (query head h reads kv head h / (H/Hkv), the
// kv heads are never expanded), online softmax with a running max, a
// running denominator and an fp32 accumulator. Outputs: O in q's dtype
// and the log-sum-exp LSE as fp32 [B,H,S].
//
// The reference contract it keeps:
// - the softmax scale is folded into q once, in fp32, and rounded to the
//   storage dtype (here while q is staged into shared memory);
// - p is rounded to v's dtype before the PV product;
// - a row with no visible key gets LSE -inf and output 0, and the
//   exp(m - shift) rescale is guarded while the running max is -inf;
// - ragged S: keys past Skv are masked, query rows past S are neither
//   computed into the output nor written;
// - causal: the kv loop stops at the diagonal tile; window: it starts at
//   the window floor's tile.
//
// Design. The TPU kernel walks a sequential kv grid axis with its state
// in VMEM scratch; blocks here run in parallel in no order, so one block
// owns one (q tile, head, batch) triple and walks its kv tiles in a loop.
// Tiles are 64 query rows x 64 keys, sized for shared memory (the TPU's
// 1024 x 1024 tiles do not carry over): the q, k and v tiles, the fp32
// score tile, the probability tile and the fp32 output accumulator all
// live in shared memory (113 KB for bf16 at D=128). The TPU kernel's mask
// classes (clean, diagonal, floor, pad) become one flag per kv tile: the
// interior tiles run the softmax without any compare, the edge tiles with
// them.
// bf16 runs both products on the tensor cores through WMMA 16x16x16
// fragments with fp32 accumulation (one warp per 16 query rows); fp32
// runs them as scalar FMAs, since the tensor cores have no full-fp32 mode.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s):
// the causal work is 4*B*H*D*(visible pairs), about 2*B*H*D*S^2 FLOPs,
// over (|q|+|k|+|v|+|o|) = 5*B*H*S*D bf16 bytes at GQA group 4: 0.4*S
// operations per byte against the card's 295. Below S of about 740 the
// kernel is bound by bytes, above by operations; the serving prefill
// buckets (S <= 512) sit on the bytes side. This first
// version does not reach either bound: every tile passes through shared
// memory between the two products, loads are not overlapped with compute
// (no cp.async or TMA) and WMMA issues synchronous mma, not wgmma. Its
// times beside the bound are in PERF.md; a faster kernel is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per kv tile
constexpr int NTHREADS = 128;  // four warps; warp w owns rows 16w..16w+15

using bf16 = __nv_bfloat16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, H, Hkv, S, Skv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal;
  int window;  // 0 = no window
  float scale;
  int vec;  // every q/k/v row start is 16-byte aligned
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

// Shared-memory layout of one block. Row pitches are padded: bf16 tiles
// by 8 elements (WMMA needs a pitch that is a multiple of 16 bytes),
// fp32 q/k/v tiles by 1 element (the scalar products read k columns
// across a half-warp, and an odd pitch puts them in distinct banks).
template <typename T, int D>
struct Layout {
  static constexpr bool kTensorCore = sizeof(T) == 2;
  static constexpr int LDT = D + (kTensorCore ? 8 : 1);
  static constexpr int LDS = BK + 4;
  static constexpr int LDP = BK + 8;
  static constexpr int LDO = D + 4;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + sizeof(T) * BQ * LDT);
  static constexpr size_t v_off = align128(k_off + sizeof(T) * BK * LDT);
  static constexpr size_t s_off = align128(v_off + sizeof(T) * BK * LDT);
  static constexpr size_t p_off = align128(s_off + sizeof(float) * BQ * LDS);
  static constexpr size_t o_off = align128(p_off + sizeof(T) * BQ * LDP);
  static constexpr size_t m_off = align128(o_off + sizeof(float) * BQ * LDO);
  static constexpr size_t l_off = align128(m_off + sizeof(float) * BQ);
  static constexpr size_t bytes = align128(l_off + sizeof(float) * BQ);
};

// Copy a 64-row tile of D columns from global memory into shared memory,
// zero-filling rows >= rows_valid. With `scale` set, each element becomes
// round_T(float(x) * scale): the reference's once-folded softmax scale.
template <typename T, int D, int LD, int NT = NTHREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride,
                                          int rows_valid, bool vec,
                                          bool scaled, float scale,
                                          int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  if (vec) {
    for (int idx = tid; idx < 64 * VPR; idx += NT) {
      const int r = idx / VPR;
      const int c = (idx % VPR) * VEC;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid) {
        raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      }
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        T x = vals[e];
        if (scaled) x = from_f<T>(to_f(x) * scale);
        dst[r * LD + c + e] = x;
      }
    }
  } else {
    for (int idx = tid; idx < 64 * D; idx += NT) {
      const int r = idx / D;
      const int c = idx % D;
      T x = r < rows_valid ? src[r * row_stride + c] : from_f<T>(0.f);
      if (scaled) x = from_f<T>(to_f(x) * scale);
      dst[r * LD + c] = x;
    }
  }
}

// ---- S = Q K^T into the fp32 score tile ------------------------------------

template <int D>
__device__ __forceinline__ void scores_tc(const bf16* Qs, const bf16* Ks,
                                          float* Ss, int tid) {
  using namespace nvcuda;
  using L = Layout<bf16, D>;
  const int warp = tid / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, Qs + warp * 16 * L::LDT + kk, L::LDT);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      // K stored [key][d] row-major is K^T in column-major order
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, Ks + n * 16 * L::LDT + kk, L::LDT);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::store_matrix_sync(Ss + warp * 16 * L::LDS + n * 16, acc[n],
                            L::LDS, wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void scores_scalar(const float* Qs,
                                              const float* Ks, float* Ss,
                                              int tid) {
  using L = Layout<float, D>;
  // thread (ty, tx) owns rows ty + 8i and columns tx + 16j
  const int ty = tid >> 4;
  const int tx = tid & 15;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = Qs[(ty + 8 * i) * L::LDT + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * L::LDT + d];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      Ss[(ty + 8 * i) * L::LDS + tx + 16 * j] = acc[i][j];
}

// ---- O += P V into the fp32 accumulator tile -------------------------------

template <int D>
__device__ __forceinline__ void pv_tc(const bf16* Ps, const bf16* Vs,
                                      float* Os, int tid) {
  using namespace nvcuda;
  using L = Layout<bf16, D>;
  const int warp = tid / 32;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[BK / 16];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    wmma::load_matrix_sync(a[kk], Ps + warp * 16 * L::LDP + kk * 16, L::LDP);
  }
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    float* out = Os + warp * 16 * L::LDO + n * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, out, L::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, Vs + kk * 16 * L::LDT + n * 16, L::LDT);
      wmma::mma_sync(acc, a[kk], b, acc);
    }
    wmma::store_matrix_sync(out, acc, L::LDO, wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void pv_scalar(const float* Ps, const float* Vs,
                                          float* Os, int tid) {
  using L = Layout<float, D>;
  constexpr int NC = D / 16;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      acc[i][c] = Os[(ty + 8 * i) * L::LDO + tx + 16 * c];
  for (int kk = 0; kk < BK; ++kk) {
    float a[8], b[NC];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = Ps[(ty + 8 * i) * L::LDP + kk];
#pragma unroll
    for (int c = 0; c < NC; ++c) b[c] = Vs[kk * L::LDT + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      Os[(ty + 8 * i) * L::LDO + tx + 16 * c] = acc[i][c];
}

// ---- one online-softmax update from the score tile -------------------------
// Two threads per query row, 32 columns each. MASK selects the edge-tile
// phase (pad / causal diagonal / window floor compares); interior tiles
// run with MASK = false and no compare at all.
template <typename T, int D, bool MASK>
__device__ __forceinline__ void softmax_step(const float* Ss, T* Ps,
                                             float* Os, float* m_s,
                                             float* l_s, int i0, int j0,
                                             const Params& p, int tid) {
  using L = Layout<T, D>;
  constexpr int HALF = BK / 2;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int grow = i0 + r;
  float sv[HALF];
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    const int cc = half * HALF + c;
    float s = Ss[r * L::LDS + cc];
    if (MASK) {
      const int gcol = j0 + cc;
      bool vis = gcol < p.Skv;
      if (p.causal) vis = vis && gcol <= grow;
      if (p.window > 0) vis = vis && gcol >= grow - (p.window - 1);
      if (!vis) s = -INFINITY;
    }
    sv[c] = s;
    mx = fmaxf(mx, s);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_old = m_s[r];
  const float m_new = fmaxf(m_old, mx);
  // rows with no visible key yet keep m = -inf: shift by 0 there, and
  // the old accumulator (all zeros) is scaled by 0 instead of exp(NaN)
  const float shift = m_new == -INFINITY ? 0.f : m_new;
  const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - shift);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    const float pr = expf(sv[c] - shift);  // masked entries give exactly 0
    Ps[r * L::LDP + half * HALF + c] = from_f<T>(pr);
    sum += pr;
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  __syncwarp();
  if (half == 0) {
    m_s[r] = m_new;
    l_s[r] = l_s[r] * alpha + sum;
  }
#pragma unroll 4
  for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) {
    Os[r * L::LDO + d] *= alpha;
  }
}

// ---- pieces shared by both kernels ----------------------------------------

// The block's q tile, scaled, into Qs; the accumulator and the running
// max and denominator reset. Called by every thread of the block.
template <typename T, int D, int NT>
__device__ __forceinline__ void init_tile(T* Qs, float* Os, float* m_s,
                                          float* l_s, const T* qg, int i0,
                                          const Params& p, int tid) {
  using L = Layout<T, D>;
  load_tile<T, D, L::LDT, NT>(Qs, qg + i0 * p.q_ss, p.q_ss,
                              min(BQ, p.S - i0), p.vec != 0, true, p.scale,
                              tid);
  for (int idx = tid; idx < BQ * L::LDO; idx += NT) Os[idx] = 0.f;
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
}

// kv tiles the q tile at i0 can see: [*j_begin, *j_end)
__device__ __forceinline__ void kv_range(int i0, const Params& p,
                                         int* j_begin, int* j_end) {
  const int last_row = i0 + BQ - 1;
  const int n_kv = (p.Skv + BK - 1) / BK;
  *j_end = p.causal ? min(n_kv, last_row / BK + 1) : n_kv;
  *j_begin = p.window > 0 ? max(i0 - (p.window - 1), 0) / BK : 0;
}

// edge tiles: padded keys, the causal diagonal, the window floor
__device__ __forceinline__ bool is_edge(int i0, int j0, const Params& p) {
  const int last_row = i0 + BQ - 1;
  return (j0 + BK > p.Skv) || (p.causal && j0 + BK - 1 > i0) ||
         (p.window > 0 && j0 < last_row - (p.window - 1));
}

// normalise and emit; query rows past S are not written
template <typename T, int D, int NT>
__device__ __forceinline__ void emit_tile(const float* Os, const float* m_s,
                                          const float* l_s, int i0, int h,
                                          int b, const Params& p, int tid) {
  using L = Layout<T, D>;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D;
    const int c = idx % D;
    if (i0 + r < p.S) {
      og[(i0 + r) * p.o_ss + c] =
          from_f<T>(Os[r * L::LDO + c] / fmaxf(l_s[r], 1e-30f));
    }
  }
  if (tid < BQ && i0 + tid < p.S) {
    const float l = l_s[tid];
    const float lse = l > 0.f ? m_s[tid] + logf(fmaxf(l, 1e-30f)) : -INFINITY;
    p.lse[(static_cast<long long>(b) * p.H + h) * p.S + i0 + tid] = lse;
  }
}

template <typename T, int D>
__device__ __forceinline__ void scores(const T* Qs, const T* Ks, float* Ss,
                                       int tid) {
  if constexpr (Layout<T, D>::kTensorCore) {
    scores_tc<D>(Qs, Ks, Ss, tid);
  } else {
    scores_scalar<D>(Qs, Ks, Ss, tid);
  }
}

template <typename T, int D>
__device__ __forceinline__ void pv(const T* Ps, const T* Vs, float* Os,
                                   int tid) {
  if constexpr (Layout<T, D>::kTensorCore) {
    pv_tc<D>(Ps, Vs, Os, tid);
  } else {
    pv_scalar<D>(Ps, Vs, Os, tid);
  }
}

// ---- K1: one kv tile a step -------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(Params p) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  T* Ps = reinterpret_cast<T*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::m_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const bool vec = p.vec != 0;

  init_tile<T, D, NTHREADS>(Qs, Os, m_s, l_s, qg, i0, p, tid);
  int j_begin, j_end;
  kv_range(i0, p, &j_begin, &j_end);

  for (int j = j_begin; j < j_end; ++j) {
    const int j0 = j * BK;
    const int kv_valid = min(BK, p.Skv - j0);
    __syncthreads();  // the previous tile's readers are done with Ks/Vs
    load_tile<T, D, L::LDT>(Ks, kg + j0 * p.k_ss, p.k_ss, kv_valid, vec,
                            false, 1.f, tid);
    load_tile<T, D, L::LDT>(Vs, vg + j0 * p.v_ss, p.v_ss, kv_valid, vec,
                            false, 1.f, tid);
    __syncthreads();
    scores<T, D>(Qs, Ks, Ss, tid);
    __syncthreads();
    if (is_edge(i0, j0, p)) {
      softmax_step<T, D, true>(Ss, Ps, Os, m_s, l_s, i0, j0, p, tid);
    } else {
      softmax_step<T, D, false>(Ss, Ps, Os, m_s, l_s, i0, j0, p, tid);
    }
    __syncthreads();
    pv<T, D>(Ps, Vs, Os, tid);
  }
  __syncthreads();
  emit_tile<T, D, NTHREADS>(Os, m_s, l_s, i0, h, b, p, tid);
}

// ---- K4: the pipelined forward ---------------------------------------------
//
// Replaces the TPU kernel tpushare/workloads/attention.py:
// _flash_kernel_pipelined (the same pallas_call as _flash_kernel, selected
// with TPUSHARE_FLASH_FWD=pipelined). It computes K1's function, and its
// output and LSE are bitwise equal to K1's: every tile goes through the
// same device functions above (scores, softmax_step, pv, init_tile,
// emit_tile) on the same values in the same online-softmax order; only
// the issue order changes.
//
// Design. The TPU kernel runs one extra kv grid step and, in step j,
// computes block j's scores on the MXU while the VPU consumes block j-1's
// (mask, softmax, PV) from the other half of a double-buffered score
// scratch. Here the block is two warp groups of four warps each, on the
// same (64-row q tile, head, batch) as K1:
// - the producer group (warps 0-3) computes S_j = Q K_j^T on the tensor
//   cores into score buffer j & 1;
// - the consumer group (warps 4-7) masks, exponentiates and accumulates
//   tile j-1 from the other buffer with V_{j-1}, using tile j-1's own
//   edge flag, and runs its PV product;
// - the kv loop runs one extra iteration for the last consume, then both
//   groups emit.
// The two halves of an iteration share no data, so the producer's
// tensor-core product of tile j overlaps the consumer's CUDA-core softmax
// of tile j-1: the Hopper form of the TPU kernel's MXU/VPU overlap. One
// block barrier (bar.sync 0, 256 threads) ends each iteration and hands
// the tiles over; the consumer's softmax -> PV hand-off inside its group
// is a named barrier (bar.sync 1, 128).
//
// Loads. For bf16 with 16-byte aligned rows the producer prefetches
// K_{j+1} and V_j with cp.async into double K and V buffers while it
// computes S_j and the consumer works on tile j-1; ragged tiles zero-fill
// their missing rows through cp.async's source size, as K1 zero-fills
// them. Shared memory at bf16, D=128: K1's 113 KB plus a second score
// tile (17 KB) and a second K and V tile (2 x 17 KB), 165 KB of the 227.
// fp32 does not fit that: K1's fp32 layout is already 169 KB (odd pitch
// 129 against bank conflicts, which also rules out cp.async's 16-byte
// rows), and double K/V buffers would need about 252 KB. So fp32 keeps
// one K and one V buffer, double-buffers only the scores, and all 256
// threads load K_j and V_{j-1} synchronously at the start of iteration j;
// bf16 rows that are not 16-byte aligned take the same synchronous path
// into the double buffers.
//
// What bounds it: the same work and bytes as K1. This first version is
// built from K1's synchronous WMMA products (no wgmma or TMA yet), so it
// inherits K1's distance from the bound; the overlap can only hide the
// shorter of the two halves of each iteration.

constexpr int PIPE_THREADS = 2 * NTHREADS;

template <typename T, int D>
struct PipeLayout {
  using L = Layout<T, D>;
  static constexpr bool kDoubleKV = L::kTensorCore;
  static constexpr size_t tile = sizeof(T) * BK * L::LDT;
  static constexpr size_t s_tile = sizeof(float) * BQ * L::LDS;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + sizeof(T) * BQ * L::LDT);
  static constexpr size_t v_off = align128(k_off + (kDoubleKV ? 2 : 1) * tile);
  static constexpr size_t s_off = align128(v_off + (kDoubleKV ? 2 : 1) * tile);
  static constexpr size_t p_off = align128(s_off + 2 * s_tile);
  static constexpr size_t o_off = align128(p_off + sizeof(T) * BQ * L::LDP);
  static constexpr size_t m_off = align128(o_off + sizeof(float) * BQ * L::LDO);
  static constexpr size_t l_off = align128(m_off + sizeof(float) * BQ);
  static constexpr size_t bytes = align128(l_off + sizeof(float) * BQ);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // source size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// cp.async copy of a 64-row tile of 16-byte aligned rows by one warp
// group; rows >= rows_valid become zeros, as load_tile makes them
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long row_stride,
                                                int rows_valid, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int idx = tid; idx < 64 * VPR; idx += NTHREADS) {
    const int r = idx / VPR;
    const int c = (idx % VPR) * VEC;
    const bool ok = r < rows_valid;
    cp_async16(dst + r * LD + c, ok ? src + r * row_stride + c : src, ok);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(PIPE_THREADS)
    flash_fwd_pipelined_kernel(Params p) {
  using L = Layout<T, D>;
  using PL = PipeLayout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + PL::q_off);
  T* Ks = reinterpret_cast<T*>(smem + PL::k_off);
  T* Vs = reinterpret_cast<T*>(smem + PL::v_off);
  float* Ss = reinterpret_cast<float*>(smem + PL::s_off);
  T* Ps = reinterpret_cast<T*>(smem + PL::p_off);
  float* Os = reinterpret_cast<float*>(smem + PL::o_off);
  float* m_s = reinterpret_cast<float*>(smem + PL::m_off);
  float* l_s = reinterpret_cast<float*>(smem + PL::l_off);
  constexpr int KV_TILE = BK * L::LDT;     // elements of one K or V tile
  constexpr int S_TILE = BQ * L::LDS;      // floats of one score tile
  constexpr int NBUF = PL::kDoubleKV ? 2 : 1;

  const int tid = threadIdx.x;
  const bool producer = tid < NTHREADS;
  const int gtid = producer ? tid : tid - NTHREADS;  // index in the group
  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const bool vec = p.vec != 0;
  const bool async_kv = PL::kDoubleKV && vec;

  init_tile<T, D, PIPE_THREADS>(Qs, Os, m_s, l_s, qg, i0, p, tid);
  int j_begin, j_end;
  kv_range(i0, p, &j_begin, &j_end);
  auto k_tile = [&](int j) { return Ks + (j % NBUF) * KV_TILE; };
  auto v_tile = [&](int j) { return Vs + (j % NBUF) * KV_TILE; };
  auto kv_rows = [&](int j) { return min(BK, p.Skv - j * BK); };

  if (async_kv && producer && j_begin < j_end) {
    load_tile_async<T, D, L::LDT>(k_tile(j_begin), kg + j_begin * BK * p.k_ss,
                                  p.k_ss, kv_rows(j_begin), gtid);
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();

  for (int j = j_begin; j <= j_end; ++j) {
    if (!async_kv) {
      // K_j for the producer and V_{j-1} for the consumer, by all threads
      if (j < j_end) {
        load_tile<T, D, L::LDT, PIPE_THREADS>(
            k_tile(j), kg + j * BK * p.k_ss, p.k_ss, kv_rows(j), vec, false,
            1.f, tid);
      }
      if (j > j_begin) {
        load_tile<T, D, L::LDT, PIPE_THREADS>(
            v_tile(j - 1), vg + (j - 1) * BK * p.v_ss, p.v_ss,
            kv_rows(j - 1), vec, false, 1.f, tid);
      }
      __syncthreads();
    }
    if (producer) {
      if (j < j_end) {
        if (async_kv) {
          if (j + 1 < j_end) {
            load_tile_async<T, D, L::LDT>(k_tile(j + 1),
                                          kg + (j + 1) * BK * p.k_ss, p.k_ss,
                                          kv_rows(j + 1), gtid);
          }
          load_tile_async<T, D, L::LDT>(v_tile(j), vg + j * BK * p.v_ss,
                                        p.v_ss, kv_rows(j), gtid);
          cp_async_commit();
        }
        scores<T, D>(Qs, k_tile(j), Ss + (j & 1) * S_TILE, gtid);
        if (async_kv) cp_async_wait_all();
      }
    } else if (j > j_begin) {
      const int jj = j - 1;
      const int j0 = jj * BK;
      const float* Sj = Ss + (jj & 1) * S_TILE;
      if (is_edge(i0, j0, p)) {
        softmax_step<T, D, true>(Sj, Ps, Os, m_s, l_s, i0, j0, p, gtid);
      } else {
        softmax_step<T, D, false>(Sj, Ps, Os, m_s, l_s, i0, j0, p, gtid);
      }
      named_barrier(1, NTHREADS);  // P and the rescaled O, group-wide
      pv<T, D>(Ps, v_tile(jj), Os, gtid);
    }
    __syncthreads();  // hand S_j, V_j and K_{j+1} over; free the buffers
  }
  emit_tile<T, D, PIPE_THREADS>(Os, m_s, l_s, i0, h, b, p, tid);
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  using L = Layout<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, L::bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_pipelined(const Params& p, cudaStream_t stream) {
  using PL = PipeLayout<T, D>;
  static_assert(PL::bytes <= 232448, "pipelined layout over 227 KB");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_pipelined_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(PL::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_pipelined_kernel<T, D>
      <<<grid, PIPE_THREADS, PL::bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int head_dim, bool pipelined, const Params& p,
               cudaStream_t stream) {
  switch (head_dim) {
    case 16: return pipelined ? launch_pipelined<T, 16>(p, stream)
                              : launch<T, 16>(p, stream);
    case 32: return pipelined ? launch_pipelined<T, 32>(p, stream)
                              : launch<T, 32>(p, stream);
    case 64: return pipelined ? launch_pipelined<T, 64>(p, stream)
                              : launch<T, 64>(p, stream);
    case 128: return pipelined ? launch_pipelined<T, 128>(p, stream)
                               : launch<T, 128>(p, stream);
    default: return -1;
  }
}

int flash_fwd_entry(bool pipelined, int device, int dtype, int head_dim,
                    const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int H, int Hkv, int S, int Skv,
                    long long q_sb, long long q_sh, long long q_ss,
                    long long k_sb, long long k_sh, long long k_ss,
                    long long v_sb, long long v_sh, long long v_ss,
                    long long o_sb, long long o_sh, long long o_ss,
                    int causal, int window, float scale, int vec,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{q,    k,    v,    o,    lse,  B,    H,    Hkv,    S,     Skv,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,   v_ss,  o_sb,
           o_sh, o_ss, causal, window, scale, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(head_dim, pipelined, p, s);
  if (dtype == 1) return dispatch_d<bf16>(head_dim, pipelined, p, s);
  return -1;
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. Strides are in elements; the last dimension
// of q, k, v and o must be contiguous. Returns 0, a cudaError_t value, or
// -1 for a (dtype, head_dim) pair this library was not built for.
int tpushare_flash_fwd(int device, int dtype, int head_dim, const void* q,
                       const void* k, const void* v, void* o, float* lse,
                       int B, int H, int Hkv, int S, int Skv,
                       long long q_sb, long long q_sh, long long q_ss,
                       long long k_sb, long long k_sh, long long k_ss,
                       long long v_sb, long long v_sh, long long v_ss,
                       long long o_sb, long long o_sh, long long o_ss,
                       int causal, int window, float scale, int vec,
                       void* stream) {
  return flash_fwd_entry(false, device, dtype, head_dim, q, k, v, o, lse, B,
                         H, Hkv, S, Skv, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                         v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, causal, window,
                         scale, vec, stream);
}

// K4, the pipelined forward: K1's arguments and K1's results, bitwise.
int tpushare_flash_fwd_pipelined(
    int device, int dtype, int head_dim, const void* q, const void* k,
    const void* v, void* o, float* lse, int B, int H, int Hkv, int S,
    int Skv, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    int causal, int window, float scale, int vec, void* stream) {
  return flash_fwd_entry(true, device, dtype, head_dim, q, k, v, o, lse, B,
                         H, Hkv, S, Skv, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                         v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, causal, window,
                         scale, vec, stream);
}

const char* tpushare_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
