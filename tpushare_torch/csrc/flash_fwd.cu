// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// that tpushare_torch/kernels/flash.py loads through ctypes.
//
// Two kernels, each in two designs chosen by dtype:
// - K1, tpushare_flash_fwd, replaces the TPU kernel
//   tpushare/workloads/attention.py:_flash_kernel (launched by
//   _flash_call);
// - K4, tpushare_flash_fwd_pipelined, replaces
//   tpushare/workloads/attention.py:_flash_kernel_pipelined (the same
//   pallas_call, selected with TPUSHARE_FLASH_FWD=pipelined). It computes
//   K1's function and returns bitwise K1's output and LSE: every tile goes
//   through the same device functions on the same operands in the same
//   online-softmax order; only the issue order changes.
//
// The function: causal or non-causal attention over q [B,H,S,D] and k/v
// [B,Hkv,Skv,D], optional sliding window, GQA-native (query head h reads
// kv head h / (H/Hkv), the kv heads are never expanded), online softmax
// with a running max, a running denominator and an fp32 accumulator.
// Outputs: O in q's dtype and the log-sum-exp LSE as fp32 [B,H,S].
//
// The reference contract both designs keep:
// - the softmax scale is folded into q once, in fp32, and rounded to the
//   storage dtype (attention.py:500);
// - p is rounded to v's dtype before the PV product;
// - a row with no visible key gets LSE -inf and output 0, and the
//   exp(m - shift) rescale is guarded while the running max is -inf;
// - ragged S: keys past Skv are masked, query rows past S are neither
//   computed into the output nor written;
// - causal: the kv loop stops at the diagonal tile; window: it starts at
//   the window floor's tile. Interior tiles run the softmax without any
//   compare, edge tiles (pad, causal diagonal, window floor) with them.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the
// causal work is 4*B*H*D*(visible pairs), about 2*B*H*D*S^2 FLOPs, over
// (|q|+|k|+|v|+|o|) = 5*B*H*S*D bf16 bytes at GQA group 4: 0.4*S
// operations per byte against the card's 295. Below S of about 740 the
// kernel is bound by bytes, above by operations; the serving prefill
// buckets (S <= 512) and ViT-B/16 (S = 197) sit on the bytes side, the
// llama-8b training sequence (S = 1023) on the operations side. Either way
// what held the first design back was neither: it was the latency of one
// kv tile step (synchronous loads, the score, probability and output
// tiles round-tripping through shared memory, four block barriers and
// synchronous WMMA per tile). The bf16 design below removes that chain.
//
// bf16: the Hopper design (flash_fwd_tc_kernel, both K1 and K4).
// - One CTA per (128-row q tile, head, batch): a producer warpgroup and
//   two consumer warpgroups of 64 rows each (384 threads). The kv loop
//   runs inside the CTA. The grid's slowest axis is the q tile, largest
//   first, so the longest causal rows start first.
// - Producer: one thread issues TMA loads, Q once and K_j, V_j into a
//   ring of STAGES = 3 shared-memory stages, each stage with a full
//   barrier for K, one for V, and an empty barrier that all eight
//   consumer warps arrive on. The tensor maps are 4-D, (D, S, H, B) with
//   the caller's strides, encoded on the host for every call and passed
//   as __grid_constant__ parameters, so the model's transposed
//   [B,S,H,D] -> [B,H,S,D] views are read in place; TMA zero-fills rows
//   past S and Skv. Rows that are not 16-byte aligned (TMA cannot read
//   them) are written by the same producer warpgroup with plain loads
//   into the same swizzled layout, arriving on the same barriers; the
//   consumers do not change.
// - Consumers: after Q lands each warpgroup rewrites its 64 rows in
//   shared memory as bf16(float(q) * scale), fences the async proxy and
//   syncs its warpgroup. S = Q K^T is wgmma m64n64k16 with A = Q and B =
//   K, both K-major from shared memory; the fp32 scores stay in
//   registers; the mask and the online softmax run on the accumulator
//   fragment (row max and sum are four-lane shuffles); P is rounded to
//   bf16 in registers and is the A operand of O += P V (wgmma m64nNk16,
//   A from registers, B = V MN-major with the transpose flag), O an fp32
//   register accumulator rescaled in registers. The epilogue normalises
//   O and stores it with guarded direct stores; the LSE likewise.
// - K4 adds the TPU kernel's pipelining, block j's scores computed while
//   block j-1 is still being consumed, as FlashAttention-3's
//   intra-warpgroup overlap: each consumer warpgroup issues S_j = Q K_j^T
//   and then tile j-1's PV product, both asynchronous, and runs tile j's
//   mask and softmax while the PV product is in flight; P_j and O's
//   rescale by alpha_j wait for it. O sees K1's operations in K1's
//   order (rescale by alpha_j, then add P_j V_j), which keeps K4 bitwise.
//   The order that computes S_{j+1} during tile j's softmax needs two
//   score accumulators at once, S_j and S_{j+1} beside O and P (about 150
//   live registers at D = 128): ptxas 12.9 allocates this kernel's
//   consumer path within the launch bound's 168 registers whatever
//   setmaxnreg raises them to, and that order spilled and serialised
//   its wgmma at D = 128. This one needs one accumulator.
// - Registers: setmaxnreg gives the producer 40 and the consumers 232 a
//   thread (128 * 40 + 256 * 232 = 64,512 of the SM's 65,536); with 24
//   the producer's plain-load path spills. The consumer path fits the
//   168 that ptxas allocates it (chip_smoke.py's build phase prints the
//   highest register each kernel's machine code uses).
// - Every wgmma stays asynchronous only if ptxas can track the groups:
//   the role branch is on a warp-uniform (shuffled) warpgroup index, no
//   group is in flight between two tiles on any path, the first k-step's
//   outputs are write-only, and register fences keep P's packing and O's
//   rescale ahead of the next issue. ptxas reports each lapse as "wgmma
//   ... serialized" (C7510-C7520); the build phase of chip_smoke.py
//   prints those lines.
//
// Tile sizes and why:
// - BQ = 128: two consumer warpgroups of wgmma's 64 rows share every K and
//   V tile the producer loads, halving the kv traffic of a 64-row tile.
// - BK = 64 at every head dim: at D = 128 the score accumulator (32),
//   O (64) and P (16) of K4 then fit the 168 registers ptxas allocates,
//   K1 and K4 share the tile (K4 is bitwise K1 only on the same tile),
//   and the plain version's 64-key block stays the kernels' kv tile.
// - Swizzle per D: rows of 2*D bytes take the 32-byte swizzle at D = 16,
//   the 64-byte one at D = 32 and the 128-byte one at D >= 64; at D = 128
//   a row is 256 bytes, so each tile is two 64-column boxes ("chunks").
//   Every tile starts on a 1024-byte boundary, the swizzle's period. The
//   swizzle, barriers, TMA, descriptors and wgmma wrappers are in
//   hopper.cuh, shared with the backward kernels of flash_bwd.cu.
// - STAGES = 3: shared memory at D = 128 is Q 32 KB + 3 x (K 16 + V 16)
//   KB = 128 KB of the 227; one CTA fits an SM by registers anyway.
//
// fp32 keeps the first design's scalar kernels (flash_fwd_kernel and
// flash_fwd_pipelined_kernel below): the tensor cores have no full-fp32
// mode and fp32 lies on no main path. One block per (64-row q tile, head,
// batch), 64-key tiles in shared memory, scalar FMA products; K4's
// variant splits the block into a score group and a softmax/PV group.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
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
  int vec;  // q/k/v are TMA-able: 16-byte aligned base and outer strides
};

// ============================================================================
// fp32: the scalar kernels
// ============================================================================

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per kv tile (also the bf16 design's)
constexpr int NTHREADS = 128;  // four warps

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Shared-memory layout of one fp32 block. q/k/v rows are padded by one
// element: the scalar products read k columns across a half-warp, and an
// odd pitch puts them in distinct banks.
template <int D>
struct Layout {
  static constexpr int LDT = D + 1;
  static constexpr int LDS = BK + 4;
  static constexpr int LDP = BK + 8;
  static constexpr int LDO = D + 4;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + sizeof(float) * BQ * LDT);
  static constexpr size_t v_off = align128(k_off + sizeof(float) * BK * LDT);
  static constexpr size_t s_off = align128(v_off + sizeof(float) * BK * LDT);
  static constexpr size_t p_off = align128(s_off + sizeof(float) * BQ * LDS);
  static constexpr size_t o_off = align128(p_off + sizeof(float) * BQ * LDP);
  static constexpr size_t m_off = align128(o_off + sizeof(float) * BQ * LDO);
  static constexpr size_t l_off = align128(m_off + sizeof(float) * BQ);
  static constexpr size_t bytes = align128(l_off + sizeof(float) * BQ);
};

// Copy a 64-row tile of D columns from global memory into shared memory,
// zero-filling rows >= rows_valid, times `scale` where `scaled` is set.
template <int D, int NT = NTHREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride,
                                          int rows_valid, bool vec,
                                          bool scaled, float scale,
                                          int tid) {
  constexpr int LD = Layout<D>::LDT;
  constexpr int VEC = 4;  // floats in 16 bytes
  constexpr int VPR = D / VEC;
  if (vec) {
    for (int idx = tid; idx < 64 * VPR; idx += NT) {
      const int r = idx / VPR;
      const int c = (idx % VPR) * VEC;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid) {
        raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      }
      const float* vals = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float x = vals[e];
        if (scaled) x = x * scale;
        dst[r * LD + c + e] = x;
      }
    }
  } else {
    for (int idx = tid; idx < 64 * D; idx += NT) {
      const int r = idx / D;
      const int c = idx % D;
      float x = r < rows_valid ? src[r * row_stride + c] : 0.f;
      if (scaled) x = x * scale;
      dst[r * LD + c] = x;
    }
  }
}

// S = Q K^T into the fp32 score tile
template <int D>
__device__ __forceinline__ void scores_scalar(const float* Qs,
                                              const float* Ks, float* Ss,
                                              int tid) {
  using L = Layout<D>;
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

// O += P V into the fp32 accumulator tile
template <int D>
__device__ __forceinline__ void pv_scalar(const float* Ps, const float* Vs,
                                          float* Os, int tid) {
  using L = Layout<D>;
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

// One online-softmax update from the score tile. Two threads per query
// row, 32 columns each. MASK selects the edge-tile phase.
template <int D, bool MASK>
__device__ __forceinline__ void softmax_step(const float* Ss, float* Ps,
                                             float* Os, float* m_s,
                                             float* l_s, int i0, int j0,
                                             const Params& p, int tid) {
  using L = Layout<D>;
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
    Ps[r * L::LDP + half * HALF + c] = pr;
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

// The block's q tile, scaled, into Qs; the accumulator and the running
// max and denominator reset. Called by every thread of the block.
template <int D, int NT>
__device__ __forceinline__ void init_tile(float* Qs, float* Os, float* m_s,
                                          float* l_s, const float* qg,
                                          int i0, const Params& p, int tid) {
  load_tile<D, NT>(Qs, qg + i0 * p.q_ss, p.q_ss, min(BQ, p.S - i0),
                   p.vec != 0, true, p.scale, tid);
  for (int idx = tid; idx < BQ * Layout<D>::LDO; idx += NT) Os[idx] = 0.f;
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
}

// kv tiles a q tile of `rows` rows at i0 can see: [*j_begin, *j_end)
__device__ __forceinline__ void kv_range(int i0, int rows,
                                                  const Params& p,
                                                  int* j_begin, int* j_end) {
  const int last_row = i0 + rows - 1;
  const int n_kv = (p.Skv + BK - 1) / BK;
  *j_end = p.causal ? min(n_kv, last_row / BK + 1) : n_kv;
  *j_begin = p.window > 0 ? max(i0 - (p.window - 1), 0) / BK : 0;
}

// edge tiles of a q tile of `rows` rows at i0: padded keys, the causal
// diagonal, the window floor
__device__ __forceinline__ bool is_edge(int i0, int rows, int j0,
                                        const Params& p) {
  const int last_row = i0 + rows - 1;
  return (j0 + BK > p.Skv) || (p.causal && j0 + BK - 1 > i0) ||
         (p.window > 0 && j0 < last_row - (p.window - 1));
}

// normalise and emit; query rows past S are not written
template <int D, int NT>
__device__ __forceinline__ void emit_tile(const float* Os, const float* m_s,
                                          const float* l_s, int i0, int h,
                                          int b, const Params& p, int tid) {
  using L = Layout<D>;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D;
    const int c = idx % D;
    if (i0 + r < p.S) {
      og[(i0 + r) * p.o_ss + c] = Os[r * L::LDO + c] / fmaxf(l_s[r], 1e-30f);
    }
  }
  if (tid < BQ && i0 + tid < p.S) {
    const float l = l_s[tid];
    const float lse = l > 0.f ? m_s[tid] + logf(fmaxf(l, 1e-30f)) : -INFINITY;
    p.lse[(static_cast<long long>(b) * p.H + h) * p.S + i0 + tid] = lse;
  }
}

// K1, fp32: one kv tile a step
template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(Params p) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* Ps = reinterpret_cast<float*>(smem + L::p_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::m_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const bool vec = p.vec != 0;

  init_tile<D, NTHREADS>(Qs, Os, m_s, l_s, qg, i0, p, tid);
  int j_begin, j_end;
  kv_range(i0, BQ, p, &j_begin, &j_end);

  for (int j = j_begin; j < j_end; ++j) {
    const int j0 = j * BK;
    const int kv_valid = min(BK, p.Skv - j0);
    __syncthreads();  // the previous tile's readers are done with Ks/Vs
    load_tile<D>(Ks, kg + j0 * p.k_ss, p.k_ss, kv_valid, vec, false, 1.f,
                 tid);
    load_tile<D>(Vs, vg + j0 * p.v_ss, p.v_ss, kv_valid, vec, false, 1.f,
                 tid);
    __syncthreads();
    scores_scalar<D>(Qs, Ks, Ss, tid);
    __syncthreads();
    if (is_edge(i0, BQ, j0, p)) {
      softmax_step<D, true>(Ss, Ps, Os, m_s, l_s, i0, j0, p, tid);
    } else {
      softmax_step<D, false>(Ss, Ps, Os, m_s, l_s, i0, j0, p, tid);
    }
    __syncthreads();
    pv_scalar<D>(Ps, Vs, Os, tid);
  }
  __syncthreads();
  emit_tile<D, NTHREADS>(Os, m_s, l_s, i0, h, b, p, tid);
}

// K4, fp32: the block is two groups of four warps on K1's tile. In
// iteration j the score group computes S_j into score buffer j & 1 while
// the softmax group masks, exponentiates and accumulates tile j-1 from the
// other buffer with V_{j-1}; the loop runs one extra iteration for the
// last consume. All 256 threads load K_j and V_{j-1} at the start of an
// iteration (K1's fp32 layout is already 169 KB, so K and V are not
// double-buffered); one block barrier ends each iteration, and the softmax
// -> PV hand-off inside the softmax group is a named barrier.

constexpr int PIPE_THREADS = 2 * NTHREADS;

template <int D>
struct PipeLayout {
  using L = Layout<D>;
  static constexpr size_t tile = sizeof(float) * BK * L::LDT;
  static constexpr size_t s_tile = sizeof(float) * BQ * L::LDS;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + sizeof(float) * BQ * L::LDT);
  static constexpr size_t v_off = align128(k_off + tile);
  static constexpr size_t s_off = align128(v_off + tile);
  static constexpr size_t p_off = align128(s_off + 2 * s_tile);
  static constexpr size_t o_off = align128(p_off + sizeof(float) * BQ * L::LDP);
  static constexpr size_t m_off = align128(o_off + sizeof(float) * BQ * L::LDO);
  static constexpr size_t l_off = align128(m_off + sizeof(float) * BQ);
  static constexpr size_t bytes = align128(l_off + sizeof(float) * BQ);
};

template <int D>
__global__ void __launch_bounds__(PIPE_THREADS)
    flash_fwd_pipelined_kernel(Params p) {
  using L = Layout<D>;
  using PL = PipeLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + PL::q_off);
  float* Ks = reinterpret_cast<float*>(smem + PL::k_off);
  float* Vs = reinterpret_cast<float*>(smem + PL::v_off);
  float* Ss = reinterpret_cast<float*>(smem + PL::s_off);
  float* Ps = reinterpret_cast<float*>(smem + PL::p_off);
  float* Os = reinterpret_cast<float*>(smem + PL::o_off);
  float* m_s = reinterpret_cast<float*>(smem + PL::m_off);
  float* l_s = reinterpret_cast<float*>(smem + PL::l_off);
  constexpr int S_TILE = BQ * L::LDS;  // floats of one score tile

  const int tid = threadIdx.x;
  const bool producer = tid < NTHREADS;
  const int gtid = producer ? tid : tid - NTHREADS;  // index in the group
  const int i0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const bool vec = p.vec != 0;

  init_tile<D, PIPE_THREADS>(Qs, Os, m_s, l_s, qg, i0, p, tid);
  int j_begin, j_end;
  kv_range(i0, BQ, p, &j_begin, &j_end);
  auto kv_rows = [&](int j) { return min(BK, p.Skv - j * BK); };
  __syncthreads();

  for (int j = j_begin; j <= j_end; ++j) {
    // K_j for the score group and V_{j-1} for the softmax group
    if (j < j_end) {
      load_tile<D, PIPE_THREADS>(Ks, kg + j * BK * p.k_ss, p.k_ss,
                                 kv_rows(j), vec, false, 1.f, tid);
    }
    if (j > j_begin) {
      load_tile<D, PIPE_THREADS>(Vs, vg + (j - 1) * BK * p.v_ss, p.v_ss,
                                 kv_rows(j - 1), vec, false, 1.f, tid);
    }
    __syncthreads();
    if (producer) {
      if (j < j_end) scores_scalar<D>(Qs, Ks, Ss + (j & 1) * S_TILE, gtid);
    } else if (j > j_begin) {
      const int jj = j - 1;
      const int j0 = jj * BK;
      const float* Sj = Ss + (jj & 1) * S_TILE;
      if (is_edge(i0, BQ, j0, p)) {
        softmax_step<D, true>(Sj, Ps, Os, m_s, l_s, i0, j0, p, gtid);
      } else {
        softmax_step<D, false>(Sj, Ps, Os, m_s, l_s, i0, j0, p, gtid);
      }
      named_barrier(1, NTHREADS);  // P and the rescaled O, group-wide
      pv_scalar<D>(Ps, Vs, Os, gtid);
    }
    __syncthreads();  // hand S_j over; free K and V
  }
  emit_tile<D, PIPE_THREADS>(Os, m_s, l_s, i0, h, b, p, tid);
}

// ============================================================================
// bf16: the Hopper design (TMA producer, wgmma consumers)
// ============================================================================

namespace tc {

constexpr int BQ = 128;          // query rows per CTA; kv tiles are BK keys
constexpr int STAGES = 3;        // K/V ring depth
constexpr int THREADS = 384;     // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;

// Shared-memory layout of one CTA at head dim D; the swizzle of its
// tiles is hopper::Swz<D>.
template <int D>
struct Tile : Swz<D> {
  static constexpr uint32_t q_bytes = BQ * D * 2;
  static constexpr uint32_t kv_bytes = BK * D * 2;
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t k_off = q_off + q_bytes;
  static constexpr uint32_t v_off = k_off + STAGES * kv_bytes;
  static constexpr uint32_t bar_off = v_off + STAGES * kv_bytes;
  // barriers: q_full, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 3 * STAGES);
  static constexpr uint32_t alloc = bytes + 1024;  // room to align the base
  static_assert(q_bytes % 1024 == 0 && kv_bytes % 1024 == 0,
                "tiles must keep the 1024-byte swizzle period");
  static_assert(alloc <= 232448, "layout over 227 KB");
};

// Q once, then K_j and V_j of kv tiles [jb, je) into the ring. With TMA
// one thread issues every load; otherwise the warpgroup loads and each of
// its threads arrives.
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const Params& p, unsigned char* smem,
                                        uint32_t base, int i0, int h, int hk,
                                        int b, int jb, int je, int tid) {
  using T = Tile<D>;
  const uint32_t q_full = base + T::bar_off;
  auto full_k = [&](int s) { return q_full + 8 * (1 + s); };
  auto full_v = [&](int s) { return q_full + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * STAGES + s); };
  auto k_tile = [&](int s) { return T::k_off + s * T::kv_bytes; };
  auto v_tile = [&](int s) { return T::v_off + s * T::kv_bytes; };
  if (p.vec) {
    if (tid != 0) return;
    mbar_expect_tx(q_full, T::q_bytes);
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) {
      tma_load_4d(base + T::q_off + c * BQ * T::SW, tq, q_full, c * T::CW,
                  i0, h, b);
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
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_plain<D>(smem, T::q_off, qg, p.q_ss, i0, p.S, BQ, tid);
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

// ---- consumers -----------------------------------------------------------------

// One consumer warpgroup's state and per-tile steps. Fragment layout of
// an m64nN accumulator: thread `lane` of warp `warp` holds rows 16*warp +
// lane/4 (h = 0) and +8 (h = 1) of the warpgroup's 64, and in each n8
// block i the columns 8i + 2(lane%4) and +1; element e of the array is
// block e/4, row h = (e/2)%2, column offset e%2.
template <int D>
struct Consumer {
  using T = Tile<D>;
  static constexpr int NO = T::CW / 2;  // O floats a chunk
  const Params& p;
  uint32_t base;  // aligned shared-memory base
  int w;          // consumer warpgroup: 0 or 1
  int lane;
  int i0w;        // the warpgroup's first query row
  int row0;       // global query row of fragment row h = 0
  int jb;         // first kv tile of the CTA
  float o[T::NCH][NO];
  float m[2], l[2];
  uint32_t pa[BK / 16][4];  // P in bf16, the A fragments of O += P V

  __device__ uint32_t bar(int i) const { return base + T::bar_off + 8 * i; }
  __device__ uint32_t full_k(int s) const { return bar(1 + s); }
  __device__ uint32_t full_v(int s) const { return bar(1 + STAGES + s); }
  __device__ uint32_t empty(int s) const { return bar(1 + 2 * STAGES + s); }

  // issue S = Q K^T of local tile t into s, once K_t has landed
  __device__ __forceinline__ void scores(float (&s)[32], int t) {
    const int st = t % STAGES;
    mbar_wait(full_k(st), (t / STAGES) & 1);
    const uint64_t dk = make_desc<D>(base + T::k_off + st * T::kv_bytes);
    uint64_t dq = make_desc<D>(base + T::q_off + 64 * w * T::SW);
    // opaque on every tile, so the compiler derives the k-steps from one
    // register pair here instead of holding all of them across the loop
    asm volatile("" : "+l"(dq));
    wgmma_fence();
    wgmma_ss_n64_first(s, dq, dk);
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) {
      wgmma_ss_n64(s, dq + kstep<D>(BQ, kk), dk + kstep<D>(BK, kk));
    }
    wgmma_commit();
    fence_regs(s);
  }

  // mask and online-softmax update on the score fragment of a tile at
  // key j0: s becomes p (fp32), m and l move on, and alpha is the rescale
  // O still owes (rescale())
  template <bool MASK>
  __device__ __forceinline__ void softmax(float (&s)[32], int j0,
                                          float (&alpha)[2]) {
    constexpr float L2E = 1.4426950408889634f;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = (e >> 1) & 1;
      if (MASK) {
        const int col = j0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        const int row = row0 + 8 * hh;
        bool vis = col < p.Skv;
        if (p.causal) vis = vis && col <= row;
        if (p.window > 0) vis = vis && col >= row - (p.window - 1);
        if (!vis) s[e] = -INFINITY;
      }
      mx[hh] = fmaxf(mx[hh], s[e]);
    }
    float neg_shift[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      // rows with no visible key yet keep m = -inf: shift by 0 there,
      // and the old accumulator (all zeros) is scaled by 0
      const float shift = m_new == -INFINITY ? 0.f : m_new;
      alpha[hh] = m[hh] == -INFINITY ? 0.f : ex2((m[hh] - shift) * L2E);
      neg_shift[hh] = -shift * L2E;
      m[hh] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int hh = (e >> 1) & 1;
      s[e] = ex2(fmaf(s[e], L2E, neg_shift[hh]));  // masked give exactly 0
      sum[hh] += s[e];
    }
    // each thread keeps its own part of the row sums; the four lanes of a
    // row add theirs in the epilogue
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
  }

  // softmax() of local tile t, with the compares only on edge tiles
  __device__ __forceinline__ void softmax_tile(float (&s)[32], int t,
                                               float (&alpha)[2]) {
    const int j0 = (jb + t) * BK;
    if (is_edge(i0w, 64, j0, p)) {
      softmax<true>(s, j0, alpha);
    } else {
      softmax<false>(s, j0, alpha);
    }
  }

  // P rounded to bf16 into pa, the A fragments of the PV product: the
  // accumulator layout, 16 columns at a time. The fences here and in
  // rescale() keep the compiler from sinking these writes past the next
  // wgmma issue, which would make it serialise the products.
  __device__ __forceinline__ void pack(const float (&s)[32]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pa[kk][q] = pack_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
      fence_regs(pa[kk]);
    }
  }

  __device__ __forceinline__ void rescale(const float (&alpha)[2]) {
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) {
#pragma unroll
      for (int e = 0; e < NO; ++e) o[c][e] *= alpha[(e >> 1) & 1];
      fence_regs(o[c]);
    }
  }

  // issue O += P V of local tile t, P from pa, once V_t has landed
  __device__ __forceinline__ void issue_pv(int t) {
    const int st = t % STAGES;
    mbar_wait(full_v(st), (t / STAGES) & 1);
    const uint32_t vt = base + T::v_off + st * T::kv_bytes;
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) fence_regs(o[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
        wgmma_rs(o[c], pa[kk], v_desc<D>(vt, kk, c));
    wgmma_commit();
  }

  // after the PV product of local tile t has completed: pin O and P in
  // their registers up to here (the product read and wrote them
  // asynchronously), and release the tile's K/V stage
  __device__ __forceinline__ void pv_done(int t) {
#pragma unroll
    for (int c = 0; c < T::NCH; ++c) fence_regs(o[c]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
    if (lane == 0) mbar_arrive(empty(t % STAGES));
  }

  // normalise O and store it and the LSE; rows past S are not written
  __device__ __forceinline__ void emit(int h, int b) {
    bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      const int row = row0 + 8 * hh;
      if (row >= p.S) continue;
      const float denom = fmaxf(l[hh], 1e-30f);
      bf16* orow = og + row * p.o_ss;
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
#pragma unroll
        for (int i = 0; i < T::CW / 8; ++i) {
          const int e = 4 * i + 2 * hh;
          *reinterpret_cast<__nv_bfloat162*>(
              orow + c * T::CW + 8 * i + 2 * (lane & 3)) =
              __floats2bfloat162_rn(o[c][e] / denom, o[c][e + 1] / denom);
        }
      if ((lane & 3) == 0) {
        p.lse[(static_cast<long long>(b) * p.H + h) * p.S + row] =
            l[hh] > 0.f ? m[hh] + logf(denom) : -INFINITY;
      }
    }
  }
};

// A consumer warpgroup's whole life: scale its Q rows, walk the kv tiles
// (K1: scores, softmax, PV, one after the other; K4: tile t's scores and
// tile t-1's PV in flight during tile t's softmax), emit.
template <int D, bool PIPE>
__device__ __forceinline__ void consume_all(const Params& p,
                                            unsigned char* smem,
                                            uint32_t base, int i0, int h,
                                            int b, int jb, int je, int w,
                                            int wt) {
  using T = Tile<D>;
  const int warp = wt / 32;
  const int lane = wt % 32;
  Consumer<D> c{p, base, w, lane, i0 + 64 * w,
                i0 + 64 * w + 16 * warp + lane / 4, jb};
#pragma unroll
  for (int k = 0; k < T::NCH; ++k)
#pragma unroll
    for (int e = 0; e < Consumer<D>::NO; ++e) c.o[k][e] = 0.f;
  c.m[0] = c.m[1] = -INFINITY;
  c.l[0] = c.l[1] = 0.f;

  // the reference's scale fold, in place on this warpgroup's 64 rows of
  // Q (the swizzle moves 16-byte units within a row, so the rows stay
  // contiguous), then handed to the async proxy
  mbar_wait(base + T::bar_off, 0);
#pragma unroll
  for (int k = 0; k < T::NCH; ++k) {
    unsigned char* rows = smem + T::q_off + k * BQ * T::SW + 64 * w * T::SW;
    for (int off = wt * 16; off < 64 * T::SW; off += WG * 16) {
      uint4 raw = *reinterpret_cast<const uint4*>(rows + off);
      bf16* x = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        x[e] = __float2bfloat16_rn(__bfloat162float(x[e]) * p.scale);
      }
      *reinterpret_cast<uint4*>(rows + off) = raw;
    }
  }
  fence_proxy_async();
  named_barrier(1 + w, WG);

  const int n = je - jb;
  float s[32], alpha[2];
  if (!PIPE) {
    for (int t = 0; t < n; ++t) {
      c.scores(s, t);
      wgmma_wait<0>();
      fence_regs(s);
      c.softmax_tile(s, t, alpha);
      c.pack(s);
      c.rescale(alpha);
      c.issue_pv(t);
      wgmma_wait<0>();
      c.pv_done(t);
    }
  } else if (n > 0) {
    // Tile t's scores are issued with tile t-1's PV product still to
    // run; both go in flight and tile t's softmax runs while the PV
    // product does. P and O's rescale for tile t wait for that product,
    // so O sees K1's operations in K1's order. No wgmma group is in
    // flight between two tiles, on every path, so the compiler can track
    // the groups and keeps them asynchronous.
    c.scores(s, 0);
    wgmma_wait<0>();
    fence_regs(s);
    c.softmax_tile(s, 0, alpha);
    c.pack(s);
    c.rescale(alpha);
    for (int t = 1; t < n; ++t) {
      c.scores(s, t);
      c.issue_pv(t - 1);
      wgmma_wait<1>();  // the scores, issued first
      fence_regs(s);
      c.softmax_tile(s, t, alpha);
      wgmma_wait<0>();
      c.pv_done(t - 1);
      c.pack(s);
      c.rescale(alpha);
    }
    c.issue_pv(n - 1);
    wgmma_wait<0>();
    c.pv_done(n - 1);
  }
  c.emit(h, b);
}

// K1 (PIPE = false) and K4 (PIPE = true), bf16
template <int D, bool PIPE>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ Params p) {
  using T = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x;
  // the q tile is the grid's slowest axis, the last (longest causal) first
  const int i0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (p.H / p.Hkv);
  int jb, je;
  kv_range(i0, BQ, p, &jb, &je);
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
    produce<D>(&tq, &tk, &tv, p, smem, base, i0, h, hk, b, jb, je, tid);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume_all<D, PIPE>(p, smem, base, i0, h, b, jb, je, role - 1,
                         tid % WG);
  }
}

}  // namespace tc

// ============================================================================
// host: tensor maps, launches, dispatch
// ============================================================================

constexpr int ERR_UNSUPPORTED = -1;  // a (dtype, head_dim) not built
constexpr int ERR_TENSOR_MAP = -2;   // the CUDA driver refused a tensor map

template <int D, bool PIPE>
int launch_tc(Params p, cudaStream_t stream) {
  using T = tc::Tile<D>;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  if (p.Skv == 0) p.vec = 0;  // no kv tile to load; a map needs rows
  if (p.vec) {
    const bool ok =
        encode_map<D>(&maps[0], p.q, p.S, p.H, p.B, p.q_ss, p.q_sh, p.q_sb,
                      tc::BQ) &&
        encode_map<D>(&maps[1], p.k, p.Skv, p.Hkv, p.B, p.k_ss, p.k_sh,
                      p.k_sb, BK) &&
        encode_map<D>(&maps[2], p.v, p.Skv, p.Hkv, p.B, p.v_ss, p.v_sh,
                      p.v_sb, BK);
    if (!ok) return ERR_TENSOR_MAP;
  }
  cudaError_t err = cudaFuncSetAttribute(
      tc::flash_fwd_tc_kernel<D, PIPE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(T::alloc));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(p.H, p.B, (p.S + tc::BQ - 1) / tc::BQ);
  tc::flash_fwd_tc_kernel<D, PIPE>
      <<<grid, tc::THREADS, T::alloc, stream>>>(maps[0], maps[1], maps[2], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_scalar(const Params& p, cudaStream_t stream) {
  using L = Layout<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<D><<<grid, NTHREADS, L::bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_scalar_pipelined(const Params& p, cudaStream_t stream) {
  using PL = PipeLayout<D>;
  static_assert(PL::bytes <= 232448, "pipelined layout over 227 KB");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_pipelined_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(PL::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((p.S + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_pipelined_kernel<D>
      <<<grid, PIPE_THREADS, PL::bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// the design by dtype: 1 = bf16 (Hopper), 0 = fp32 (scalar)
template <int D>
int launch_d(bool pipelined, int dtype, const Params& p,
             cudaStream_t stream) {
  if (dtype == 1) {
    return pipelined ? launch_tc<D, true>(p, stream)
                     : launch_tc<D, false>(p, stream);
  }
  if (dtype == 0) {
    return pipelined ? launch_scalar_pipelined<D>(p, stream)
                     : launch_scalar<D>(p, stream);
  }
  return ERR_UNSUPPORTED;
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
  switch (head_dim) {
    case 16: return launch_d<16>(pipelined, dtype, p, s);
    case 32: return launch_d<32>(pipelined, dtype, p, s);
    case 64: return launch_d<64>(pipelined, dtype, p, s);
    case 128: return launch_d<128>(pipelined, dtype, p, s);
    default: return ERR_UNSUPPORTED;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. Strides are in elements; the last dimension
// of q, k, v and o must be contiguous; vec = 1 when q, k and v are
// TMA-able (kernels/flash.py:tma_eligible). Returns 0, a cudaError_t
// value, -1 for a (dtype, head_dim) pair this library was not built for,
// or -2 when the driver refused a tensor map.
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
