// Decode attention straight from the int8 KV cache, for Hopper (sm_90a),
// with a plain C interface that tpushare_torch/kernels/kv_decode.py loads
// through ctypes.
//
// It replaces no TPU kernel. The reference's decode step
// (tpushare/workloads/model.py, forward_cached) is an einsum over the whole
// int8 buffer, and XLA fuses the int8 convert into the dot. Eagerly, the
// same einsum casts every layer's [B, M, nkv, hd] int8 K and V to the
// activation dtype, copies them into the permuted layout the batched
// products need, and runs seven fp32 passes over [B, nkv, reps, 1, M]
// scores, over every position of every slot, live or not.
//
// The function, for one bf16 decode query per row (T = 1) at head_dim 128:
// for row b and query head j of kv head h = j / reps,
//   s_m  = (q[b, j] . k_int8[b, m, h]) * ks[b, m, h] * hd^-0.5
//   out  = sum_m softmax(s)_m * vs[b, m, h] * v_int8[b, m, h]
// over the row's keys lo[b] <= m < hi[b] only. A row with lo >= hi (an
// inactive slot) gets 0. The scores stay in fp32 from the product on.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes. Each live key costs
// nkv * (2 * hd + 8) bytes (int8 K and V and their fp32 scales) for
// 4 * reps * hd FLOPs, about 2 FLOPs a byte. At the chat cell's mean
// (~16k live keys a step, nkv = 8, hd = 128) a layer moves ~34 MB: ~10 us.
// On the CUDA cores alone it is bound by neither: the int8 conversions,
// fp32 FMAs and shuffles come to ~66 warp instructions a (key, kv head),
// bound by issue and latency at ~4x the byte bound; on the tensor cores
// (below) ~27, at 3 CTAs an SM.
//
// The design:
// - A row's span is cut into chunks of kChunk positions. The split kernel
//   runs one CTA of 128 threads per (split x, kv head, row), which takes
//   the row's chunks x, x + splits, ...; the wrapper picks splits so that
//   the grid fills the card. A CTA with no chunk exits at once, so only
//   live keys are read. Each CTA writes one partial (max, denominator, hd
//   sums) per query head into scratch the wrapper allocates, and the merge
//   kernel, one thread per (row, query head, dim), folds a row's partials
//   into the bf16 output.
// - int8 -> fp32 is exact and costs no I2F conversion (a quarter of the
//   FMA rate on this card): the byte, biased by 128, is permuted under
//   the exponent of 2^23 (0x4B0000xx), and 2^23 + 128 is subtracted.
//
// Layouts: q [B, nkv * reps, 128] and out [B, nkv * reps * 128] bf16,
// contiguous; k, v [B, M, nkv, 128] int8 and ks, vs [B, M, nkv] fp32,
// contiguous (one layer of the cache, read in place); lo, hi [B] int32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadDim = 128;
constexpr int kTilesPerChunk = 4;  // a warp's tiles of 16 positions a chunk
constexpr int kChunk = kWarps * kTilesPerChunk * 16;
constexpr int ERR_UNSUPPORTED = -1;

// exp2(x - m) with the running max m possibly -inf (nothing seen yet)
__device__ __forceinline__ float shifted_exp2(float x, float m) {
  return exp2f(x - (m == -INFINITY ? 0.0f : m));
}

// -- the split kernel, on the tensor cores ----------------------------------
//
// Each warp takes 16 positions a step on mma.sync m16n8k16 (bf16 in, fp32
// out):
// - QK: A = the group's query heads as 16 rows (rows past reps are 0), B =
//   K^T of 8 positions, 8 k-steps over the 128 dims, two n-tiles a step.
// - PV, transposed so the probabilities need no shuffle: O^T (16 dims x 8
//   heads) += V^T (16 dims x 16 positions) P^T (16 positions x 8 heads).
//   The QK accumulator of lane (g, t) holds head g's scores at positions
//   2t, 2t+1 (and 8 + the same), which is just the B fragment of P^T.
// - A dot product does not care in which order it visits the dims, nor an
//   output in which order it holds them, so both are permuted until every
//   lane's fragments are whole 16-byte loads: for QK lane t reads dims
//   [16t, 16t + 16) and [64 + 16t, 80 + 16t) of K (and of q), and for PV
//   lane g reads dims [16g, 16g + 16) of V; k-step j takes word j of
//   those, m-tile mt bytes 2mt and 2mt + 1.
// - int8 -> bf16 is exact: the fp32 trick above, then the top half of the
//   fp32 word (an integer of at most 8 bits fits bf16's significand).
// - The next tile's loads are issued before the current tile is computed.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// byte i of u, each byte biased by 128, as an exact fp32
__device__ __forceinline__ float biased_byte(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) -
         8388736.0f;
}

// two integer-valued floats as bf16x2 (lo in the low half), exactly
__device__ __forceinline__ uint32_t bf16x2_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&two);
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

__device__ __forceinline__ uint4 biased(uint4 r) {
  return make_uint4(r.x ^ 0x80808080u, r.y ^ 0x80808080u,
                    r.z ^ 0x80808080u, r.w ^ 0x80808080u);
}

// one warp's step: 16 positions from base; K rows base + g, base + 8 + g;
// V rows and scales at base + 2t, 2t + 1, 2t + 8, 2t + 9
struct Tile {
  uint4 k[4];
  uint4 v[4];
  float ks[4], vs[4];
};

template <int REPS>
__global__ void __launch_bounds__(kThreads)
kv_decode_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const int* __restrict__ lo, const int* __restrict__ hi,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int M, int nkv, float scale_log2) {
  const int x = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int row_lo = lo[b], row_hi = hi[b];
  const int chunks =
      row_hi > row_lo ? (row_hi - row_lo + kChunk - 1) / kChunk : 0;
  if (x >= chunks) return;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;

  // q's A fragments: row g's dims [16t, 16t + 16) and [64 + 16t, 80 + 16t)
  uint32_t qw[16];
  if (g < REPS) {
    const __nv_bfloat16* qr =
        q + ((size_t)b * nkv * REPS + (size_t)h * REPS + g) * kHeadDim;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint4 r = *reinterpret_cast<const uint4*>(qr + 64 * half +
                                                        16 * t + 8 * i);
        qw[8 * half + 4 * i] = r.x;
        qw[8 * half + 4 * i + 1] = r.y;
        qw[8 * half + 4 * i + 2] = r.z;
        qw[8 * half + 4 * i + 3] = r.w;
      }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) qw[i] = 0u;
  }

  const size_t pos_stride = (size_t)nkv * kHeadDim;
  const size_t row = (size_t)b * M;
  const int8_t* kb = k + row * pos_stride + (size_t)h * kHeadDim;
  const int8_t* vb = v + row * pos_stride + (size_t)h * kHeadDim;
  const float* ksb = ks + row * nkv + h;
  const float* vsb = vs + row * nkv + h;

  // the warp's n-th tile: chunk x + splits * (n / 4), tile warp + 4 (n % 4)
  // of it; past the row's last key there are no more (INT_MAX)
  auto tile_base = [&](int n) {
    const int c = x + splits * (n / kTilesPerChunk);
    const int base = row_lo + c * kChunk +
                     16 * (warp + kWarps * (n % kTilesPerChunk));
    return c < chunks && base < row_hi ? base : INT_MAX;
  };
  auto load = [&](int base, Tile& tl) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int p = base + 8 * nt + g;
      if (p < row_hi) {
        const int8_t* kp = kb + p * pos_stride + 16 * t;
        tl.k[2 * nt] = __ldg(reinterpret_cast<const uint4*>(kp));
        tl.k[2 * nt + 1] = __ldg(reinterpret_cast<const uint4*>(kp + 64));
      } else {
        tl.k[2 * nt] = tl.k[2 * nt + 1] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = base + 2 * t + (i & 1) + 8 * (i >> 1);
      if (p < row_hi) {
        tl.v[i] = __ldg(reinterpret_cast<const uint4*>(vb + p * pos_stride +
                                                       16 * g));
        tl.ks[i] = __ldg(ksb + (size_t)p * nkv);
        tl.vs[i] = __ldg(vsb + (size_t)p * nkv);
      } else {
        tl.v[i] = make_uint4(0u, 0u, 0u, 0u);
        tl.ks[i] = tl.vs[i] = 0.0f;
      }
    }
  };

  float m = -INFINITY, l = 0.0f;  // head g's, over this lane's positions
  float acc[8][4];                // O^T: dims 16g + 2mt (+1) x heads 2t, 2t+1
#pragma unroll
  for (int mt = 0; mt < 8; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[mt][i] = 0.0f;

  int base = tile_base(0);
  Tile cur, nxt;
  if (base != INT_MAX) load(base, cur);
  for (int n = 0; base != INT_MAX; ++n) {
    const int next = tile_base(n + 1);
    if (next != INT_MAX) load(next, nxt);

    float sc[2][4] = {};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t w = word(biased(cur.k[2 * nt + j / 4]), j % 4);
        mma_bf16(sc[nt], qw[2 * j], 0u, qw[2 * j + 1], 0u,
                 bf16x2_exact(biased_byte(w, 0), biased_byte(w, 1)),
                 bf16x2_exact(biased_byte(w, 2), biased_byte(w, 3)));
      }
    }
    // lane (g, t): head g at positions base + 2t, 2t + 1, 2t + 8, 2t + 9
    float s[4] = {sc[0][0], sc[0][1], sc[1][0], sc[1][1]};
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = base + 2 * t + (i & 1) + 8 * (i >> 1);
      s[i] = p < row_hi ? s[i] * cur.ks[i] * scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m, mx);
    const float corr = shifted_exp2(m, mx);
    m = mx;
    float pv[4];
    l *= corr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = shifted_exp2(s[i], mx);
      l += p;
      pv[i] = p * cur.vs[i];
    }
    const uint32_t pb0 = bf16x2_rn(pv[0], pv[1]);
    const uint32_t pb1 = bf16x2_rn(pv[2], pv[3]);
    // the accumulator's heads are 2t and 2t + 1: their lanes' rescales
    const float corr_lo = __shfl_sync(0xffffffffu, corr, 8 * t);
    const float corr_hi = __shfl_sync(0xffffffffu, corr, 8 * t + 4);
    uint4 vr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) vr[i] = biased(cur.v[i]);
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      acc[mt][0] *= corr_lo;
      acc[mt][1] *= corr_hi;
      acc[mt][2] *= corr_lo;
      acc[mt][3] *= corr_hi;
      const int i0 = 2 * (mt & 1);
      const uint32_t x0 = word(vr[0], mt / 2), x1 = word(vr[1], mt / 2);
      const uint32_t y0 = word(vr[2], mt / 2), y1 = word(vr[3], mt / 2);
      mma_bf16(acc[mt],
               bf16x2_exact(biased_byte(x0, i0), biased_byte(x1, i0)),
               bf16x2_exact(biased_byte(x0, i0 + 1), biased_byte(x1, i0 + 1)),
               bf16x2_exact(biased_byte(y0, i0), biased_byte(y1, i0)),
               bf16x2_exact(biased_byte(y0, i0 + 1), biased_byte(y1, i0 + 1)),
               pb0, pb1);
    }
    cur = nxt;
    base = next;
  }

  // merge the warps: each to the CTA's max, summed through shared memory
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  __shared__ float sm_m[kWarps][8];
  __shared__ float sm_l[kWarps][8];
  __shared__ float sm_acc[kWarps][REPS][kHeadDim];
  if (t == 0) {
    sm_m[warp][g] = m;
    sm_l[warp][g] = l;
  }
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int head = 2 * t + hh;
    if (head < REPS) {
      float cta_m = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) cta_m = fmaxf(cta_m, sm_m[w][head]);
      // warp 0 holds the chunk's first key, so cta_m is finite
      const float f = exp2f(sm_m[warp][head] - cta_m);
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        sm_acc[warp][head][16 * g + 2 * mt] = acc[mt][hh] * f;
        sm_acc[warp][head][16 * g + 2 * mt + 1] = acc[mt][2 + hh] * f;
      }
    }
  }
  __syncthreads();
  const size_t part = ((size_t)b * nkv + h) * splits + x;
  float* out_acc = part_acc + part * REPS * kHeadDim;
  for (int i = tid; i < REPS * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, d = i % kHeadDim;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += sm_acc[w][r][d];
    out_acc[i] = sum;
  }
  if (tid < REPS) {
    float cta_m = -INFINITY, sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) cta_m = fmaxf(cta_m, sm_m[w][tid]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sum += sm_l[w][tid] * exp2f(sm_m[w][tid] - cta_m);
    part_ml[(part * REPS + tid) * 2] = cta_m;
    part_ml[(part * REPS + tid) * 2 + 1] = sum;
  }
}

template <int REPS>
__global__ void __launch_bounds__(kThreads)
kv_decode_merge_kernel(const float* __restrict__ part_ml,
                       const float* __restrict__ part_acc,
                       const int* __restrict__ lo, const int* __restrict__ hi,
                       __nv_bfloat16* __restrict__ out, int nkv, int splits) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;  // head * hd + dim
  if (j >= nkv * REPS * kHeadDim) return;
  const int head = j / kHeadDim, d = j % kHeadDim;
  const int h = head / REPS, r = head % REPS;
  const int span = hi[b] - lo[b];
  const int n = min(splits, span > 0 ? (span + kChunk - 1) / kChunk : 0);
  const size_t first = ((size_t)b * nkv + h) * splits;
  float mx = -INFINITY;
  for (int c = 0; c < n; ++c)
    mx = fmaxf(mx, part_ml[((first + c) * REPS + r) * 2]);
  float sum = 0.0f, acc = 0.0f;
  for (int c = 0; c < n; ++c) {
    const size_t part = first + c;
    const float f = exp2f(part_ml[(part * REPS + r) * 2] - mx);
    sum += part_ml[(part * REPS + r) * 2 + 1] * f;
    acc += part_acc[(part * REPS + r) * kHeadDim + d] * f;
  }
  out[(size_t)b * nkv * REPS * kHeadDim + j] =
      __float2bfloat16_rn(n ? acc / sum : 0.0f);
}

struct Args {
  const __nv_bfloat16* q;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const int* lo;
  const int* hi;
  float* part_ml;
  float* part_acc;
  __nv_bfloat16* out;
  int B, M, nkv, splits;
  float scale_log2;
};

template <int REPS>
int launch(const Args& a, cudaStream_t s) {
  const dim3 split(a.splits, a.nkv, a.B);
  kv_decode_tc_kernel<REPS><<<split, kThreads, 0, s>>>(
      a.q, a.k, a.v, a.ks, a.vs, a.lo, a.hi, a.part_ml, a.part_acc, a.M,
      a.nkv, a.scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 merge((a.nkv * REPS * kHeadDim + kThreads - 1) / kThreads,
                   a.B);
  kv_decode_merge_kernel<REPS><<<merge, kThreads, 0, s>>>(
      a.part_ml, a.part_acc, a.lo, a.hi, a.out, a.nkv, a.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The positions of one chunk: a row's span is cut into chunks, and split
// CTA x of a (row, kv head) takes chunks x, x + splits, ... (more splits
// than a row's chunks only adds CTAs that exit).
int tpushare_kv_decode_chunk(void) { return kChunk; }

// q and out bf16 at head_dim 128. part_ml holds B * nkv * splits * reps *
// 2 floats, part_acc B * nkv * splits * reps * 128. Returns 0, a
// cudaError_t value, or -1 for query heads per kv head (reps) other than
// 1, 2, 4 or 8.
int tpushare_kv_decode(int device, int reps, const void* q, const void* k,
                       const void* v, const float* ks, const float* vs,
                       const int* lo, const int* hi, float* part_ml,
                       float* part_acc, void* out, int B, int M, int nkv,
                       int splits, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const int8_t*>(k);
  a.v = static_cast<const int8_t*>(v);
  a.ks = ks;
  a.vs = vs;
  a.lo = lo;
  a.hi = hi;
  a.part_ml = part_ml;
  a.part_acc = part_acc;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B;
  a.M = M;
  a.nkv = nkv;
  a.splits = splits;
  a.scale_log2 = scale * 1.4426950408889634f;  // softmax in exp2
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (reps) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 4: return launch<4>(a, s);
    case 8: return launch<8>(a, s);
    default: return ERR_UNSUPPORTED;
  }
}

const char* tpushare_kv_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
