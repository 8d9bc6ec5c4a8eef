// Hopper (sm_90a) building blocks shared by the bf16 flash kernels of
// flash_fwd.cu (K1, K4) and flash_bwd.cu (K2, K3): the swizzled tile
// layout TMA writes, mbarriers, TMA loads, wgmma descriptors and
// instructions, register fences, the plain-load fallback of the producer,
// and the host's tensor-map encoding.
//
// Tiles are bf16 [rows][D] with D in 16, 32, 64, 128, stored as NCH
// chunks of rows x SW bytes, each row swizzled as TMA's SWIZZLE_<SW>B
// writes it: rows of 2*D bytes take the 32-byte swizzle at D = 16, the
// 64-byte one at D = 32 and the 128-byte one at D >= 64; at D = 128 a row
// is 256 bytes, so each tile is two 64-column chunks. Every tile starts on
// a 1024-byte boundary, the swizzle's period.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr int WG = 128;  // threads of a warpgroup

// The swizzle of a tile at head dim D.
template <int D>
struct Swz {
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // swizzle bytes
  static constexpr int CW = SW / 2;                      // columns a chunk
  static constexpr int NCH = D / CW;                     // chunks a row
  // the swizzle XORs byte-address bits [4, 4+log2(SW/16)) with the bits
  // three above them (CUTLASS's Swizzle<log2(SW/16), 4, 3>)
  static constexpr uint32_t MASK = SW == 128 ? 0x70 : SW == 64 ? 0x30 : 0x10;
  // wgmma descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
};

// byte offset of element (r, col) in a swizzled tile of R rows
template <int D>
__device__ __forceinline__ uint32_t swizzled(int r, int col, int R) {
  using T = Swz<D>;
  const uint32_t a = r * T::SW + (col % T::CW) * 2;
  return (col / T::CW) * R * T::SW + (a ^ ((a >> 3) & T::MASK));
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed. A wait that
// lasts 10 s traps: a lost arrival becomes a launch failure that the
// caller sees, not a card that hangs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (start == 0) {
      start = now;
    } else if (now - start > 10000000000ull) {
      __trap();
    }
  }
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operands, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- TMA -----------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor of a tile at `addr` with head dim D:
// start address and stride byte offset (16-byte units), swizzle layout.
// 8-row groups are 8 * SW bytes apart (SBO), along N for a K-major
// operand ([n][k], k contiguous), along K for an MN-major one ([k][n]).
// The leading byte offset (bits 16-29) is left at 1: K-major swizzled
// operands ignore it, and each MN-major instruction covers one swizzle
// atom along N. The base offset is 0, since every tile starts on the
// swizzle period.
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  using T = Swz<D>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * T::SW) >> 4) << 32) | (T::LAYOUT << 62);
}

// the descriptor increment of k-step kk (columns 16kk..16kk+15) in a tile
// whose chunks hold chunk_rows rows: within a chunk the step is a 32-byte
// move of the start address, which the hardware swizzles like the rest
template <int D>
__device__ __forceinline__ constexpr uint64_t kstep(int chunk_rows, int kk) {
  using T = Swz<D>;
  return ((16 * kk / T::CW) * chunk_rows * T::SW + (16 * kk % T::CW) * 2) >>
         4;
}

// A [k][n] tile of `rows` rows (n = the D columns contiguous) as the
// MN-major B operand of a product that sums over its rows: V in O += P V,
// K in dQ += dS K, dO and Q in dV += P^T dO and dK += dS^T Q. k-step kk
// covers rows 16kk..16kk+15, two 8-row groups; one instruction covers one
// chunk of CW columns.
template <int D>
__device__ __forceinline__ uint64_t v_desc(uint32_t tile, int kk, int chunk,
                                           int rows = 64) {
  using T = Swz<D>;
  return make_desc<D>(tile + chunk * rows * T::SW + 16 * kk * T::SW);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator registers across an async
// wgmma (CUTLASS's warpgroup_fence_operand)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D = A B^T (first k-step) and D += A B^T, m64n64k16, A and B K-major
// from shared memory. The first step's outputs are write-only, so the
// previous tile's values are dead before it and need no registers.
__device__ __forceinline__ void wgmma_ss_n64_first(float (&d)[32],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D += A B, m64nNk16 with N = 16, 32 or 64: A (bf16) from registers, B
// MN-major from shared memory (transpose flag set)
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- producer ------------------------------------------------------------------

// A tile of R rows from global memory with plain loads, for rows TMA
// cannot read: the layout TMA would write (rows past rows_total zero),
// then handed to the async proxy. Called by the whole producer warpgroup.
template <int D>
__device__ __forceinline__ void load_plain(unsigned char* smem,
                                           uint32_t tile, const bf16* g,
                                           long long row_stride, int row0,
                                           int rows_total, int R, int tid) {
  for (int idx = tid; idx < R * D; idx += WG) {
    const int r = idx / D;
    const int col = idx % D;
    const bf16 x = row0 + r < rows_total
                       ? g[static_cast<long long>(row0 + r) * row_stride + col]
                       : __float2bfloat16_rn(0.f);
    *reinterpret_cast<bf16*>(smem + tile + swizzled<D>(r, col, R)) = x;
  }
  fence_proxy_async();
}

// ---- host: tensor maps ---------------------------------------------------------

// cuTensorMapEncodeTiled from the CUDA driver through the runtime, so the
// library needs no -lcuda
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
    }
  }
  return fn;
}

// A 4-D map over (D, rows, heads, batch) of a bf16 tensor with the
// caller's element strides; its box is one chunk (CW columns) of
// box_rows rows, swizzled as the kernels' tiles are. TMA zero-fills the
// rows of a box past `rows`.
template <int D>
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int heads,
                int batch, long long s_row, long long s_head,
                long long s_batch, int box_rows) {
  using T = Swz<D>;
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const long long elem[3] = {s_row, s_head, s_batch};
  cuuint64_t strides[3];
  cuuint64_t below = D * 2;  // bytes spanned by the dimensions below
  for (int i = 0; i < 3; ++i) {
    // a dimension of size 1 is never stepped along, whatever its stride
    strides[i] = dims[i + 1] == 1 ? below : elem[i] * 2;
    below = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::CW),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
