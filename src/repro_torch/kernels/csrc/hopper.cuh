// Hopper (sm_90a) building blocks for the port's kernels: shared-memory
// addresses, mbarriers, TMA loads, 4-byte cp.async copies, flags between
// blocks (acquire / release), wgmma descriptors and fences, bf16 packing,
// and the host's tensor-map encoding;
// for the attention kernels (flash_fwd.cu, flash_bwd.cu) also their wgmma
// products, tile descriptors, TMA tile loads, bf16 row stores, ring
// barriers and the mask.  Header only; each including source keeps its own
// copy (inside an unnamed namespace).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Spin until the barrier's phase differs from `parity`.  A wait that
// outlasts ~2^34 cycles (seconds) can only be a broken pipeline: trap, so
// that the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// 4-byte asynchronous copy global -> shared; ok = false writes a zero and
// reads nothing.  Completion is tracked per thread in commit groups.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's commit groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Order this block's earlier reads of shared memory (generic proxy) before
// TMA's writes into the same bytes (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// A flag in device memory between blocks: read with acquire (later reads
// see what the writer wrote before its release) and written with release
// (after every thread of the writing block has fenced its writes).
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
// Spin until *p >= v.  As mbar_wait: a wait of ~2^34 cycles traps.
__device__ __forceinline__ void wait_flag(const int* p, int v) {
  long long start = 0;
  while (ld_acquire(p) < v) {
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
    __nanosleep(64);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of registers that an
// asynchronous product reads or writes across its wait.
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N, int M> __device__ __forceinline__ void fence_regs(uint32_t (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
// Shared-memory matrix descriptor, 128-byte swizzle.  K-major operands:
// rows of 128 bytes, 8-row groups SBO = 1024 bytes apart (LBO unused).
// MN-major: 64-element atoms along M or N LBO bytes apart, 8-row groups
// along K SBO = 1024 bytes apart.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Pack two floats into a bf16x2 word (lower address first).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Across the 4 lanes of a quad, lane p holds v[i] = words i of its own
// columns; afterwards lane q holds word q of lanes 0..3 in order: a 4 x 4
// transpose in two butterfly rounds.
__device__ __forceinline__ void quad_transpose(uint32_t& v0, uint32_t& v1, uint32_t& v2,
                                               uint32_t& v3, int q) {
  const bool odd = q & 1, high = q & 2;
  uint32_t s0 = odd ? v0 : v1, s1 = odd ? v2 : v3;
  s0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (odd) {
    v0 = s0;
    v2 = s1;
  } else {
    v1 = s0;
    v3 = s1;
  }
  s0 = high ? v0 : v2;
  s1 = high ? v1 : v3;
  s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (high) {
    v0 = s0;
    v1 = s1;
  } else {
    v2 = s0;
    v3 = s1;
  }
}

// ---- attention tiles: wgmma products, TMA tiles, the mask -------------------

constexpr int BOX = 64;  // 64 bf16 = 128 bytes, the swizzle span

// d (32 fp32 a thread) = (scale_d ? d : 0) + A(64 x 16) B(16 x 64), both read
// from shared memory through descriptors, both K-major.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (32 fp32 a thread) += A(64 x 16) B(16 x 64): A as bf16 pairs in registers
// (the accumulator's layout), B read from shared memory MN-major.
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 fp32 a thread) += A(64 x 16) B(16 x 128): A as bf16 pairs in registers
// (the accumulator's layout), B read from shared memory MN-major.
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void mma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) mma_rs_n64(d, a, db);
  else mma_rs_n128(d, a, db);
}

// K-major descriptor of k-step ks (16 columns) of rows [r, r + 64) of a
// tile of `rows` rows stored as D / 64 boxes of rows x 128 bytes.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int r, int ks) {
  return make_desc(tile + (ks / 4) * rows * 128 + r * 128 + (ks % 4) * 32, 16, 1024);
}
// MN-major descriptor of k-step kk (16 rows) of a tile of `rows` rows stored
// as above: the 64-column atoms along N lie rows * 128 bytes apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  return make_desc(tile + kk * 16 * 128, rows * 128, 1024);
}

// TMA of the rows x D tile at `row` of head `head` of a 3-D [heads, T, D]
// map into D / 64 boxes.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int row, int head) {
#pragma unroll
  for (int c = 0; c < D / BOX; ++c) tma_3d(dst + c * ROWS * 128, map, bar, c * BOX, row, head);
}

// Thread (warp, lane) of a consumer warpgroup holds accumulator rows
// 16 warp + lane / 4 (+ 8) and, for column group j, columns
// 8 j + 2 (lane % 4) (+ 1) in acc[4 j .. 4 j + 3].  Element e of group j:
// row half e / 2, column 8 j + 2 (lane % 4) + e % 2.  Two groups 2kk and
// 2kk + 1 of a 64-column S tile are the A operand of k-step kk.
__device__ __forceinline__ void to_operand(uint32_t (&a)[4][4], int j, float e0, float e1,
                                           float e2, float e3) {
  a[j / 2][2 * (j % 2)] = pack_bf16(e0, e1);
  a[j / 2][2 * (j % 2) + 1] = pack_bf16(e2, e3);
}

// Write a warpgroup's 64 x D accumulator as bf16 rows [row0, row0 + 64) of
// out ([T, D] row-major), rows at or past rows_end skipped: 16-byte stores
// of 8 columns after a transpose across each quad.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], __nv_bfloat16* out,
                                           int row0, int rows_end) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + warp * 16 + lane / 4 + 8 * h;
#pragma unroll
    for (int jj = 0; jj < D / 32; ++jj) {
      uint32_t v0 = pack_bf16(acc[16 * jj + 2 * h], acc[16 * jj + 2 * h + 1]);
      uint32_t v1 = pack_bf16(acc[16 * jj + 4 + 2 * h], acc[16 * jj + 5 + 2 * h]);
      uint32_t v2 = pack_bf16(acc[16 * jj + 8 + 2 * h], acc[16 * jj + 9 + 2 * h]);
      uint32_t v3 = pack_bf16(acc[16 * jj + 12 + 2 * h], acc[16 * jj + 13 + 2 * h]);
      quad_transpose(v0, v1, v2, v3, q);
      if (r < rows_end)
        *reinterpret_cast<uint4*>(out + (size_t)r * D + 32 * jj + 8 * q) =
            make_uint4(v0, v1, v2, v3);
    }
  }
}

// The first 1024-aligned byte of dynamic shared memory at or after raw
// (the 128-byte swizzle repeats every 1024 bytes).
__device__ __forceinline__ uint8_t* aligned_base(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Barriers of a ring of `stages` stages and one for the resident tiles:
// full[i] (the producer warp's 32 lanes and TMA's bytes), empty[i] (one
// arrival from each of `readers` consumer warpgroups), then resident.
__device__ __forceinline__ void init_bars(uint64_t* bars, int stages, int readers) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&bars[i], 32);
      mbar_init(&bars[stages + i], readers);
    }
    mbar_init(&bars[2 * stages], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The attention mask: same segment, segment > 0, causal and window on
// positions (window < 0: none).
__device__ __forceinline__ bool attends(int qs, int qp, int ks, int kp, int causal,
                                        int window) {
  bool ok = (qs == ks) && (qs > 0);
  if (causal) ok = ok && (kp <= qp);
  if (window >= 0) ok = ok && (qp - kp < window);
  return ok;
}

// ---- host -------------------------------------------------------------------

// Dynamic shared memory above 48 KB must be allowed once per kernel and
// device; `sized` holds a bit per device where it has been.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, unsigned& sized) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (sized >> dev & 1u) return cudaSuccess;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess) sized |= 1u << dev;
  return rc;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime, so the
// library needs no link against libcuda.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                   cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A tensor map of `rank` dims (innermost first), strides in bytes for dims
// 1.., the box in elements, zero fill past the edges; bf16 with 128-byte
// swizzle unless another element type or swizzle is given.
inline bool make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box,
                     CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encoder();
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, type, rank, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The [heads, T, D] bf16 tensor at ptr as a 3-D map with boxes of 64
// columns by `rows` rows of one head: a box that runs past T reads zeros,
// never the next head's rows.
inline bool head_map(CUtensorMap* map, const void* ptr, int heads, int T, int D, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {BOX, (cuuint32_t)rows, 1};
  return make_map(map, ptr, 3, dims, strides, box);
}

}  // namespace hopper
}  // namespace
