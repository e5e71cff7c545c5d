// Grouped GEMM for MoE expert dispatch on Hopper (sm_90a): the expert
// products (gmm) and their weight gradient (tgmm).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/grouped_gemm.py and
// computes what they compute:
//   * gmm  (`_gmm_kernel`, :56; `_gmm` :85)
//       out[M, N] = x[M, K] @ w[group(m)] over expert groups that are sorted
//       and contiguous: row m belongs to expert e iff
//       offsets[e] <= m < offsets[e + 1].  Rows at or beyond offsets[E]
//       (padding) come out exactly 0.  With `trans_w` the weights are read
//       as w[E, N, K] and multiplied transposed: the dx of the forward
//       product, with no transposed copy of w.
//   * tgmm (`_tgmm_kernel`, :105; `_tgmm` :135)
//       dw[E, K, N] = sum over rows s of group e of x[s]^T dy[s]; an empty
//       expert's dw is exactly 0.
//   * bf16 or fp32 in, fp32 accumulation, out in the input type.  For bf16
//     every product of two bf16 values is exact in fp32, as the JAX
//     package's upcast dot is.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s).  granite-moe-3b-a800m's
// training batch (M ~ 10^5 rows, two thirds routed; K, N in {512, 1536})
// sits at the balance point: the routed rows' 2*K*N operations over the
// tensor-core rate and the bytes (x's routed rows, the live experts'
// weights, every output row) over the memory rate both come to ~0.11 ms
// a product.  The tensor cores have to be kept fed: on the H100 a 64-deep
// stage of a 128 x 256 tile takes ~0.9 us against ~0.58 us of tensor work,
// and a tile's operands come from L2 again and again (an expert's weights
// for every m-tile, x's rows for every n-tile).  Wide tiles move fewer
// operand bytes per operation (128 x 256 beat 128 x 128 at every granite
// shape); sharing B between two CTAs of a cluster by TMA multicast, which
// halves B's L2 reads, was no faster, so L2's rate is not what holds the
// stage time.  The decode shape (M = 64, 1-3 rows an expert) is bound by
// reading the live experts' weights once (~0.016 ms), so there every SM
// has to stream weights.
//
// bf16 design (the training and serving path):
//   * Tensor cores through wgmma.mma_async m64n256k16: bf16 in, fp32
//     accumulators in registers, both operands read from shared memory
//     laid out in the 128-byte swizzle TMA writes.
//   * Warp specialisation, 384 threads: warpgroups 0 and 1 consume (64
//     rows each of a 128 x 256 output tile), warpgroup 2 produces: one
//     thread keeps a ring of 4 stages (64 deep, 48 KB each) filled by TMA,
//     with a full and an empty mbarrier a stage.  setmaxnreg moves registers from the producer (40) to the
//     consumers (232).  Tensor maps are encoded on the host at each
//     launch: x 2-D [M, K]; w 3-D [E, K, N] (or [E, N, K]) so an expert is
//     a coordinate and a box never reads a neighbour's weights; TMA
//     zero-fills what lies past an edge.
//   * gmm schedule: persistent, one block an SM.  A tile starts at an
//     expert's first row plus a multiple of 128, so no tile straddles a
//     seam; rows of the box past the expert's end are multiplied and not
//     stored.  Each block stages offsets in shared memory and builds the
//     schedule (a warp's prefix sum of ceil(n_e / 128) x n-tiles), then
//     walks tile ids blockIdx.x, +gridDim.x, n-tiles fastest (neighbouring
//     blocks share the expert's rows and weights in L2); the zero tiles of
//     the padding rows [offsets[E], M) come last.  A warpgroup whose 64
//     rows hold none of the expert's skips the product (decode).
//   * tgmm: the same ring and multiply with A = x^T and B = dy, both
//     MN-major; the reduction walks the expert's rows 64 at a time.  Rows
//     of the expert's last chunk that belong to the next expert are zeroed
//     in shared memory (then fence.proxy.async) before wgmma reads them.
//     An expert holding more than T = routed * tiles / (4 * SMs) rows
//     splits its walk into ceil(n_e / T) pieces; each piece writes fp32
//     partials to a workspace the wrapper sizes from the shapes alone,
//     and a second kernel adds them in split order (no atomics: two
//     launches give bitwise-equal dw).
//   * Epilogue: bf16 in registers, a 4 x 4 transpose across each quad of
//     lanes so that a lane holds 8 consecutive columns, 16-byte stores
//     masked to the expert's rows and the matrix's columns.  It is not
//     overlapped with the next tile's products.
//   * No host read of the offsets: the kernels take them on the device.
//
// fp32 (the agreement runs) keeps the simple design: one block per
// (m-tile, n-tile, split) of gmm or (expert, K-tile, N-tile) of tgmm,
// two-stage cp.async copies, scalar FMAs over 64 x 64 tiles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;      // fp32 kernels
constexpr int MAX_EXPERTS = 512;  // offsets staged in shared memory

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// =====================================================================
// fp32: cp.async tiles and scalar FMAs.
// =====================================================================
template <typename T> struct Tiles;
// 64 x 64 output tiles, 16 deep; rows padded by 4 elements.
template <> struct Tiles<float> {
  static constexpr int BM = 64, BN = 64, BK = 16, PAD = 4;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: read nothing, fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the R x C tile at (r0, c0) of a row-major matrix (leading dimension
// ld) into shared memory with row stride LDS.  Rows outside [r_lo, r_hi)
// and columns at or past c_hi are zero-filled.  C and c_hi are multiples of
// the 16-byte vector, so a vector is all in or all out.
template <typename T, int R, int C, int LDS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long ld, int r0, int c0,
                                          int r_lo, int r_hi, int c_hi) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = C / VEC;
  constexpr int CHUNKS = R * PER_ROW;
  static_assert(C % VEC == 0 && LDS % VEC == 0, "tile rows must be whole vectors");
#pragma unroll
  for (int j = 0; j < (CHUNKS + THREADS - 1) / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (CHUNKS % THREADS != 0 && i >= CHUNKS) break;
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const int gr = r0 + r, gc = c0 + c;
    const bool ok = gr >= r_lo && gr < r_hi && gc < c_hi;
    cp_async16(dst + r * LDS + c, ok ? src + (size_t)gr * ld + gc : src, ok);
  }
}

// The block's BM x BN accumulator tile, fed by products of shared-memory
// tiles: A(m, k) = a[m * lda + k] (or a[k * lda + m] when ACOL) and
// B(k, n) = b[k * ldb + n] (or b[n * ldb + k] when BCOL), k < KLEN.
template <typename T> struct Acc;

template <> struct Acc<float> {
  float c[4][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
  }

  template <bool ACOL, bool BCOL, int KLEN>
  __device__ void mma(const float* a, int lda, const float* b, int ldb) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int k = 0; k < KLEN; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = ty + 16 * i;
        av[i] = ACOL ? a[k * lda + m] : a[m * lda + k];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        bv[j] = BCOL ? b[n * ldb + k] : b[k * ldb + n];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
    }
  }

  __device__ void store(float* out, long ld, int r0, int c0, int row_lo, int row_hi,
                        int cols_hi) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + ty + 16 * i, col = c0 + tx + 16 * j;
        if (r >= row_lo && r < row_hi && col < cols_hi) out[(size_t)r * ld + col] = c[i][j];
      }
  }
};

// out[M, N] = x[M, K] @ w[e] per expert group; w[e] is [K, N], or [N, K]
// read transposed when TRANS.  Grid (n-tiles, m-tiles, splits): block z
// takes every splits-th expert of its tile.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(THREADS, 2)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const int* __restrict__ offsets, T* __restrict__ out, int M, int K, int N,
           int E) {
  constexpr int BM = Tiles<T>::BM, BN = Tiles<T>::BN, BK = Tiles<T>::BK;
  constexpr int PAD = Tiles<T>::PAD;
  constexpr int LDA = BK + PAD;
  constexpr int LDB = TRANS ? BK + PAD : BN + PAD;
  constexpr int A_ELEMS = BM * LDA;
  constexpr int STAGE = A_ELEMS + (TRANS ? BN : BK) * LDB;
  __shared__ __align__(128) T tiles[2 * STAGE];
  __shared__ int off_s[MAX_EXPERTS + 1];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int split = blockIdx.z, splits = gridDim.z;
  for (int i = threadIdx.x; i <= E; i += THREADS) off_s[i] = offsets[i];
  __syncthreads();

  // First expert whose range ends past m0 (E when none does).
  int e = 0, hi = E;
  while (e < hi) {
    const int mid = (e + hi) / 2;
    if (off_s[mid + 1] > m0) hi = mid;
    else e = mid + 1;
  }
  const int m_hi = min(m0 + BM, M);
  const int m_end = min(m_hi, off_s[E]);  // rows from m_end on are padding
  const int nk = (K + BK - 1) / BK;

  Acc<T> acc;
  for (e += split; e < E && off_s[e] < m_end; e += splits) {
    const int start = off_s[e], end = min(off_s[e + 1], M);
    if (end <= start) continue;  // empty expert
    const T* we = w + (size_t)e * K * N;
    acc.zero();
    auto load = [&](int stage, int kt) {
      T* As = tiles + stage * STAGE;
      T* Bs = As + A_ELEMS;
      const int k0 = kt * BK;
      load_tile<T, BM, BK, LDA>(As, x, K, m0, k0, start, end, K);
      if (TRANS) load_tile<T, BN, BK, LDB>(Bs, we, K, n0, k0, 0, N, K);
      else load_tile<T, BK, BN, LDB>(Bs, we, N, k0, n0, 0, K, N);
      cp_async_commit();
    };
    load(0, 0);
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        load((kt + 1) & 1, kt + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* As = tiles + (kt & 1) * STAGE;
      acc.template mma<false, TRANS, BK>(As, LDA, As + A_ELEMS, LDB);
      __syncthreads();
    }
    acc.store(out, N, m0, n0, max(start, m0), min(end, m_hi), N);
  }
  if (split == 0 && m_end < m_hi) {  // padding rows: exact zeros
    acc.zero();
    acc.store(out, N, m0, n0, max(m0, m_end), m_hi, N);
  }
}

// dw[e] = x[group e]^T @ dy[group e]: x [M, K], dy [M, N], dw [E, K, N].
// Grid (n-tiles, k-tiles, E).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
tgmm_kernel(const T* __restrict__ x, const T* __restrict__ dy,
            const int* __restrict__ offsets, T* __restrict__ dw, int M, int K, int N) {
  constexpr int BM = Tiles<T>::BM, BN = Tiles<T>::BN, BS = Tiles<T>::BK;
  constexpr int PAD = Tiles<T>::PAD;
  constexpr int LDA = BM + PAD;  // x rows: [BS][BM] slice of K
  constexpr int LDB = BN + PAD;  // dy rows: [BS][BN] slice of N
  constexpr int A_ELEMS = BS * LDA;
  constexpr int STAGE = A_ELEMS + BS * LDB;
  __shared__ __align__(128) T tiles[2 * STAGE];

  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BM, e = blockIdx.z;
  const int start = offsets[e], end = min(offsets[e + 1], M);
  const int ns = end > start ? (end - start + BS - 1) / BS : 0;

  Acc<T> acc;
  acc.zero();
  auto load = [&](int stage, int it) {
    T* As = tiles + stage * STAGE;
    const int s0 = start + it * BS;
    load_tile<T, BS, BM, LDA>(As, x, K, s0, k0, start, end, K);
    load_tile<T, BS, BN, LDB>(As + A_ELEMS, dy, N, s0, n0, start, end, N);
    cp_async_commit();
  };
  if (ns > 0) load(0, 0);
  for (int it = 0; it < ns; ++it) {
    if (it + 1 < ns) {
      load((it + 1) & 1, it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* As = tiles + (it & 1) * STAGE;
    acc.template mma<true, false, BS>(As, LDA, As + A_ELEMS, LDB);
    __syncthreads();
  }
  acc.store(dw + (size_t)e * K * N, N, k0, n0, 0, K, N);
}

void launch_gmm_fp32(const void* x, const void* w, const int* offsets, void* out, int M,
                     int K, int N, int E, bool trans, cudaStream_t stream) {
  using T = float;
  const int nn = (N + Tiles<T>::BN - 1) / Tiles<T>::BN;
  const int nm = (M + Tiles<T>::BM - 1) / Tiles<T>::BM;
  // Enough blocks for two a multiprocessor: split the expert walk when the
  // tiles alone are fewer (a shape rule; the routing is never read here).
  const int splits = max(1, min(E, (2 * sm_count() + nn * nm - 1) / (nn * nm)));
  const dim3 grid(nn, nm, splits);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (trans) gmm_kernel<T, true><<<grid, THREADS, 0, stream>>>(xp, wp, offsets, op, M, K, N, E);
  else gmm_kernel<T, false><<<grid, THREADS, 0, stream>>>(xp, wp, offsets, op, M, K, N, E);
}

void launch_tgmm_fp32(const void* x, const void* dy, const int* offsets, void* dw, int M,
                      int K, int N, int E, cudaStream_t stream) {
  using T = float;
  const dim3 grid((N + Tiles<T>::BN - 1) / Tiles<T>::BN, (K + Tiles<T>::BM - 1) / Tiles<T>::BM,
                  E);
  tgmm_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x),
                                               static_cast<const T*>(dy), offsets,
                                               static_cast<T*>(dw), M, K, N);
}

// =====================================================================
// bf16: wgmma, a TMA ring, warp specialisation, persistent tiles.
// =====================================================================
namespace hop {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 128, BN = 256, BK = 64;  // output tile; depth of a stage
constexpr int BOX = 64;                     // 64 bf16 = 128 bytes, the swizzle span
constexpr int BOX_BYTES = BOX * BOX * 2;    // a 64 x 64 box: 8 KB
constexpr int A_BYTES = BM * BK * 2;        // 16 KB
constexpr int B_BYTES = BK * BN * 2;        // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int STAGES = 4;     // 192 KB of ring
constexpr int THREADS = 384;  // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int CHUNK = BK;     // tgmm: rows of the reduction a stage holds

struct Shared {
  uint64_t full[STAGES], empty[STAGES];
  int off[MAX_EXPERTS + 1];   // the offsets
  int pre[MAX_EXPERTS + 1];   // work items (gmm tiles, tgmm units) before expert e
  int spre[MAX_EXPERTS + 1];  // tgmm: workspace slots before expert e
};
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + (int)sizeof(Shared);
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

// tgmm's split rule, shared by the kernels and the host's workspace size.
// An expert holding more than T rows walks them in ceil(n / T) pieces, T
// = routed * units_kn / (4 * grid) rounded up to whole chunks.  A split
// expert has n > T, so its pieces number < 2n / T, and all split experts'
// pieces < 2 * routed / T <= 8 * grid / units_kn: the workspace slots.
__host__ __device__ inline int split_rows(long long routed, int units_kn, int grid) {
  const long long g4 = 4LL * grid;
  long long t = (routed * units_kn + g4 - 1) / g4;
  t = (t + CHUNK - 1) / CHUNK * CHUNK;
  return (int)(t < CHUNK ? CHUNK : t);
}
__host__ __device__ inline int n_splits(int rows, int T) {
  return rows <= 0 ? 1 : (rows + T - 1) / T;
}
inline int workspace_slots(int units_kn, int grid) {
  return (8 * grid + units_kn - 1) / units_kn;
}
// tgmm's output tiles an expert: K-tiles of BM times N-tiles of BN.
__host__ __device__ inline int tgmm_units_kn(int K, int N) {
  return ((K + BM - 1) / BM) * ((N + BN - 1) / BN);
}

// One m64n256k16 product, both operands read from shared memory through
// descriptors: d (128 fp32 a thread) += A(64 x 16) B(16 x 256).  TA / TB
// are the transpose bits: 0 = K-major, 1 = MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// Exclusive prefix sums over experts 0..E-1 of f(e).x and f(e).y into pa
// and pb, totals at [E]; run by one whole warp, each lane a run of experts.
template <typename F>
__device__ void warp_scan(int E, F f, int* pa, int* pb) {
  const int lane = threadIdx.x & 31;
  const int per = (E + 31) / 32, lo = min(E, lane * per), hi = min(E, lo + per);
  int sa = 0, sb = 0;
  for (int e = lo; e < hi; ++e) {
    const int2 v = f(e);
    sa += v.x;
    sb += v.y;
  }
  int ia = sa, ib = sb;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ta = __shfl_up_sync(0xffffffffu, ia, d);
    const int tb = __shfl_up_sync(0xffffffffu, ib, d);
    if (lane >= d) {
      ia += ta;
      ib += tb;
    }
  }
  int ra = ia - sa, rb = ib - sb;
  for (int e = lo; e < hi; ++e) {
    pa[e] = ra;
    pb[e] = rb;
    const int2 v = f(e);
    ra += v.x;
    rb += v.y;
  }
  if (lane == 31) {
    pa[E] = ia;
    pb[E] = ib;
  }
}

// Largest e in [0, E) with pre[e] <= t, for 0 <= t < pre[E]: the expert
// whose run of work items holds item t (empty runs are stepped over).
__device__ __forceinline__ int find_expert(const int* pre, int E, int t) {
  int lo = 0, hi = E;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= t) lo = mid;
    else hi = mid;
  }
  return lo;
}

// One work item of a block: an output tile and the stages that feed it.
struct Work {
  int e;         // expert (gmm: E for a tile of padding rows)
  int r0;        // first row of x the stages read
  int rows_end;  // gmm: rows < rows_end are stored; tgmm: rows < rows_end are summed
  int m0, n0;    // output tile origin (gmm: m0 = r0; tgmm: m0 is a row of dw[e])
  int nk;        // stages: K / 64 (gmm) or 64-row chunks (tgmm); 0 = store zeros
  int slot;      // tgmm: workspace slot of a split piece, -1 = write dw
};

// gmm tile t: experts' tiles in expert order (m-tiles, then n-tiles
// fastest), then the padding rows' zero tiles.  `pre`: tiles before e.
__device__ __forceinline__ Work gmm_work(const int* off, const int* pre, int t, int M, int K,
                                         int E, int nts) {
  Work w;
  const int live = pre[E];
  int local;
  if (t < live) {
    w.e = find_expert(pre, E, t);
    local = t - pre[w.e];
    w.r0 = off[w.e] + (local / nts) * BM;
    w.rows_end = min(off[w.e + 1], M);
    w.nk = (K + BK - 1) / BK;
  } else {
    local = t - live;
    w.e = E;
    w.r0 = off[E] + (local / nts) * BM;
    w.rows_end = M;
    w.nk = 0;
  }
  w.m0 = w.r0;
  w.n0 = (local % nts) * BN;
  w.slot = -1;
  return w;
}

// tgmm unit u: per expert its pieces, each all (K-tile, N-tile) pairs with
// N-tiles fastest.  Piece p of an expert of n rows walks chunks
// [p * c / s, (p + 1) * c / s) of its c = ceil(n / 64).  `pre`: units
// before e; `spre`: workspace slots before e.
__device__ __forceinline__ Work tgmm_work(const int* off, const int* pre, const int* spre,
                                          int u, int E, int nts, int ukn, int T) {
  Work w;
  w.e = find_expert(pre, E, u);
  const int local = u - pre[w.e], piece = local / ukn, kn = local % ukn;
  w.m0 = (kn / nts) * BM;
  w.n0 = (kn % nts) * BN;
  const int lo = off[w.e], n = off[w.e + 1] - lo;
  const int chunks = (n + CHUNK - 1) / CHUNK, ns = n_splits(n, T);
  const int c_lo = piece * chunks / ns, c_hi = (piece + 1) * chunks / ns;
  w.r0 = lo + c_lo * CHUNK;
  w.nk = c_hi - c_lo;
  w.rows_end = lo + n;
  w.slot = ns > 1 ? spre[w.e] + piece : -1;
  return w;
}

// Write a warpgroup's 64 x BN accumulator tile.  Thread (warp, lane) holds
// rows 16 warp + lane / 4 (+ 8) and, for column group j, columns
// 8 j + 2 (lane % 4) (+ 1) in acc[4 j .. 4 j + 3].  bf16 goes out as 16-byte
// stores of 8 columns, fp32 partials as 8-byte pairs.
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], bf16* out, float* part,
                                           int row0, int rows_end, int n0, int N) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + warp * 16 + lane / 4 + 8 * h;
    const bool row_ok = r < rows_end;
    if (part != nullptr) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * q;
        if (row_ok && col < N)
          *reinterpret_cast<float2*>(part + (size_t)r * N + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < BN / 32; ++jj) {
        uint32_t v0 = pack_bf16(acc[16 * jj + 2 * h], acc[16 * jj + 2 * h + 1]);
        uint32_t v1 = pack_bf16(acc[16 * jj + 4 + 2 * h], acc[16 * jj + 5 + 2 * h]);
        uint32_t v2 = pack_bf16(acc[16 * jj + 8 + 2 * h], acc[16 * jj + 9 + 2 * h]);
        uint32_t v3 = pack_bf16(acc[16 * jj + 12 + 2 * h], acc[16 * jj + 13 + 2 * h]);
        quad_transpose(v0, v1, v2, v3, q);
        const int col = n0 + 32 * jj + 8 * q;
        if (row_ok && col < N)
          *reinterpret_cast<uint4*>(out + (size_t)r * N + col) = make_uint4(v0, v1, v2, v3);
      }
    }
  }
}

// The persistent kernel.  TGMM = false: gmm, A = x (K-major), B = w[e]
// (TB = 1: [K, N], MN-major; TB = 0: [N, K] read transposed, K-major).
// TGMM = true: A = x^T, B = dy, both MN-major (TB = 1).
template <bool TGMM, int TB>
__global__ void __launch_bounds__(THREADS, 1)
hopper_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b, const int* __restrict__ offsets,
              bf16* __restrict__ out, float* __restrict__ ws, int M, int K, int N, int E,
              int ref_grid) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* tiles = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Shared& s = *reinterpret_cast<Shared*>(tiles + STAGES * STAGE_BYTES);
  const int nts = (N + BN - 1) / BN, ukn = tgmm_units_kn(K, N);

  for (int i = threadIdx.x; i <= E; i += THREADS) s.off[i] = offsets[i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1);   // the producer's expect_tx; TMA's bytes
      mbar_init(&s.empty[i], 2);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int T = TGMM ? split_rows(s.off[E], ukn, ref_grid) : 0;
  if (threadIdx.x < 32) {
    if (TGMM) {
      warp_scan(E, [&](int e) {
        const int ns = n_splits(s.off[e + 1] - s.off[e], T);
        return make_int2(ns * ukn, ns > 1 ? ns : 0);
      }, s.pre, s.spre);
    } else {
      warp_scan(E, [&](int e) {
        return make_int2((s.off[e + 1] - s.off[e] + BM - 1) / BM * nts, 0);
      }, s.pre, s.spre);
    }
  }
  __syncthreads();
  const int total = TGMM ? s.pre[E] : s.pre[E] + (M - s.off[E] + BM - 1) / BM * nts;
  auto work = [&](int t) {
    return TGMM ? tgmm_work(s.off, s.pre, s.spre, t, E, nts, ukn, T)
                : gmm_work(s.off, s.pre, t, M, K, E, nts);
  };

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Work w = work(t);
        // Boxes wholly past N (or, for tgmm's A, past K) are not loaded:
        // they feed only outputs that are never stored.
        const int b_boxes = min(BN / BOX, (N - w.n0 + BOX - 1) / BOX);
        const int a_boxes = TGMM ? min(BM / BOX, (K - w.m0 + BOX - 1) / BOX) : 1;
        const uint32_t bytes = TGMM ? (a_boxes + b_boxes) * BOX_BYTES
                                    : A_BYTES + (TB ? b_boxes * BOX_BYTES : B_BYTES);
        for (int k = 0; k < w.nk; ++k) {
          mbar_wait(&s.empty[stage], phase ^ 1);
          uint8_t* a = tiles + stage * STAGE_BYTES;
          uint8_t* b = a + A_BYTES;
          uint64_t* full = &s.full[stage];
          mbar_expect_tx(full, bytes);
          if (!TGMM) {
            const int k0 = k * BK;
            tma_2d(a, &map_a, full, k0, w.r0);
            if (TB) {
              for (int c = 0; c < b_boxes; ++c)
                tma_3d(b + c * BOX_BYTES, &map_b, full, w.n0 + c * BOX, k0, w.e);
            } else {
              tma_3d(b, &map_b, full, k0, w.n0, w.e);
            }
          } else {
            const int row = w.r0 + k * CHUNK;
            for (int c = 0; c < a_boxes; ++c)
              tma_2d(a + c * BOX_BYTES, &map_a, full, w.m0 + c * BOX, row);
            for (int c = 0; c < b_boxes; ++c)
              tma_2d(b + c * BOX_BYTES, &map_b, full, w.n0 + c * BOX, row);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Work w = work(t);
      const int row0 = w.m0 + 64 * wg;
      const bool active = row0 < (TGMM ? K : w.rows_end);
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int k = 0; k < w.nk; ++k) {
        mbar_wait(&s.full[stage], phase);
        uint8_t* a = tiles + stage * STAGE_BYTES;
        uint8_t* b = a + A_BYTES;
        if (TGMM) {
          // The expert's last chunk: rows of the next expert (or padding)
          // must not enter the sum.  Zero them in every box, then make the
          // writes visible to the tensor cores' (async) proxy.
          const int valid = w.rows_end - (w.r0 + k * CHUNK);
          if (valid < CHUNK) {
            constexpr int boxes = STAGE_BYTES / BOX_BYTES;
            const int per_box = (CHUNK - valid) * 8;  // 16-byte words
            for (int i = threadIdx.x; i < boxes * per_box; i += 256) {
              *reinterpret_cast<uint4*>(a + (i / per_box) * BOX_BYTES + valid * 128 +
                                        (i % per_box) * 16) = make_uint4(0, 0, 0, 0);
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            asm volatile("bar.sync 1, 256;\n" ::: "memory");
          }
        }
        if (active) {
          const uint32_t a_addr = smem_u32(a) + wg * BOX_BYTES;  // 64 rows (gmm) or one box
          const uint32_t b_addr = smem_u32(b);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < BK / 16; ++ks) {
            const uint64_t da = TGMM ? make_desc(a_addr + ks * 2048, BOX_BYTES, 1024)
                                     : make_desc(a_addr + ks * 32, 16, 1024);
            const uint64_t db = TB ? make_desc(b_addr + ks * 2048, BOX_BYTES, 1024)
                                   : make_desc(b_addr + ks * 32, 16, 1024);
            wgmma_m64n256k16<TGMM ? 1 : 0, TB>(acc, da, db);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products are done
        }
        if (prev >= 0 && tid == 0) mbar_arrive(&s.empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (active) wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && tid == 0) mbar_arrive(&s.empty[prev]);
      if (!active) continue;
      if (TGMM) {
        const size_t kn = (size_t)K * N;
        if (w.slot >= 0) store_tile(acc, nullptr, ws + w.slot * kn, row0, K, w.n0, N);
        else store_tile(acc, out + w.e * kn, nullptr, row0, K, w.n0, N);
      } else {
        store_tile(acc, out, nullptr, row0, w.rows_end, w.n0, N);
      }
    }
  }
}

// tgmm, second pass: dw[e] = the sum of expert e's pieces in piece order,
// for every split expert.  The i-th split expert is found from a prefix
// count; each thread adds 8 consecutive entries at a time.
__global__ void __launch_bounds__(256)
tgmm_reduce_kernel(const int* __restrict__ offsets, const float* __restrict__ ws,
                   bf16* __restrict__ dw, int K, int N, int E, int units_kn, int ref_grid) {
  __shared__ int off[MAX_EXPERTS + 1], idx[MAX_EXPERTS + 1], spre[MAX_EXPERTS + 1];
  for (int i = threadIdx.x; i <= E; i += blockDim.x) off[i] = offsets[i];
  __syncthreads();
  const int T = split_rows(off[E], units_kn, ref_grid);
  if (threadIdx.x < 32) {
    warp_scan(E, [&](int e) {
      const int ns = n_splits(off[e + 1] - off[e], T);
      return make_int2(ns > 1 ? 1 : 0, ns > 1 ? ns : 0);
    }, idx, spre);
  }
  __syncthreads();
  const long long kn = (long long)K * N, kn8 = kn / 8, total = idx[E] * kn8;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int e = find_expert(idx, E, (int)(i / kn8));
    const long long v = (i % kn8) * 8;
    const int ns = n_splits(off[e + 1] - off[e], T);
    const float* p = ws + spre[e] * kn + v;
    float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int piece = 0; piece < ns; ++piece, p += kn) {
      const float4 lo = *reinterpret_cast<const float4*>(p);
      const float4 hi = *reinterpret_cast<const float4*>(p + 4);
      sum[0] += lo.x; sum[1] += lo.y; sum[2] += lo.z; sum[3] += lo.w;
      sum[4] += hi.x; sum[5] += hi.y; sum[6] += hi.z; sum[7] += hi.w;
    }
    *reinterpret_cast<uint4*>(dw + e * kn + v) =
        make_uint4(pack_bf16(sum[0], sum[1]), pack_bf16(sum[2], sum[3]),
                   pack_bf16(sum[4], sum[5]), pack_bf16(sum[6], sum[7]));
  }
}

// ---- host: tensor maps and launches -----------------------------------------

template <bool TGMM, int TB>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, const int* offsets, bf16* out,
                   float* ws, int M, int K, int N, int E, int grid, cudaStream_t stream) {
  static unsigned sized = 0;  // devices on which the shared-memory limit is raised
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(sized >> dev & 1u)) {
    const cudaError_t rc = cudaFuncSetAttribute(
        hopper_kernel<TGMM, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (rc != cudaSuccess) return rc;
    sized |= 1u << dev;
  }
  hopper_kernel<TGMM, TB><<<grid, THREADS, SMEM_BYTES, stream>>>(ma, mb, offsets, out, ws, M, K,
                                                                 N, E, sm_count());
  return cudaGetLastError();
}

cudaError_t gmm(const void* x, const void* w, const int* offsets, void* out, int M, int K,
                int N, int E, bool trans, cudaStream_t stream) {
  CUtensorMap ma, mb;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M}, xs[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xb[2] = {BOX, BM};
  const cuuint64_t inner = trans ? K : N, outer = trans ? N : K;
  const cuuint64_t wd[3] = {inner, outer, (cuuint64_t)E};
  const cuuint64_t wst[2] = {inner * 2, inner * outer * 2};
  const cuuint32_t wb[3] = {BOX, trans ? (cuuint32_t)BN : (cuuint32_t)BK, 1};
  if (!make_map(&ma, x, 2, xd, xs, xb) || !make_map(&mb, w, 3, wd, wst, wb))
    return cudaErrorInvalidValue;
  const long long tiles = ((long long)M / BM + E + 1) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  bf16* o = static_cast<bf16*>(out);
  return trans ? launch<false, 0>(ma, mb, offsets, o, nullptr, M, K, N, E, grid, stream)
               : launch<false, 1>(ma, mb, offsets, o, nullptr, M, K, N, E, grid, stream);
}

cudaError_t tgmm(const void* x, const void* dy, const int* offsets, void* dw, void* ws, int M,
                 int K, int N, int E, cudaStream_t stream) {
  if (M == 0) return cudaMemsetAsync(dw, 0, (size_t)E * K * N * sizeof(bf16), stream);
  const int ukn = tgmm_units_kn(K, N);
  CUtensorMap ma, mb;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M}, xs[1] = {(cuuint64_t)K * 2};
  const cuuint64_t dd[2] = {(cuuint64_t)N, (cuuint64_t)M}, ds[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box[2] = {BOX, CHUNK};
  if (!make_map(&ma, x, 2, xd, xs, box) || !make_map(&mb, dy, 2, dd, ds, box))
    return cudaErrorInvalidValue;
  const long long units = (long long)E * ukn + 8LL * sm_count();
  const int grid = (int)(units < sm_count() ? units : sm_count());
  bf16* o = static_cast<bf16*>(dw);
  float* part = static_cast<float*>(ws);
  const cudaError_t rc = launch<true, 1>(ma, mb, offsets, o, part, M, K, N, E, grid, stream);
  if (rc != cudaSuccess) return rc;
  tgmm_reduce_kernel<<<2 * sm_count(), 256, 0, stream>>>(offsets, part, o, K, N, E, ukn,
                                                         sm_count());
  return cudaGetLastError();
}

}  // namespace hop

bool shapes_ok(int M, int K, int N, int E) {
  return M >= 0 && K > 0 && N > 0 && E > 0 && K % 8 == 0 && N % 8 == 0 && E <= MAX_EXPERTS;
}

}  // namespace

// Rows of gmm's output tile (dtype: 0 = fp32, 1 = bf16), for the wrapper's
// tile accounting.
extern "C" int grouped_gemm_block_m(int dtype) {
  return dtype == 1 ? hop::BM : Tiles<float>::BM;
}

// Columns of the output tile of gmm and tgmm (dtype as above).
extern "C" int grouped_gemm_block_n(int dtype) {
  return dtype == 1 ? hop::BN : Tiles<float>::BN;
}

// Bytes of the fp32 workspace tgmm needs for x [M, K], dy [M, N] and E
// experts: the split pieces' partials (bf16; fp32 needs none).  Depends on
// the shapes and the card's SM count only.
extern "C" long long tgmm_workspace_bytes(int M, int K, int N, int E, int dtype) {
  if (dtype != 1 || !shapes_ok(M, K, N, E) || M == 0) return 0;
  const int ukn = hop::tgmm_units_kn(K, N);
  return (long long)hop::workspace_slots(ukn, sm_count()) * K * N * (long long)sizeof(float);
}

// x [M, K]; w [E, K, N] (trans_w = 0) or [E, N, K] (trans_w = 1);
// offsets [E + 1] int32 ascending from 0 with offsets[E] <= M; out [M, N].
// K and N multiples of 8, E <= 512, 16-byte aligned pointers.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int gmm(const void* x, const void* w, const int* offsets, void* out, int M,
                   int K, int N, int E, int trans_w, int dtype, void* stream) {
  if (!shapes_ok(M, K, N, E)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch_gmm_fp32(x, w, offsets, out, M, K, N, E, trans_w != 0, st);
  else if (dtype == 1) return (int)hop::gmm(x, w, offsets, out, M, K, N, E, trans_w != 0, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x [M, K]; dy [M, N]; offsets [E + 1] as for gmm; dw [E, K, N];
// workspace of tgmm_workspace_bytes (bf16; NULL for fp32).  Every entry of
// dw is written (empty experts get zeros).
extern "C" int tgmm(const void* x, const void* dy, const int* offsets, void* dw,
                    void* workspace, int M, int K, int N, int E, int dtype, void* stream) {
  if (!shapes_ok(M, K, N, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch_tgmm_fp32(x, dy, offsets, dw, M, K, N, E, st);
  else if (dtype == 1) return (int)hop::tgmm(x, dy, offsets, dw, workspace, M, K, N, E, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
