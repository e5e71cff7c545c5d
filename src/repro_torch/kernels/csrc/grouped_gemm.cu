// Grouped GEMM for MoE expert dispatch on Hopper (sm_90a): the expert
// products (gmm) and their weight gradient (tgmm).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/grouped_gemm.py and
// computes what they compute:
//   * gmm  (`_gmm_kernel`, :56; `_gmm` :80)
//       out[M, N] = x[M, K] @ w[group(m)] over expert groups that are sorted
//       and contiguous: row m belongs to expert e iff
//       offsets[e] <= m < offsets[e + 1].  Rows at or beyond offsets[E]
//       (padding) come out exactly 0.  With `trans_w` the weights are read
//       as w[E, N, K] and multiplied transposed: the dx of the forward
//       product, with no transposed copy of w.
//   * tgmm (`_tgmm_kernel`, :105; `_tgmm` :130)
//       dw[E, K, N] = sum over rows s of group e of x[s]^T dy[s]; an empty
//       expert's dw is exactly 0.
//   * bf16 or fp32 in, fp32 accumulation, out in the input type.  For bf16
//     every product of two bf16 values is exact in fp32, as the JAX
//     package's upcast dot is.
//
// Design.  The TPU grid put the expert axis innermost and carried the
// accumulator across it in VMEM scratch.  Here one block owns one output
// tile and loops itself, so nothing is carried between blocks:
//   * gmm: one block per (m-tile, n-tile, split).  It reads offsets[E+1]
//     into shared memory, finds by binary search the first expert whose
//     row range meets its m-tile, and walks only the experts whose ranges
//     meet the tile (the TPU kernel's dead-tile skip).  For each it streams
//     K through shared memory with the rows of other experts zero-filled
//     and writes that expert's rows of the tile.  Experts own disjoint
//     rows, so when the tiles are too few to fill the card (decode: one
//     m-tile) the experts of a tile are dealt out to `splits` blocks with
//     no reduction between them; split 0 writes the padding rows' zeros.
//   * tgmm: one block per (expert, K-tile, N-tile).  It walks the rows
//     offsets[e] .. offsets[e+1] of its expert only, never the whole M.
//   * Tiles move from device memory to shared memory with 16-byte
//     cp.async copies, two stages deep (the next tile loads while the
//     current one multiplies); masked rows and ragged edges are zero-filled
//     by the copy itself (src-size 0).
//   * bf16 multiplies on the tensor cores through nvcuda::wmma 16x16x16
//     fragments with fp32 accumulators: 8 warps, each a 32 x 64 piece of a
//     128 x 128 tile.  fp32 (the agreement runs) multiplies with scalar
//     FMAs, 4 x 4 outputs a thread over a 64 x 64 tile.
//   * Both kernels are bounded to two resident blocks a multiprocessor
//     (at most 128 registers a thread): at 134-138 registers only one
//     fits, and the bf16 gmm ran 25% slower (H100, at the training shape).
//
// Bound on the H100.  At the training shapes (M ~ 10^5 rows, K, N in
// {512, 1536}) a product is bound by operations, 2*M*K*N over the bf16
// tensor-core rate; at the decode shape (M = 64) by the bytes of the live
// experts' weights.  This simple design leaves for later: wgmma with TMA
// loads and a deeper pipeline, a persistent schedule over tiles, and a
// split of the tgmm reduction over rows when one expert holds most of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int MAX_EXPERTS = 512;  // offsets staged in shared memory

template <typename T> struct Tiles;
// bf16: 128 x 128 output tiles, 32 deep per pipeline stage; rows padded by
// 8 elements (16 bytes), which keeps wmma's pointers 32-byte aligned.
template <> struct Tiles<__nv_bfloat16> {
  static constexpr int BM = 128, BN = 128, BK = 32, PAD = 8;
};
// fp32: 64 x 64 output tiles, 16 deep; rows padded by 4 elements.
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

template <> struct Acc<__nv_bfloat16> {
  using T = __nv_bfloat16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[2][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(c[i][j], 0.f);
  }

  template <bool ACOL, bool BCOL, int KLEN>
  __device__ void mma(const T* a, int lda, const T* b, int ldb) {
    using LA = typename std::conditional<ACOL, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<BCOL, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
#pragma unroll
    for (int ks = 0; ks < KLEN; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm + 16 * i;
        wmma::load_matrix_sync(fa[i], ACOL ? a + ks * lda + m : a + m * lda + ks, lda);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + 16 * j;
        wmma::load_matrix_sync(fb[j], BCOL ? b + n * ldb + ks : b + ks * ldb + n, ldb);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(c[i][j], fa[i], fb[j], c[i][j]);
    }
  }

  // Write the tile at (r0, c0) of out (row-major, leading dimension ld),
  // rows in [row_lo, row_hi) and columns < cols_hi, through a 16 x 16 fp32
  // scratch of each warp (8 KB in all).
  __device__ void store(T* out, long ld, int r0, int c0, int row_lo, int row_hi,
                        int cols_hi, float* scratch) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
    float* s = scratch + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(s, c[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int t = lane; t < 256; t += 32) {
          const int r = r0 + wm + 16 * i + t / 16, col = c0 + wn + 16 * j + t % 16;
          if (r >= row_lo && r < row_hi && col < cols_hi)
            out[(size_t)r * ld + col] = __float2bfloat16(s[t]);
        }
        __syncwarp();
      }
  }
};

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
                        int cols_hi, float*) {
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
  static_assert(2 * STAGE * sizeof(T) >= 8 * 256 * sizeof(float), "epilogue scratch");
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
  float* scratch = reinterpret_cast<float*>(tiles);

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
    acc.store(out, N, m0, n0, max(start, m0), min(end, m_hi), N, scratch);
    __syncthreads();  // the scratch aliases the next expert's tiles
  }
  if (split == 0 && m_end < m_hi) {  // padding rows: exact zeros
    acc.zero();
    acc.store(out, N, m0, n0, max(m0, m_end), m_hi, N, scratch);
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
  static_assert(2 * STAGE * sizeof(T) >= 8 * 256 * sizeof(float), "epilogue scratch");
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
  acc.store(dw + (size_t)e * K * N, N, k0, n0, 0, K, N, reinterpret_cast<float*>(tiles));
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename T>
void launch_gmm(const void* x, const void* w, const int* offsets, void* out, int M, int K,
                int N, int E, bool trans, cudaStream_t stream) {
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

template <typename T>
void launch_tgmm(const void* x, const void* dy, const int* offsets, void* dw, int M, int K,
                 int N, int E, cudaStream_t stream) {
  const dim3 grid((N + Tiles<T>::BN - 1) / Tiles<T>::BN, (K + Tiles<T>::BM - 1) / Tiles<T>::BM,
                  E);
  tgmm_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x),
                                               static_cast<const T*>(dy), offsets,
                                               static_cast<T*>(dw), M, K, N);
}

bool shapes_ok(int M, int K, int N, int E) {
  return M >= 0 && K > 0 && N > 0 && E > 0 && K % 8 == 0 && N % 8 == 0;
}

}  // namespace

// Rows of the m-tile of gmm (dtype: 0 = fp32, 1 = bf16), for the wrapper's
// tile-skip accounting.
extern "C" int grouped_gemm_block_m(int dtype) {
  return dtype == 1 ? Tiles<__nv_bfloat16>::BM : Tiles<float>::BM;
}

// x [M, K]; w [E, K, N] (trans_w = 0) or [E, N, K] (trans_w = 1);
// offsets [E + 1] int32 ascending from 0 with offsets[E] <= M; out [M, N].
// K and N multiples of 8, E <= 512, 16-byte aligned pointers.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int gmm(const void* x, const void* w, const int* offsets, void* out, int M,
                   int K, int N, int E, int trans_w, int dtype, void* stream) {
  if (!shapes_ok(M, K, N, E) || E > MAX_EXPERTS) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch_gmm<float>(x, w, offsets, out, M, K, N, E, trans_w != 0, st);
  else if (dtype == 1)
    launch_gmm<__nv_bfloat16>(x, w, offsets, out, M, K, N, E, trans_w != 0, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x [M, K]; dy [M, N]; offsets [E + 1] as for gmm; dw [E, K, N].  Every
// entry of dw is written (empty experts get zeros).
extern "C" int tgmm(const void* x, const void* dy, const int* offsets, void* dw, int M,
                    int K, int N, int E, int dtype, void* stream) {
  if (!shapes_ok(M, K, N, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch_tgmm<float>(x, dy, offsets, dw, M, K, N, E, st);
  else if (dtype == 1) launch_tgmm<__nv_bfloat16>(x, dy, offsets, dw, M, K, N, E, st);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
