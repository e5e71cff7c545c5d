// Segment-masked GQA flash-attention backward for Hopper (sm_90a): the dq
// kernel and the dk/dv kernel.
//
// Replace the Pallas TPU kernels `_dq_kernel` (src/repro/kernels/
// flash_attention.py:226) and `_dkv_kernel` (:261) and compute what they
// compute, from the forward's out and lse:
//   * mask as in the forward (same segment & seg > 0 & causal on position
//     & window on position);
//   * p = exp(s * scale - lse) on unmasked scores and exactly 0 elsewhere,
//     so fully-masked rows (padding, seg 0; lse 0 there) give 0 gradients;
//   * delta = rowsum(do * o) is computed by the wrapper in fp32 and read;
//   * ds = p * (do . v - delta) * scale;
//   * dq = sum_j ds k_j;  dk = sum_i ds q_i;  dv = sum_i p do_i, with dk/dv
//     summed over the H / Hkv query heads of the KV head's GQA group;
//   * bf16 or fp32 in, fp32 arithmetic, each gradient in its input's type.
//
// Design.  The TPU grid walked its innermost axis in order on one core and
// carried the gradient accumulators in VMEM scratch.  Here every block owns
// one output tile outright and loops over what it sums, so nothing is
// carried between blocks and no atomics are needed:
//   * dq: one block per (b*h, 16-row Q tile), walking the forward's
//     compacted list of live 32-key KV tiles (the same lists flash_fwd.cu
//     walks, made by the wrapper from `live_tile_mask`).  8 threads per
//     query row; a lane scores keys lane + 8j and owns dq columns lane + 8j.
//   * dk/dv: one block per (b*hkv, 32-key KV tile), walking the transposed
//     list (the live Q tiles of that KV tile) and, inside it, every query
//     head of the GQA group, so the group sum forms in registers.  4
//     threads per key; a thread scores rows part + 4i against its key and
//     owns dk/dv columns part + 4j.
// Tiles (BQ x BK = 16 x 32, as in flash_fwd.cu) are staged in shared memory
// as fp32 with rows padded by one word against bank conflicts; the
// products are scalar fp32 FMAs.
//
// Bound on the H100.  On packed training streams both kernels are bound by
// operations: 6*D flops per live score per query head for dq (s, dp, dq)
// and 8*D for dk/dv (s, dp, dk, dv).  This simple design runs them on the
// CUDA cores; what it leaves for later: tensor cores (mma.sync / wgmma) for
// the five tile products, 16-byte or TMA loads with double buffering, and
// one pass that emits dq, dk and dv together.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 16;            // query rows per tile
constexpr int BK = 32;            // keys per KV tile
constexpr int THREADS = 128;
constexpr int LANES_Q = 8;        // dq: threads per query row
constexpr int KPL = BK / LANES_Q; // dq: keys scored per lane per tile
constexpr int PARTS = 4;          // dkv: threads per key
constexpr int RPT = BQ / PARTS;   // dkv: query rows scored per thread per tile
constexpr float NEG_INF = -1073741824.0f;  // -2^30, as in the reference

static_assert(BQ * LANES_Q == THREADS, "dq layout");
static_assert(BK * PARTS == THREADS, "dkv layout");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool attends(int qs, int qp, int ks, int kp, int causal,
                                        int window) {
  bool ok = (qs == ks) && (qs > 0);
  if (causal) ok = ok && (kp <= qp);
  if (window >= 0) ok = ok && (qp - kp < window);
  return ok;
}

// rows [r0, r0 + R) of a [T, D] matrix into fp32 shared memory with row
// stride D + 1; rows past T read as 0.
template <typename T, int D, int R>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int Tn) {
  for (int i = threadIdx.x; i < R * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = (r0 + r < Tn) ? to_f32(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

template <int D> constexpr int dq_smem_floats() { return 2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1); }
template <int D> constexpr int dkv_smem_floats() { return 2 * BQ * (D + 1) + 2 * BK * (D + 1) + 2 * BQ * (BK + 1); }

// ---------------------------------------------------------------------------
// dq: grid (B*H, nQ).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                const int* __restrict__ live_count, const int* __restrict__ live_idx,
                T* __restrict__ dq, int H, int Hkv, int Tq, int Tkv, int nQ, int nK,
                int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int CPL = D / LANES_Q;   // dq columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * DP;
  float* k_s = do_s + BQ * DP;
  float* v_s = k_s + BK * DP;
  float* ds_s = v_s + BK * DP;       // [BQ, BK + 1]
  __shared__ int qseg_s[BQ], qpos_s[BQ], kseg_s[BK], kpos_s[BK];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bh = blockIdx.x;
  const int qt = blockIdx.y;
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int tid = threadIdx.x;
  const int row = tid / LANES_Q;
  const int lane = tid % LANES_Q;
  const int q0 = qt * BQ;

  stage<T, D, BQ>(q_s, q + (size_t)bh * Tq * D, q0, Tq);
  stage<T, D, BQ>(do_s, dout + (size_t)bh * Tq * D, q0, Tq);
  if (tid < BQ) {
    const bool ok = q0 + tid < Tq;
    qseg_s[tid] = ok ? q_seg[(size_t)b * Tq + q0 + tid] : 0;
    qpos_s[tid] = ok ? q_pos[(size_t)b * Tq + q0 + tid] : 0;
    lse_s[tid] = ok ? lse[(size_t)bh * Tq + q0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[(size_t)bh * Tq + q0 + tid] : 0.f;
  }

  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;

  const int n_live = live_count[b * nQ + qt];
  const int* tiles = live_idx + ((size_t)b * nQ + qt) * nK;
  const T* kb = k + (size_t)kvh * Tkv * D;
  const T* vb = v + (size_t)kvh * Tkv * D;

  for (int it = 0; it < n_live; ++it) {
    const int k0 = tiles[it] * BK;
    __syncthreads();  // the previous tile's k_s / v_s are no longer read
    stage<T, D, BK>(k_s, kb, k0, Tkv);
    stage<T, D, BK>(v_s, vb, k0, Tkv);
    if (tid < BK) {
      const bool ok = k0 + tid < Tkv;
      kseg_s[tid] = ok ? kv_seg[(size_t)b * Tkv + k0 + tid] : 0;
      kpos_s[tid] = ok ? kv_pos[(size_t)b * Tkv + k0 + tid] : 0;
    }
    __syncthreads();

    float s[KPL], dp[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) s[j] = dp[j] = 0.f;
    const float* qr = q_s + row * DP;
    const float* dr = do_s + row * DP;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d], gv = dr[d];
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int c = (lane + LANES_Q * j) * DP + d;
        s[j] += qv * k_s[c];
        dp[j] += gv * v_s[c];
      }
    }
    const int qs = qseg_s[row], qp = qpos_s[row];
    const float L = lse_s[row], dl = delta_s[row];
    float* dsr = ds_s + row * (BK + 1);
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int c = lane + LANES_Q * j;
      const float p = attends(qs, qp, kseg_s[c], kpos_s[c], causal, window)
                          ? expf(s[j] * scale - L) : 0.f;
      dsr[c] = p * (dp[j] - dl) * scale;
    }
    __syncwarp();  // a row's ds is written by the 8 lanes of one warp
    for (int c = 0; c < BK; ++c) {
      const float g = dsr[c];
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[j] += g * k_s[c * DP + lane + LANES_Q * j];
    }
    __syncwarp();  // ds_s is rewritten by the next tile
  }

  const int qrow = q0 + row;
  if (qrow < Tq) {
    T* o = dq + ((size_t)bh * Tq + qrow) * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) o[lane + LANES_Q * j] = from_f32<T>(acc[j]);
  }
}

// ---------------------------------------------------------------------------
// dk/dv: grid (B*Hkv, nK).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                 const int* __restrict__ t_count, const int* __restrict__ t_idx,
                 T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int Tq,
                 int Tkv, int nQ, int nK, int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int CPT = D / PARTS;     // dk / dv columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * DP;
  float* k_s = do_s + BQ * DP;
  float* v_s = k_s + BK * DP;
  float* p_s = v_s + BK * DP;        // [BQ, BK + 1]
  float* ds_s = p_s + BQ * (BK + 1); // [BQ, BK + 1]
  __shared__ int qseg_s[BQ], qpos_s[BQ];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bkvh = blockIdx.x;       // b * Hkv + kv head
  const int kt = blockIdx.y;
  const int b = bkvh / Hkv;
  const int group = H / Hkv;
  const int h0 = b * H + (bkvh % Hkv) * group;  // first query head of the group
  const int tid = threadIdx.x;
  const int key = tid / PARTS;
  const int part = tid % PARTS;
  const int k0 = kt * BK;

  stage<T, D, BK>(k_s, k + (size_t)bkvh * Tkv * D, k0, Tkv);
  stage<T, D, BK>(v_s, v + (size_t)bkvh * Tkv * D, k0, Tkv);
  const bool key_ok = k0 + key < Tkv;
  const int ks = key_ok ? kv_seg[(size_t)b * Tkv + k0 + key] : 0;
  const int kp = key_ok ? kv_pos[(size_t)b * Tkv + k0 + key] : 0;

  float dk_acc[CPT], dv_acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  const int n_live = t_count[b * nK + kt];
  const int* tiles = t_idx + ((size_t)b * nK + kt) * nQ;
  const float* kr = k_s + key * DP;
  const float* vr = v_s + key * DP;

  for (int it = 0; it < n_live; ++it) {
    const int q0 = tiles[it] * BQ;
    for (int m = 0; m < group; ++m) {
      const int bh = h0 + m;
      __syncthreads();  // the previous (tile, head)'s q_s / do_s are no longer read
      stage<T, D, BQ>(q_s, q + (size_t)bh * Tq * D, q0, Tq);
      stage<T, D, BQ>(do_s, dout + (size_t)bh * Tq * D, q0, Tq);
      if (tid < BQ) {
        const bool ok = q0 + tid < Tq;
        qseg_s[tid] = ok ? q_seg[(size_t)b * Tq + q0 + tid] : 0;
        qpos_s[tid] = ok ? q_pos[(size_t)b * Tq + q0 + tid] : 0;
        lse_s[tid] = ok ? lse[(size_t)bh * Tq + q0 + tid] : 0.f;
        delta_s[tid] = ok ? delta[(size_t)bh * Tq + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[RPT], dp[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kv_ = kr[d], vv = vr[d];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = (part + PARTS * i) * DP + d;
          s[i] += q_s[r] * kv_;
          dp[i] += do_s[r] * vv;
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = part + PARTS * i;
        const float p = attends(qseg_s[r], qpos_s[r], ks, kp, causal, window)
                            ? expf(s[i] * scale - lse_s[r]) : 0.f;
        p_s[r * (BK + 1) + key] = p;
        ds_s[r * (BK + 1) + key] = p * (dp[i] - delta_s[r]) * scale;
      }
      __syncthreads();

      for (int r = 0; r < BQ; ++r) {
        const float p = p_s[r * (BK + 1) + key];
        const float g = ds_s[r * (BK + 1) + key];
        const float* qr = q_s + r * DP;
        const float* dr = do_s + r * DP;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = part + PARTS * j;
          dv_acc[j] += p * dr[c];
          dk_acc[j] += g * qr[c];
        }
      }
    }
  }

  if (key_ok) {
    const size_t off = ((size_t)bkvh * Tkv + k0 + key) * D;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      dk[off + part + PARTS * j] = from_f32<T>(dk_acc[j]);
      dv[off + part + PARTS * j] = from_f32<T>(dv_acc[j]);
    }
  }
}

// Dynamic shared memory above 48 KB must be allowed once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const int* q_seg,
                      const int* kv_seg, const int* q_pos, const int* kv_pos,
                      const int* live_count, const int* live_idx, void* dq, int B,
                      int H, int Hkv, int Tq, int Tkv, int nQ, int nK, int causal,
                      int window, float scale, cudaStream_t stream) {
  const int bytes = dq_smem_floats<D>() * (int)sizeof(float);
  static const cudaError_t set = allow_smem(flash_dq_kernel<T, D>, bytes);
  if (set != cudaSuccess) return set;
  flash_dq_kernel<T, D><<<dim3(B * H, nQ), THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, q_seg, kv_seg, q_pos, kv_pos,
      live_count, live_idx, static_cast<T*>(dq), H, Hkv, Tq, Tkv, nQ, nK, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const int* q_seg,
                       const int* kv_seg, const int* q_pos, const int* kv_pos,
                       const int* t_count, const int* t_idx, void* dk, void* dv, int B,
                       int H, int Hkv, int Tq, int Tkv, int nQ, int nK, int causal,
                       int window, float scale, cudaStream_t stream) {
  const int bytes = dkv_smem_floats<D>() * (int)sizeof(float);
  static const cudaError_t set = allow_smem(flash_dkv_kernel<T, D>, bytes);
  if (set != cudaSuccess) return set;
  flash_dkv_kernel<T, D><<<dim3(B * Hkv, nK), THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, q_seg, kv_seg, q_pos, kv_pos, t_count,
      t_idx, static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Tq, Tkv, nQ, nK, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

// Tile sizes; the wrapper checks that they equal flash_fwd.cu's, whose
// live-tile lists these kernels walk.
extern "C" int flash_bwd_block_q() { return BQ; }
extern "C" int flash_bwd_block_kv() { return BK; }

// q/dout [B*H, Tq, D], k/v [B*Hkv, Tkv, D] (dtype: 0 = fp32, 1 = bf16);
// lse/delta [B*H, Tq] fp32; seg/pos [B, T] int32; live_count [B, nQ] and
// live_idx [B, nQ, nK] int32 (the forward's lists); dq like q.  window < 0
// means no window.  Launches on `stream` and returns the CUDA error code.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* q_seg,
                            const int* kv_seg, const int* q_pos, const int* kv_pos,
                            const int* live_count, const int* live_idx, void* dq, int B,
                            int H, int Hkv, int Tq, int Tkv, int D, int nQ, int nK,
                            int causal, int window, float scale, int dtype,
                            void* stream) {
  if (B * H == 0 || nQ == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DQ_ARGS q, k, v, dout, lse, delta, q_seg, kv_seg, q_pos, kv_pos, live_count, \
                live_idx, dq, B, H, Hkv, Tq, Tkv, nQ, nK, causal, window, scale, st
  if (dtype == 0 && D == 64) return (int)launch_dq<float, 64>(DQ_ARGS);
  if (dtype == 0 && D == 128) return (int)launch_dq<float, 128>(DQ_ARGS);
  if (dtype == 1 && D == 64) return (int)launch_dq<__nv_bfloat16, 64>(DQ_ARGS);
  if (dtype == 1 && D == 128) return (int)launch_dq<__nv_bfloat16, 128>(DQ_ARGS);
#undef DQ_ARGS
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq, with t_count [B, nK] and t_idx [B, nK, nQ] int32: the
// live Q tiles of each KV tile.  dk/dv like k.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* delta,
                             const int* q_seg, const int* kv_seg, const int* q_pos,
                             const int* kv_pos, const int* t_count, const int* t_idx,
                             void* dk, void* dv, int B, int H, int Hkv, int Tq, int Tkv,
                             int D, int nQ, int nK, int causal, int window, float scale,
                             int dtype, void* stream) {
  if (B * Hkv == 0 || nK == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DKV_ARGS q, k, v, dout, lse, delta, q_seg, kv_seg, q_pos, kv_pos, t_count, t_idx, \
                 dk, dv, B, H, Hkv, Tq, Tkv, nQ, nK, causal, window, scale, st
  if (dtype == 0 && D == 64) return (int)launch_dkv<float, 64>(DKV_ARGS);
  if (dtype == 0 && D == 128) return (int)launch_dkv<float, 128>(DKV_ARGS);
  if (dtype == 1 && D == 64) return (int)launch_dkv<__nv_bfloat16, 64>(DKV_ARGS);
  if (dtype == 1 && D == 128) return (int)launch_dkv<__nv_bfloat16, 128>(DKV_ARGS);
#undef DKV_ARGS
  return (int)cudaErrorInvalidValue;
}
