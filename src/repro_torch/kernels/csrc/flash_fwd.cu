// Segment-masked GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// src/repro/kernels/flash_attention.py:181 and computes what it computes:
//   * mask = same segment & seg > 0 & (causal: kv_pos <= q_pos)
//            & (window: q_pos - kv_pos < window)      (its `_tile_mask`);
//   * scores scaled by 1/sqrt(D), masked scores set to -2^30, masked
//     probabilities exactly 0;
//   * online softmax with m, l and the output accumulator in fp32;
//   * rows with l == 0 (fully masked) give out 0 and lse 0, otherwise
//     out = acc / l and lse = m + log(l);
//   * q head h reads KV head h / (H / Hkv);
//   * bf16 or fp32 in, fp32 arithmetic, out in the type of q, lse fp32.
//
// Design.  The TPU grid walked KV tiles in order on one core and carried
// (m, l, acc) in VMEM scratch from one grid step to the next.  Here one
// block owns one (b*h, Q tile) pair and loops over that Q tile's live KV
// tiles itself, so nothing is carried between blocks and no atomics are
// needed.  The wrapper (kernels/flash_attention.py) turns
// `live_tile_mask`, computed at this kernel's tile sizes (BQ x BK), into a
// compacted per-(b, Q tile) list of live KV-tile indices plus a count;
// the block walks that list instead of testing every tile.  Ragged edges
// (Tq, Tkv not multiples of the tiles) are masked here, so the decode
// shape (one query row, padded to 8 by the caller) needs no other care.
//
// Thread layout: 128 threads, 8 per query row.  A lane scores keys
// lane + 8*j of the tile and accumulates output columns lane + 8*j, so the
// softmax statistics of a row live in 8 neighbouring lanes of one warp and
// reduce with shuffles.  Q, K and V tiles are staged in shared memory as
// fp32 (rows padded by one word against bank conflicts); the products are
// scalar FMAs.
//
// Bound on the H100.  At the decode shape (Tq = 1) every KV element is
// read once per query row, so the kernel is bound by bytes: its least time
// is the live KV bytes / 3.35 TB/s.  On long packed streams it is bound by
// operations (4*D flops per live score).  This simple design leaves for
// later: tensor cores (mma.sync / wgmma) instead of scalar FMAs, TMA or
// cp.async double buffering of the K/V tiles, vectorised 16-byte loads,
// and reading each KV head once for its whole GQA group (today each of the
// H/Hkv query heads of a group reads it again, from L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 16;            // query rows per tile (one block)
constexpr int BK = 32;            // keys per KV tile
constexpr int LANES = 8;          // threads per query row
constexpr int THREADS = BQ * LANES;
constexpr int KPL = BK / LANES;   // keys scored per lane per tile
constexpr float NEG_INF = -1073741824.0f;  // -2^30, as in the reference

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos, const int* __restrict__ live_count,
                 const int* __restrict__ live_idx, T* __restrict__ out,
                 float* __restrict__ lse, int H, int Hkv, int Tq, int Tkv, int nQ,
                 int nK, int causal, int window, float scale) {
  constexpr int DP = D + 1;          // padded row stride of q_s / k_s
  constexpr int CPL = D / LANES;     // output columns per lane
  __shared__ float q_s[BQ * DP];
  __shared__ float k_s[BK * DP];
  __shared__ float v_s[BK * D];
  __shared__ float p_s[BQ * (BK + 1)];
  __shared__ int qseg_s[BQ], qpos_s[BQ], kseg_s[BK], kpos_s[BK];

  const int bh = blockIdx.x;
  const int qt = blockIdx.y;
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int tid = threadIdx.x;
  const int row = tid / LANES;
  const int lane = tid % LANES;
  const int q0 = qt * BQ;

  const T* qb = q + (size_t)bh * Tq * D;
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    q_s[r * DP + c] = (q0 + r < Tq) ? to_f32(qb[(size_t)(q0 + r) * D + c]) : 0.f;
  }
  if (tid < BQ) {
    const bool ok = q0 + tid < Tq;
    qseg_s[tid] = ok ? q_seg[(size_t)b * Tq + q0 + tid] : 0;
    qpos_s[tid] = ok ? q_pos[(size_t)b * Tq + q0 + tid] : 0;
  }

  float m = NEG_INF, l = 0.f;
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
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < Tkv;
      const size_t off = (size_t)(k0 + r) * D + c;
      k_s[r * DP + c] = ok ? to_f32(kb[off]) : 0.f;
      v_s[r * D + c] = ok ? to_f32(vb[off]) : 0.f;
    }
    if (tid < BK) {
      const bool ok = k0 + tid < Tkv;
      kseg_s[tid] = ok ? kv_seg[(size_t)b * Tkv + k0 + tid] : 0;
      kpos_s[tid] = ok ? kv_pos[(size_t)b * Tkv + k0 + tid] : 0;
    }
    __syncthreads();

    float s[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) s[j] = 0.f;
    const float* qr = q_s + row * DP;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float qv = qr[d];
#pragma unroll
      for (int j = 0; j < KPL; ++j) s[j] += qv * k_s[(lane + LANES * j) * DP + d];
    }

    const int qs = qseg_s[row], qp = qpos_s[row];
    bool live[KPL];
    float tmax = NEG_INF;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int c = lane + LANES * j;
      bool ok = (qs == kseg_s[c]) && (qs > 0);
      if (causal) ok = ok && (kpos_s[c] <= qp);
      if (window >= 0) ok = ok && (qp - kpos_s[c] < window);
      live[j] = ok;
      s[j] = ok ? s[j] * scale : NEG_INF;
      tmax = fmaxf(tmax, s[j]);
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);

    float psum = 0.f;
    float* pr = p_s + row * (BK + 1);
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const float p = live[j] ? expf(s[j] - m_new) : 0.f;
      psum += p;
      pr[lane + LANES * j] = p;
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    const float corr = expf(m - m_new);
    l = l * corr + psum;
    m = m_new;
    // A row's probabilities are written by the 8 lanes of one warp.
    __syncwarp();
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] *= corr;
    for (int c = 0; c < BK; ++c) {
      const float p = pr[c];
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[j] += p * v_s[c * D + lane + LANES * j];
    }
    __syncwarp();  // p_s is rewritten by the next tile
  }

  const int qrow = q0 + row;
  if (qrow < Tq) {
    const float l_safe = (l == 0.f) ? 1.f : l;
    T* o = out + ((size_t)bh * Tq + qrow) * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) o[lane + LANES * j] = from_f32<T>(acc[j] / l_safe);
    if (lane == 0) lse[(size_t)bh * Tq + qrow] = (l > 0.f) ? m + logf(l_safe) : 0.f;
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const int* q_seg,
            const int* kv_seg, const int* q_pos, const int* kv_pos,
            const int* live_count, const int* live_idx, void* out, float* lse,
            int B, int H, int Hkv, int Tq, int Tkv, int nQ, int nK, int causal,
            int window, float scale, cudaStream_t stream) {
  const dim3 grid(B * H, nQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      q_seg, kv_seg, q_pos, kv_pos, live_count, live_idx, static_cast<T*>(out), lse,
      H, Hkv, Tq, Tkv, nQ, nK, causal, window, scale);
}

}  // namespace

// Tile sizes, read by the wrapper so that its live-tile lists match.
extern "C" int flash_fwd_block_q() { return BQ; }
extern "C" int flash_fwd_block_kv() { return BK; }

// q [B*H, Tq, D], k/v [B*Hkv, Tkv, D] (dtype: 0 = fp32, 1 = bf16);
// seg/pos [B, T] int32; live_count [B, nQ] and live_idx [B, nQ, nK] int32;
// out [B*H, Tq, D] in the dtype of q, lse [B*H, Tq] fp32.  window < 0 means
// no window.  Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* q_seg, const int* kv_seg, const int* q_pos,
                         const int* kv_pos, const int* live_count, const int* live_idx,
                         void* out, float* lse, int B, int H, int Hkv, int Tq, int Tkv,
                         int D, int nQ, int nK, int causal, int window, float scale,
                         int dtype, void* stream) {
  if (B * H == 0 || nQ == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, q_seg, kv_seg, q_pos, kv_pos, live_count, live_idx, out, lse, \
                   B, H, Hkv, Tq, Tkv, nQ, nK, causal, window, scale, st
  if (dtype == 0 && D == 64) launch<float, 64>(FLASH_ARGS);
  else if (dtype == 0 && D == 128) launch<float, 128>(FLASH_ARGS);
  else if (dtype == 1 && D == 64) launch<__nv_bfloat16, 64>(FLASH_ARGS);
  else if (dtype == 1 && D == 128) launch<__nv_bfloat16, 128>(FLASH_ARGS);
  else return (int)cudaErrorInvalidValue;
#undef FLASH_ARGS
  return (int)cudaGetLastError();
}
