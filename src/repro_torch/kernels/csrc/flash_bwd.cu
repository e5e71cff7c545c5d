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
//   * each gradient in its input's type.
// Every block owns its output tile outright and loops over what it sums:
// no atomics, no workspace, and two launches give bitwise-equal results.
// The wrapper hands each kernel compacted lists of live tile pairs at the
// kernel's own tile sizes (exported below): per (stream, Q tile) the live
// KV tiles for dq, per (stream, KV tile) the live Q tiles for dk/dv.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s).  On packed training
// streams both kernels are bound by operations: 6*D flops per live score
// per query head for dq (s, dp, dq) and 8*D for dk/dv (s, dp, dk, dv).  At
// the mllm_10b backbone's training shape (2 streams of ~7.3k tokens, 28/4
// heads, D 128) that is ~0.11 ms of tensor work for dq and ~0.15 ms for
// dk/dv, against ~5 MB of operands: a tile's products must run on the
// tensor cores, with its loads overlapped and its softmax-side arithmetic
// (mask, exp2, ds) kept in registers.
//
// bf16 design (the training path):
//   * Products by wgmma.mma_async m64nNk16: bf16 operands, fp32
//     accumulators in registers.  Operands in shared memory are laid out
//     in the 128-byte swizzle TMA writes (a tile of D columns as D / 64
//     boxes of 64 columns).  384 threads: warpgroups 0 and 1 consume (64
//     accumulator rows each), warp 0 of warpgroup 2 produces; setmaxnreg
//     moves registers from the producer (24) to the consumers (240).
//   * Loads: one producer lane issues TMA copies into 4 stages (dq: one
//     ring; dk/dv: a ring of 2 per consumer warpgroup) with a full and an
//     empty mbarrier each; its warp writes the stage's small
//     operands (seg, pos; lse, delta) with plain loads and stores and
//     arrives on the full barrier with it.  Tensor maps are 3-D
//     [B*H, T, D] / [B*Hkv, T, D], encoded at each launch, so a box that
//     runs past T is zero-filled and never reads the next head's rows.
//   * dq: one block per (stream*head, 128-row Q tile), grid (nQ, B*H); its
//     Q and dO tiles stay in shared memory, one ring brings 64-key K and V
//     tiles of the live list to both warpgroups.  S = Q K^T and dP = dO V^T
//     (m64n64, both operands from shared memory); P = exp2(S * scale *
//     log2e - lse * log2e) and dS in registers; dQ += dS K with dS as the
//     register A operand (the accumulator's layout is wgmma's A layout)
//     and K MN-major.  Causal Q tiles are walked last-first: late tiles
//     have the longest lists, so the short ones fill the tail.
//   * dk/dv: one block per (stream*KV head, 64-key KV tile), grid (nK,
//     B*Hkv); K and V stay in shared memory.  Each live Q tile is walked
//     with every query head of the GQA group inside it, so the group sum
//     forms in registers; the stages carry the 64-row Q and dO tiles and
//     their lse, delta, seg and pos.  S^T = K Q^T and dP^T = V dO^T put
//     keys on the accumulator's rows, so P^T and dS^T are already A
//     operands: dV += P^T dO and dK += dS^T Q with dO and Q MN-major, with
//     no shared-memory round trip.  The mask of a (KV tile, Q tile) pair
//     is the same for every head of the group: it is formed once, as 32
//     bits a thread.  One block's walk of its list is what bounds dk/dv
//     where a long document starts: in the first mllm_10b training batch
//     (2 x 7,296 tokens, 28/4 heads) the busiest KV tile has 73 live Q
//     tiles, 511 stages with 7 heads, against 247 stages per SM for the
//     whole launch at 128-key tiles.  So both warpgroups hold the same 64
//     keys and split the list (Q tiles w, w + 2, ...), each from its own
//     ring, and warpgroup 0 adds warpgroup 1's partial dK and dV through
//     shared memory at the end: a fixed order, so the result stays
//     bitwise repeatable.
//   * Registers: dk/dv at D 128 holds dK and dV (64 + 64 fp32), S^T and
//     dP^T (32 + 32) and the bf16 P^T and dS^T operands (16 + 16) a
//     thread, within the consumers' 240; ptxas reports 168 registers at
//     entry (384 threads, one block an SM) and no spills.
//   * Precision: P and dS enter the second products as bf16 (every
//     tensor-core flash backward does so); the Pallas kernels keep them in
//     fp32.  Every product accumulates in fp32.
//   * Epilogue: bf16 in registers, a 4 x 4 transpose across each quad of
//     lanes, 16-byte stores masked to T.
//
// fp32 (the agreement runs) keeps the simple design: 16-row Q tiles and
// 32-key KV tiles staged in shared memory as fp32 with rows padded by one
// word; scalar FMAs on the CUDA cores; 8 threads a query row (dq) and 4
// threads a key (dk/dv).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using hopper::allow_smem;
using hopper::attends;

// =====================================================================
// fp32: scalar FMAs over 16 x 32 tiles.
// =====================================================================
namespace scalar {

constexpr int BQ = 16;            // query rows per tile
constexpr int BK = 32;            // keys per KV tile
constexpr int THREADS = 128;
constexpr int LANES_Q = 8;        // dq: threads per query row
constexpr int KPL = BK / LANES_Q; // dq: keys scored per lane per tile
constexpr int PARTS = 4;          // dkv: threads per key
constexpr int RPT = BQ / PARTS;   // dkv: query rows scored per thread per tile

static_assert(BQ * LANES_Q == THREADS, "dq layout");
static_assert(BK * PARTS == THREADS, "dkv layout");

// rows [r0, r0 + R) of a [T, D] matrix into shared memory with row stride
// D + 1; rows past T read as 0.
template <int D, int R>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0, int Tn) {
  for (int i = threadIdx.x; i < R * D; i += THREADS) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = (r0 + r < Tn) ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

template <int D> constexpr int dq_smem_floats() { return 2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1); }
template <int D> constexpr int dkv_smem_floats() { return 2 * BQ * (D + 1) + 2 * BK * (D + 1) + 2 * BQ * (BK + 1); }

// dq: grid (B*H, nQ).
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                const int* __restrict__ live_count, const int* __restrict__ live_idx,
                float* __restrict__ dq, int H, int Hkv, int Tq, int Tkv, int nQ, int nK,
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

  stage<D, BQ>(q_s, q + (size_t)bh * Tq * D, q0, Tq);
  stage<D, BQ>(do_s, dout + (size_t)bh * Tq * D, q0, Tq);
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
  const float* kb = k + (size_t)kvh * Tkv * D;
  const float* vb = v + (size_t)kvh * Tkv * D;

  for (int it = 0; it < n_live; ++it) {
    const int k0 = tiles[it] * BK;
    __syncthreads();  // the previous tile's k_s / v_s are no longer read
    stage<D, BK>(k_s, kb, k0, Tkv);
    stage<D, BK>(v_s, vb, k0, Tkv);
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
    float* o = dq + ((size_t)bh * Tq + qrow) * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) o[lane + LANES_Q * j] = acc[j];
  }
}

// dk/dv: grid (B*Hkv, nK).
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                 const int* __restrict__ t_count, const int* __restrict__ t_idx,
                 float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int Tq,
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

  stage<D, BK>(k_s, k + (size_t)bkvh * Tkv * D, k0, Tkv);
  stage<D, BK>(v_s, v + (size_t)bkvh * Tkv * D, k0, Tkv);
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
      stage<D, BQ>(q_s, q + (size_t)bh * Tq * D, q0, Tq);
      stage<D, BQ>(do_s, dout + (size_t)bh * Tq * D, q0, Tq);
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
      dk[off + part + PARTS * j] = dk_acc[j];
      dv[off + part + PARTS * j] = dv_acc[j];
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const int* q_seg,
                      const int* kv_seg, const int* q_pos, const int* kv_pos,
                      const int* live_count, const int* live_idx, void* dq, int B,
                      int H, int Hkv, int Tq, int Tkv, int nQ, int nK, int causal,
                      int window, float scale, cudaStream_t stream) {
  const int bytes = dq_smem_floats<D>() * (int)sizeof(float);
  static unsigned sized = 0;
  const cudaError_t rc = allow_smem(flash_dq_kernel<D>, bytes, sized);
  if (rc != cudaSuccess) return rc;
  flash_dq_kernel<D><<<dim3(B * H, nQ), THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta, q_seg,
      kv_seg, q_pos, kv_pos, live_count, live_idx, static_cast<float*>(dq), H, Hkv, Tq,
      Tkv, nQ, nK, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const int* q_seg,
                       const int* kv_seg, const int* q_pos, const int* kv_pos,
                       const int* t_count, const int* t_idx, void* dk, void* dv, int B,
                       int H, int Hkv, int Tq, int Tkv, int nQ, int nK, int causal,
                       int window, float scale, cudaStream_t stream) {
  const int bytes = dkv_smem_floats<D>() * (int)sizeof(float);
  static unsigned sized = 0;
  const cudaError_t rc = allow_smem(flash_dkv_kernel<D>, bytes, sized);
  if (rc != cudaSuccess) return rc;
  flash_dkv_kernel<D><<<dim3(B * Hkv, nK), THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta, q_seg,
      kv_seg, q_pos, kv_pos, t_count, t_idx, static_cast<float*>(dk),
      static_cast<float*>(dv), H, Hkv, Tq, Tkv, nQ, nK, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace scalar

// =====================================================================
// bf16: wgmma, a TMA ring, warp specialisation.
// =====================================================================
namespace hop {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 384;  // warpgroups 0, 1 consume; warp 0 of warpgroup 2 produces
constexpr int STAGES = 4;     // dq: one ring; dk/dv: a ring of STAGES / 2 per warpgroup
constexpr int DQ_BQ = 128, DQ_BK = 64;    // dq: Q rows (2 x 64) and keys of a tile
constexpr int DKV_BQ = 64, DKV_BK = 64;   // dk/dv: Q rows and keys of a tile
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the dq kernel, byte offsets from a 1024-aligned base.
template <int D> struct DqSmem {
  static constexpr int Q_BYTES = DQ_BQ * D * 2;   // the Q (or dO) tile
  static constexpr int KV_BYTES = DQ_BK * D * 2;  // a K (or V) tile
  static constexpr int STAGE = 2 * KV_BYTES;      // K then V
  static constexpr int Q = 0, DO = Q_BYTES, RING = 2 * Q_BYTES;
  static constexpr int META = RING + STAGES * STAGE;  // int seg, pos [STAGES][DQ_BK]
  static constexpr int BARS = META + STAGES * 2 * DQ_BK * 4;  // full, empty, q
  static constexpr int BYTES = 1024 + BARS + (2 * STAGES + 1) * 8;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// Shared memory of the dk/dv kernel: warpgroup w's ring is stages
// [w * STAGES / 2, (w + 1) * STAGES / 2).  At the end the rings hold
// warpgroup 1's partial dK and dV (fp32) for warpgroup 0 to add.
template <int D> struct DkvSmem {
  static constexpr int KV_BYTES = DKV_BK * D * 2;  // the K (or V) tile
  static constexpr int Q_BYTES = DKV_BQ * D * 2;   // a Q (or dO) tile
  static constexpr int STAGE = 2 * Q_BYTES;        // Q then dO
  static constexpr int K = 0, V = KV_BYTES, RING = 2 * KV_BYTES;
  static constexpr int META = RING + STAGES * STAGE;  // float lse2, delta; int seg, pos
  static constexpr int BARS = META + STAGES * 4 * DKV_BQ * 4;  // full, empty, kv
  static constexpr int BYTES = 1024 + BARS + (2 * STAGES + 1) * 8;
  static_assert(BYTES <= 232448, "shared memory of one block");
  static_assert(D * 128 * 4 <= STAGES * STAGE, "the partials fit in the rings");
};

// ---------------------------------------------------------------------------
// dq: grid (nQ, B*H).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                      const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                      const int* __restrict__ live_count, const int* __restrict__ live_idx,
                      bf16* __restrict__ dq, int H, int Hkv, int Tq, int Tkv, int nQ, int nK,
                      int causal, int window, float scale) {
  using L = DqSmem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = aligned_base(smem_raw);
  int* meta = reinterpret_cast<int*>(base + L::META);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = full + 2 * STAGES;
  init_bars(full, STAGES, 2);

  const int bh = blockIdx.y;
  const int qt = causal ? nQ - 1 - blockIdx.x : blockIdx.x;
  const int b = bh / H;
  const int kvh = b * Hkv + (bh % H) / (H / Hkv);
  const int q0 = qt * DQ_BQ;
  const int n_live = live_count[b * nQ + qt];
  const int* tiles = live_idx + ((size_t)b * nQ + qt) * nK;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: warp 0; lane 0 issues the copies ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x & 31;
    if (n_live > 0 && lane == 0) {
      mbar_expect_tx(resident, 2 * L::Q_BYTES);
      load_tile<D, DQ_BQ>(base + L::Q, &map_q, resident, q0, bh);
      load_tile<D, DQ_BQ>(base + L::DO, &map_do, resident, q0, bh);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < n_live; ++it) {
      const int k0 = tiles[it] * DQ_BK;
      mbar_wait(&empty[stage], phase ^ 1);
      int* seg = meta + stage * 2 * DQ_BK;
      for (int i = lane; i < DQ_BK; i += 32) {
        const bool ok = k0 + i < Tkv;
        seg[i] = ok ? kv_seg[(size_t)b * Tkv + k0 + i] : 0;
        seg[DQ_BK + i] = ok ? kv_pos[(size_t)b * Tkv + k0 + i] : 0;
      }
      if (lane == 0) {
        uint8_t* st = base + L::RING + stage * L::STAGE;
        mbar_expect_tx(&full[stage], L::STAGE);
        load_tile<D, DQ_BK>(st, &map_k, &full[stage], k0, kvh);
        load_tile<D, DQ_BK>(st + L::KV_BYTES, &map_v, &full[stage], k0, kvh);
      } else {
        mbar_arrive(&full[stage]);
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns Q rows q0 + 64 wg .. + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128, lane = tid % 32, quad = lane & 3;
  const int rl = 64 * wg + 16 * (tid / 32) + lane / 4;  // this thread's rows rl, rl + 8
  int qs[2], qp[2];
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + rl + 8 * h;
    const bool ok = r < Tq;
    qs[h] = ok ? q_seg[(size_t)b * Tq + r] : 0;
    qp[h] = ok ? q_pos[(size_t)b * Tq + r] : 0;
    l2[h] = ok ? lse[(size_t)bh * Tq + r] * LOG2E : 0.f;
    dl[h] = ok ? delta[(size_t)bh * Tq + r] : 0.f;
  }
  const float sl2 = scale * LOG2E;
  const uint32_t q_tile = smem_u32(base + L::Q), do_tile = smem_u32(base + L::DO);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (n_live > 0) mbar_wait(resident, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_live; ++it) {
    mbar_wait(&full[stage], phase);
    const uint32_t k_tile = smem_u32(base + L::RING + stage * L::STAGE);
    const uint32_t v_tile = k_tile + L::KV_BYTES;
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_ss_n64(s, kmajor(q_tile, DQ_BQ, 64 * wg, ks), kmajor(k_tile, DQ_BK, 0, ks), ks);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_ss_n64(dp, kmajor(do_tile, DQ_BQ, 64 * wg, ks), kmajor(v_tile, DQ_BK, 0, ks), ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const int* seg = meta + stage * 2 * DQ_BK;
    uint32_t a[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * quad;
      const int2 ks2 = *reinterpret_cast<const int2*>(seg + c);
      const int2 kp2 = *reinterpret_cast<const int2*>(seg + DQ_BK + c);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const bool ok = attends(qs[h], qp[h], e % 2 ? ks2.y : ks2.x, e % 2 ? kp2.y : kp2.x,
                                causal, window);
        const float p = exp2f(fmaf(s[4 * j + e], sl2, -l2[h]));
        ds[e] = ok ? p * (dp[4 * j + e] - dl[h]) * scale : 0.f;
      }
      to_operand(a, j, ds[0], ds[1], ds[2], ds[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) mma_rs<D>(acc, a[kk], mnmajor(k_tile, DQ_BK, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a);
    if (tid == 0) mbar_arrive(&empty[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  store_rows<D>(acc, dq + (size_t)bh * Tq * D, q0 + 64 * wg, Tq);
}

// ---------------------------------------------------------------------------
// dk/dv: grid (nK, B*Hkv).  Both consumer warpgroups hold the block's 64
// keys; warpgroup w walks live Q tiles w, w + 2, ... (every head of the
// group in each), from its own ring, and warpgroup 0 adds warpgroup 1's
// partial sums at the end: a long list is walked in half the time.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                       const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                       const int* __restrict__ t_count, const int* __restrict__ t_idx,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int Tq,
                       int Tkv, int nQ, int nK, int causal, int window, float scale) {
  using L = DkvSmem<D>;
  constexpr int RING = STAGES / 2;  // stages of each warpgroup's ring
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = aligned_base(smem_raw);
  float* meta = reinterpret_cast<float*>(base + L::META);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = full + 2 * STAGES;
  init_bars(full, STAGES, 1);

  const int bkvh = blockIdx.y;  // b * Hkv + kv head
  const int kt = blockIdx.x;
  const int b = bkvh / Hkv;
  const int group = H / Hkv;
  const int h0 = b * H + (bkvh % Hkv) * group;  // first query head of the group
  const int k0 = kt * DKV_BK;
  const int n_live = t_count[b * nK + kt];
  const int* tiles = t_idx + ((size_t)b * nK + kt) * nQ;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: stages go to the two rings in turn, head by head ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x & 31;
    if (n_live > 0 && lane == 0) {
      mbar_expect_tx(resident, 2 * L::KV_BYTES);
      load_tile<D, DKV_BK>(base + L::K, &map_k, resident, k0, bkvh);
      load_tile<D, DKV_BK>(base + L::V, &map_v, resident, k0, bkvh);
    }
    int seq[2] = {0, 0};  // stages issued to each ring
    for (int it = 0; it < n_live; it += 2) {
      for (int m = 0; m < group; ++m) {
        const int bh = h0 + m;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          if (it + w >= n_live) break;
          const int q0 = tiles[it + w] * DKV_BQ;
          const int stage = w * RING + seq[w] % RING;
          mbar_wait(&empty[stage], ((seq[w] / RING) & 1) ^ 1);
          ++seq[w];
          float* l2 = meta + stage * 4 * DKV_BQ;
          for (int i = lane; i < DKV_BQ; i += 32) {
            const int r = q0 + i;
            const bool ok = r < Tq;
            l2[i] = ok ? lse[(size_t)bh * Tq + r] * LOG2E : 0.f;
            l2[DKV_BQ + i] = ok ? delta[(size_t)bh * Tq + r] : 0.f;
            reinterpret_cast<int*>(l2)[2 * DKV_BQ + i] = ok ? q_seg[(size_t)b * Tq + r] : 0;
            reinterpret_cast<int*>(l2)[3 * DKV_BQ + i] = ok ? q_pos[(size_t)b * Tq + r] : 0;
          }
          if (lane == 0) {
            uint8_t* st = base + L::RING + stage * L::STAGE;
            mbar_expect_tx(&full[stage], L::STAGE);
            load_tile<D, DKV_BQ>(st, &map_q, &full[stage], q0, bh);
            load_tile<D, DKV_BQ>(st + L::Q_BYTES, &map_do, &full[stage], q0, bh);
          } else {
            mbar_arrive(&full[stage]);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: keys k0 .. k0 + 63; warpgroup wg walks Q tiles wg, wg + 2, ... ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128, lane = tid % 32, quad = lane & 3;
  const int rl = 16 * (tid / 32) + lane / 4;  // this thread's keys rl, rl + 8
  int ks[2], kp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k0 + rl + 8 * h;
    const bool ok = r < Tkv;
    ks[h] = ok ? kv_seg[(size_t)b * Tkv + r] : 0;
    kp[h] = ok ? kv_pos[(size_t)b * Tkv + r] : 0;
  }
  const float sl2 = scale * LOG2E;
  const uint32_t k_tile = smem_u32(base + L::K), v_tile = smem_u32(base + L::V);

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  if (n_live > wg) mbar_wait(resident, 0);

  int seq = 0;
  uint32_t mask = 0;
  for (int it = wg; it < n_live; it += 2) {
    for (int m = 0; m < group; ++m, ++seq) {
      const int stage = wg * RING + seq % RING;
      mbar_wait(&full[stage], (seq / RING) & 1);
      const uint32_t q_tile = smem_u32(base + L::RING + stage * L::STAGE);
      const uint32_t do_tile = q_tile + L::Q_BYTES;
      const float* l2 = meta + stage * 4 * DKV_BQ;
      const float* dl = l2 + DKV_BQ;
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < D / 16; ++kq)
        mma_ss_n64(s, kmajor(k_tile, DKV_BK, 0, kq), kmajor(q_tile, DKV_BQ, 0, kq), kq);
#pragma unroll
      for (int kq = 0; kq < D / 16; ++kq)
        mma_ss_n64(dp, kmajor(v_tile, DKV_BK, 0, kq), kmajor(do_tile, DKV_BQ, 0, kq), kq);
      wgmma_commit();
      if (m == 0) {  // one mask serves every head of the group
        const int* qseg = reinterpret_cast<const int*>(l2) + 2 * DKV_BQ;
        const int* qpos = qseg + DKV_BQ;
        mask = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * quad;
          const int2 qs2 = *reinterpret_cast<const int2*>(qseg + c);
          const int2 qp2 = *reinterpret_cast<const int2*>(qpos + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e / 2;
            const bool ok = attends(e % 2 ? qs2.y : qs2.x, e % 2 ? qp2.y : qp2.x, ks[h], kp[h],
                                    causal, window);
            mask |= (uint32_t)ok << (4 * j + e);
          }
        }
      }
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * quad;
        const float2 lc = *reinterpret_cast<const float2*>(l2 + c);
        const float2 dc = *reinterpret_cast<const float2*>(dl + c);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = (mask >> (4 * j + e)) & 1u;
          const float pe = exp2f(fmaf(s[4 * j + e], sl2, -(e % 2 ? lc.y : lc.x)));
          p[e] = ok ? pe : 0.f;
          ds[e] = ok ? pe * (dp[4 * j + e] - (e % 2 ? dc.y : dc.x)) * scale : 0.f;
        }
        to_operand(pa, j, p[0], p[1], p[2], p[3]);
        to_operand(da, j, ds[0], ds[1], ds[2], ds[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        mma_rs<D>(dv_acc, pa[kk], mnmajor(do_tile, DKV_BQ, kk));
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        mma_rs<D>(dk_acc, da[kk], mnmajor(q_tile, DKV_BQ, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
      if (tid == 0) mbar_arrive(&empty[stage]);
    }
  }

  // Warpgroup 1's partials through the (now idle) rings, in its register
  // order, so that thread t of warpgroup 0 reads the entries it holds.
  float* part = reinterpret_cast<float*>(base + L::RING);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // every stage is consumed
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      part[i * 128 + tid] = dk_acc[i];
      part[(D / 2 + i) * 128 + tid] = dv_acc[i];
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] += part[i * 128 + tid];
    dv_acc[i] += part[(D / 2 + i) * 128 + tid];
  }
  const size_t off = (size_t)bkvh * Tkv * D;
  store_rows<D>(dk_acc, dk + off, k0, Tkv);
  store_rows<D>(dv_acc, dv + off, k0, Tkv);
}

// ---- host: tensor maps and launches -----------------------------------------

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const int* q_seg,
                      const int* kv_seg, const int* q_pos, const int* kv_pos,
                      const int* live_count, const int* live_idx, void* dq, int B, int H,
                      int Hkv, int Tq, int Tkv, int nQ, int nK, int causal, int window,
                      float scale, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  if (!head_map(&mq, q, B * H, Tq, D, DQ_BQ) || !head_map(&mdo, dout, B * H, Tq, D, DQ_BQ) ||
      !head_map(&mk, k, B * Hkv, Tkv, D, DQ_BK) || !head_map(&mv, v, B * Hkv, Tkv, D, DQ_BK))
    return cudaErrorInvalidValue;
  static unsigned sized = 0;
  const cudaError_t rc = allow_smem(flash_dq_wgmma_kernel<D>, DqSmem<D>::BYTES, sized);
  if (rc != cudaSuccess) return rc;
  flash_dq_wgmma_kernel<D><<<dim3(nQ, B * H), THREADS, DqSmem<D>::BYTES, stream>>>(
      mq, mdo, mk, mv, lse, delta, q_seg, kv_seg, q_pos, kv_pos, live_count, live_idx,
      static_cast<bf16*>(dq), H, Hkv, Tq, Tkv, nQ, nK, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const int* q_seg,
                       const int* kv_seg, const int* q_pos, const int* kv_pos,
                       const int* t_count, const int* t_idx, void* dk, void* dv, int B, int H,
                       int Hkv, int Tq, int Tkv, int nQ, int nK, int causal, int window,
                       float scale, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  if (!head_map(&mq, q, B * H, Tq, D, DKV_BQ) || !head_map(&mdo, dout, B * H, Tq, D, DKV_BQ) ||
      !head_map(&mk, k, B * Hkv, Tkv, D, DKV_BK) || !head_map(&mv, v, B * Hkv, Tkv, D, DKV_BK))
    return cudaErrorInvalidValue;
  static unsigned sized = 0;
  const cudaError_t rc = allow_smem(flash_dkv_wgmma_kernel<D>, DkvSmem<D>::BYTES, sized);
  if (rc != cudaSuccess) return rc;
  flash_dkv_wgmma_kernel<D><<<dim3(nK, B * Hkv), THREADS, DkvSmem<D>::BYTES, stream>>>(
      mq, mdo, mk, mv, lse, delta, q_seg, kv_seg, q_pos, kv_pos, t_count, t_idx,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hkv, Tq, Tkv, nQ, nK, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace hop

// Tiles (query rows, keys) of kernel 0 = dq or 1 = dk/dv for dtype 0 =
// fp32 or 1 = bf16; the lists a kernel walks must be made at its tiles.
int block_q(int kernel, int dtype) {
  if (dtype == 1) return kernel == 0 ? hop::DQ_BQ : hop::DKV_BQ;
  return scalar::BQ;
}
int block_kv(int kernel, int dtype) {
  if (dtype == 1) return kernel == 0 ? hop::DQ_BK : hop::DKV_BK;
  return scalar::BK;
}

// The list dimensions must be the tile counts of the kernel's tiles.
bool tiles_ok(int kernel, int dtype, int Tq, int Tkv, int nQ, int nK) {
  const int bq = block_q(kernel, dtype), bk = block_kv(kernel, dtype);
  return nQ == (Tq + bq - 1) / bq && nK == (Tkv + bk - 1) / bk;
}

}  // namespace

extern "C" int flash_bwd_block_q(int kernel, int dtype) { return block_q(kernel, dtype); }
extern "C" int flash_bwd_block_kv(int kernel, int dtype) { return block_kv(kernel, dtype); }

// q/dout [B*H, Tq, D], k/v [B*Hkv, Tkv, D] (dtype: 0 = fp32, 1 = bf16);
// lse/delta [B*H, Tq] fp32; seg/pos [B, T] int32; live_count [B, nQ] and
// live_idx [B, nQ, nK] int32 (the live KV tiles of each Q tile, at the dq
// kernel's tiles); dq like q.  window < 0 means no window.  Launches on
// `stream` and returns the CUDA error code.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* q_seg,
                            const int* kv_seg, const int* q_pos, const int* kv_pos,
                            const int* live_count, const int* live_idx, void* dq, int B,
                            int H, int Hkv, int Tq, int Tkv, int D, int nQ, int nK,
                            int causal, int window, float scale, int dtype,
                            void* stream) {
  if (B * H == 0 || nQ == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || !tiles_ok(0, dtype, Tq, Tkv, nQ, nK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DQ_ARGS q, k, v, dout, lse, delta, q_seg, kv_seg, q_pos, kv_pos, live_count, \
                live_idx, dq, B, H, Hkv, Tq, Tkv, nQ, nK, causal, window, scale, st
  if (dtype == 0 && D == 64) return (int)scalar::launch_dq<64>(DQ_ARGS);
  if (dtype == 0 && D == 128) return (int)scalar::launch_dq<128>(DQ_ARGS);
  if (dtype == 1 && D == 64) return (int)hop::launch_dq<64>(DQ_ARGS);
  if (dtype == 1 && D == 128) return (int)hop::launch_dq<128>(DQ_ARGS);
#undef DQ_ARGS
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq, with t_count [B, nK] and t_idx [B, nK, nQ] int32: the
// live Q tiles of each KV tile, at the dk/dv kernel's tiles.  dk/dv like k.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse, const float* delta,
                             const int* q_seg, const int* kv_seg, const int* q_pos,
                             const int* kv_pos, const int* t_count, const int* t_idx,
                             void* dk, void* dv, int B, int H, int Hkv, int Tq, int Tkv,
                             int D, int nQ, int nK, int causal, int window, float scale,
                             int dtype, void* stream) {
  if (B * Hkv == 0 || nK == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || !tiles_ok(1, dtype, Tq, Tkv, nQ, nK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DKV_ARGS q, k, v, dout, lse, delta, q_seg, kv_seg, q_pos, kv_pos, t_count, t_idx, \
                 dk, dv, B, H, Hkv, Tq, Tkv, nQ, nK, causal, window, scale, st
  if (dtype == 0 && D == 64) return (int)scalar::launch_dkv<64>(DKV_ARGS);
  if (dtype == 0 && D == 128) return (int)scalar::launch_dkv<128>(DKV_ARGS);
  if (dtype == 1 && D == 64) return (int)hop::launch_dkv<64>(DKV_ARGS);
  if (dtype == 1 && D == 128) return (int)hop::launch_dkv<128>(DKV_ARGS);
#undef DKV_ARGS
  return (int)cudaErrorInvalidValue;
}
