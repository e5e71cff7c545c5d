// Segment-masked GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// src/repro/kernels/flash_attention.py:181 and computes what it computes:
//   * mask = same segment & seg > 0 & (causal: kv_pos <= q_pos)
//            & (window: q_pos - kv_pos < window)      (its `_tile_mask`);
//   * scores scaled by 1/sqrt(D), masked probabilities exactly 0;
//   * online softmax with m, l and the output accumulator in fp32;
//   * rows with l == 0 (fully masked) give out 0 and lse 0, otherwise
//     out = acc / l and lse = m + log(l);
//   * q head h reads KV head h / (H / Hkv);
//   * bf16 or fp32 in, out in the type of q, lse fp32.
// One block owns its output rows outright and loops over their live KV
// tiles itself: nothing is carried between blocks, no atomics, and two
// launches give bitwise-equal results.  The wrapper
// (kernels/flash_attention.py) hands it compacted per-(stream, Q tile)
// lists of live KV-tile indices, made at the kernel's own tiles (exported
// below per mode and dtype); ragged edges are masked here.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s).  Training streams are
// bound by operations: 4*D flops per live score per query head (~0.07 ms
// at the mllm_10b backbone's training shape, 2 x 7.3k tokens, 28/4 heads,
// D 128).  Decode (one live query row per stream, padded to 8) is bound by
// bytes: the live K/V, read once per KV head (~1 us at 8 streams of 64-320
// tokens, 4 KV heads).  So the products run on the tensor cores with their
// loads overlapped, and at decode a KV head's K/V is read once for its
// whole GQA group.
//
// bf16 design:
//   * Products by wgmma.mma_async: S = Q K^T (m64n64k16, both operands
//     from shared memory in the 128-byte swizzle TMA writes), then
//     O += P V (m64nDk16) with P converted to bf16 in place as the
//     register A operand (the accumulator's layout is wgmma's A layout)
//     and V MN-major.  P is never written to shared memory.
//   * Softmax in fp32 registers: the mask (32 bits a thread, formed while
//     S is computed), the running max across each quad of lanes, exp2 with
//     scale * log2(e) folded in, the correction of l and O; l is summed
//     from the fp32 probabilities, a thread's share reduced at the end.
//   * Loads: warp 0 of the last warpgroup produces; its lane 0 issues TMA
//     copies of 64-key K and V tiles of the live list into a 4-stage ring
//     (full and empty mbarrier each), its lanes write the stage's key
//     seg/pos.  Tensor maps are 3-D [heads, T, D], encoded per launch, so a
//     box past T reads zeros, never the next head's rows.  Q stays
//     resident.
//   * Tiled mode (training, prefill): one block per (query head, stream *
//     KV head, 128-row Q tile), two consumer warpgroups of 64 rows;
//     setmaxnreg moves registers from the producer (24) to the consumers
//     (240).  The grid runs the query heads of one KV head next to each
//     other, so their K/V tiles are read from L2, and causal Q tiles last
//     first: late tiles have the longest lists.
//   * Packed mode (decode: g * Tq <= 64, g = H / Hkv): a group's query
//     heads are adjacent in [B, H, Tq, D], so q and out are viewed as
//     [B * Hkv, g * Tq, D] and one block per (stream, KV head) holds the
//     whole group in the 64 rows of one consumer warpgroup: row r is query
//     head r / Tq at query row r % Tq.  K/V are read once per group, and
//     the tile holds g * Tq live rows instead of 1 of 16.
//
// fp32 (the agreement runs) keeps the simple design: 16 x 32 tiles staged
// in shared memory as fp32 (rows padded by one word), scalar FMAs, 8
// threads per query row whose softmax statistics reduce with shuffles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

// =====================================================================
// fp32: scalar FMAs over 16 x 32 tiles.
// =====================================================================
namespace scalar {

constexpr int BQ = 16;            // query rows per tile (one block)
constexpr int BK = 32;            // keys per KV tile
constexpr int LANES = 8;          // threads per query row
constexpr int THREADS = BQ * LANES;
constexpr int KPL = BK / LANES;   // keys scored per lane per tile
constexpr float NEG_INF = -1073741824.0f;  // -2^30, as in the reference

// grid (B*H, nQ).
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos, const int* __restrict__ live_count,
                 const int* __restrict__ live_idx, float* __restrict__ out,
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

  const float* qb = q + (size_t)bh * Tq * D;
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    q_s[r * DP + c] = (q0 + r < Tq) ? qb[(size_t)(q0 + r) * D + c] : 0.f;
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
  const float* kb = k + (size_t)kvh * Tkv * D;
  const float* vb = v + (size_t)kvh * Tkv * D;

  for (int it = 0; it < n_live; ++it) {
    const int k0 = tiles[it] * BK;
    __syncthreads();  // the previous tile's k_s / v_s are no longer read
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < Tkv;
      const size_t off = (size_t)(k0 + r) * D + c;
      k_s[r * DP + c] = ok ? kb[off] : 0.f;
      v_s[r * D + c] = ok ? vb[off] : 0.f;
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
      live[j] = hopper::attends(qs, qp, kseg_s[c], kpos_s[c], causal, window);
      s[j] = live[j] ? s[j] * scale : NEG_INF;
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
    float* o = out + ((size_t)bh * Tq + qrow) * D;
#pragma unroll
    for (int j = 0; j < CPL; ++j) o[lane + LANES * j] = acc[j] / l_safe;
    if (lane == 0) lse[(size_t)bh * Tq + qrow] = (l > 0.f) ? m + logf(l_safe) : 0.f;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_seg,
                   const int* kv_seg, const int* q_pos, const int* kv_pos,
                   const int* live_count, const int* live_idx, void* out, float* lse, int B,
                   int H, int Hkv, int Tq, int Tkv, int nQ, int nK, int causal, int window,
                   float scale, cudaStream_t stream) {
  flash_fwd_kernel<D><<<dim3(B * H, nQ), THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), q_seg, kv_seg, q_pos, kv_pos, live_count, live_idx,
      static_cast<float*>(out), lse, H, Hkv, Tq, Tkv, nQ, nK, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace scalar

// =====================================================================
// bf16: wgmma fed by a TMA ring, warp specialisation.
// =====================================================================
namespace hop {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int STAGES = 4;
constexpr int BQ_TILED = 128;   // tiled: Q rows of a block (2 consumer warpgroups x 64)
constexpr int BQ_PACKED = 64;   // packed: the most rows (g * Tq) of a group a block holds
constexpr int BK_WG = 64;       // keys of a K/V tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG = -1073741824.0f;  // the running max before any live score

// Shared memory of a block with a ROWS-row Q tile, byte offsets from a
// 1024-aligned base.
template <int D, int ROWS> struct Smem {
  static constexpr int Q_BYTES = ROWS * D * 2;     // the resident Q tile
  static constexpr int KV_BYTES = BK_WG * D * 2; // a K (or V) tile
  static constexpr int STAGE = 2 * KV_BYTES;     // K then V
  static constexpr int Q = 0, RING = Q_BYTES;
  static constexpr int META = RING + STAGES * STAGE;  // int seg, pos [STAGES][BK_WG]
  static constexpr int BARS = META + STAGES * 2 * BK_WG * 4;  // full, empty, q
  static constexpr int BYTES = 1024 + BARS + (2 * STAGES + 1) * 8;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// Tiled: grid (H / Hkv, B*Hkv, nQ), blockIdx.x the query head of the group,
// blockIdx.z the Q tile (causal: last first).  Packed: grid (1, B*Hkv, 1),
// q / out / lse viewed as [B*Hkv, g*Tq(, D)], lists of one Q tile a stream.
template <int D, bool PACKED>
__global__ void __launch_bounds__(PACKED ? 256 : 384, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                       const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
                       const int* __restrict__ live_count, const int* __restrict__ live_idx,
                       bf16* __restrict__ out, float* __restrict__ lse, int H, int Hkv, int Tq,
                       int Tkv, int nQ, int nK, int causal, int window, float scale) {
  constexpr int WG = PACKED ? 1 : 2;  // consumer warpgroups; warpgroup WG produces
  constexpr int Q_ROWS = 64 * WG;     // rows of the resident Q tile
  using L = Smem<D, Q_ROWS>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = aligned_base(smem_raw);
  int* meta = reinterpret_cast<int*>(base + L::META);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* resident = full + 2 * STAGES;
  init_bars(full, STAGES, WG);

  const int g = H / Hkv;
  const int bkvh = blockIdx.y;  // b * Hkv + kv head
  const int b = bkvh / Hkv;
  const int bh = b * H + (bkvh % Hkv) * g + blockIdx.x;  // tiled: the query head
  const int qt = PACKED ? 0 : (causal ? nQ - 1 - (int)blockIdx.z : (int)blockIdx.z);
  const int q0 = qt * Q_ROWS;
  const int rows = PACKED ? g * Tq : Tq;  // rows of the block's view of q / out
  const int n_live = live_count[b * nQ + qt];
  const int* tiles = live_idx + ((size_t)b * nQ + qt) * nK;
  const int wg = threadIdx.x / 128;

  if (wg == WG) {
    // ---- producer: warp 0; lane 0 issues the copies ----
    if constexpr (!PACKED) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x >= WG * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (n_live > 0 && lane == 0) {
      mbar_expect_tx(resident, L::Q_BYTES);
      load_tile<D, Q_ROWS>(base + L::Q, &map_q, resident, q0, PACKED ? bkvh : bh);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int it = 0; it < n_live; ++it) {
      const int k0 = tiles[it] * BK_WG;
      mbar_wait(&empty[stage], phase ^ 1);
      int* seg = meta + stage * 2 * BK_WG;
      for (int i = lane; i < BK_WG; i += 32) {
        const bool ok = k0 + i < Tkv;
        seg[i] = ok ? kv_seg[(size_t)b * Tkv + k0 + i] : 0;
        seg[BK_WG + i] = ok ? kv_pos[(size_t)b * Tkv + k0 + i] : 0;
      }
      if (lane == 0) {
        uint8_t* st = base + L::RING + stage * L::STAGE;
        mbar_expect_tx(&full[stage], L::STAGE);
        load_tile<D, BK_WG>(st, &map_k, &full[stage], k0, bkvh);
        load_tile<D, BK_WG>(st + L::KV_BYTES, &map_v, &full[stage], k0, bkvh);
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

  // ---- consumers: warpgroup wg owns rows q0 + 64 wg .. + 63 of the view ----
  if constexpr (!PACKED) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128, lane = tid % 32, quad = lane & 3;
  const int rl = 64 * wg + 16 * (tid / 32) + lane / 4;  // this thread's rows rl, rl + 8
  int qs[2], qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + rl + 8 * h;
    const bool ok = r < rows;
    const int t = PACKED ? r % Tq : r;  // packed: row r is head r / Tq at query row r % Tq
    qs[h] = ok ? q_seg[(size_t)b * Tq + t] : 0;
    qp[h] = ok ? q_pos[(size_t)b * Tq + t] : 0;
  }
  const float sl2 = scale * LOG2E;
  const uint32_t q_tile = smem_u32(base + L::Q);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG, NEG};  // running max of s * scale * log2(e), per row
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  if (n_live > 0) mbar_wait(resident, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < n_live; ++it) {
    mbar_wait(&full[stage], phase);
    const uint32_t k_tile = smem_u32(base + L::RING + stage * L::STAGE);
    const uint32_t v_tile = k_tile + L::KV_BYTES;
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma_ss_n64(s, kmajor(q_tile, Q_ROWS, 64 * wg, ks), kmajor(k_tile, BK_WG, 0, ks), ks);
    wgmma_commit();

    // The mask while the product runs: bit 4 j + e for element e of group j.
    const int* seg = meta + stage * 2 * BK_WG;
    uint32_t mask = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * quad;
      const int2 ks2 = *reinterpret_cast<const int2*>(seg + c);
      const int2 kp2 = *reinterpret_cast<const int2*>(seg + BK_WG + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const bool ok = attends(qs[h], qp[h], e % 2 ? ks2.y : ks2.x, e % 2 ? kp2.y : kp2.x,
                                causal, window);
        mask |= (uint32_t)ok << (4 * j + e);
      }
    }
    wgmma_wait<0>();
    fence_regs(s);

    // Online softmax in base 2: a row's max over its quad of lanes.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if ((mask >> i) & 1u) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i] * sl2);
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
    uint32_t a[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = (mask >> (4 * j + e)) & 1u;
        p[e] = ok ? exp2f(fmaf(s[4 * j + e], sl2, -m[e / 2])) : 0.f;
        l[e / 2] += p[e];
      }
      to_operand(a, j, p[0], p[1], p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i % 4) / 2];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK_WG / 16; ++kk) mma_rs<D>(acc, a[kk], mnmajor(v_tile, BK_WG, kk));
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

  // out = O / l (0 on fully masked rows), lse = m + log l (0 there).
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= inv[(i % 4) / 2];
  const size_t view = PACKED ? (size_t)bkvh : (size_t)bh;  // the block's [rows, D] slab
  store_rows<D>(acc, out + view * rows * D, q0 + 64 * wg, rows);
  if (quad == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + rl + 8 * h;
      if (r < rows) lse[view * rows + r] = l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : 0.f;
    }
  }
}

template <int D, bool PACKED>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_seg,
                   const int* kv_seg, const int* q_pos, const int* kv_pos,
                   const int* live_count, const int* live_idx, void* out, float* lse, int B,
                   int H, int Hkv, int Tq, int Tkv, int nQ, int nK, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr int WG = PACKED ? 1 : 2;
  using L = Smem<D, 64 * WG>;
  const int g = H / Hkv;
  CUtensorMap mq, mk, mv;
  const bool q_ok = PACKED ? head_map(&mq, q, B * Hkv, g * Tq, D, 64 * WG)
                           : head_map(&mq, q, B * H, Tq, D, 64 * WG);
  if (!q_ok || !head_map(&mk, k, B * Hkv, Tkv, D, BK_WG) ||
      !head_map(&mv, v, B * Hkv, Tkv, D, BK_WG))
    return cudaErrorInvalidValue;
  static unsigned sized = 0;
  const cudaError_t rc = allow_smem(flash_fwd_wgmma_kernel<D, PACKED>, L::BYTES, sized);
  if (rc != cudaSuccess) return rc;
  const dim3 grid = PACKED ? dim3(1, B * Hkv, 1) : dim3(g, B * Hkv, nQ);
  flash_fwd_wgmma_kernel<D, PACKED><<<grid, 128 * (WG + 1), L::BYTES, stream>>>(
      mq, mk, mv, q_seg, kv_seg, q_pos, kv_pos, live_count, live_idx, static_cast<bf16*>(out),
      lse, H, Hkv, Tq, Tkv, nQ, nK, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace hop

// Tiles of mode 0 = tiled or 1 = packed for dtype 0 = fp32 or 1 = bf16: the
// rows of a block's Q tile (packed: the most g * Tq rows of a group one
// block holds; 0 where the dtype has no packed mode) and the keys of a KV
// tile.  The lists a launch walks must be made at these tiles (packed: one
// Q tile of all Tq rows a stream).
int block_q(int packed, int dtype) {
  if (dtype == 1) return packed ? hop::BQ_PACKED : hop::BQ_TILED;
  return packed ? 0 : scalar::BQ;
}
int block_kv(int packed, int dtype) { return dtype == 1 ? hop::BK_WG : scalar::BK; }

bool tiles_ok(int packed, int dtype, int H, int Hkv, int Tq, int Tkv, int nQ, int nK) {
  const int bq = block_q(packed, dtype), bk = block_kv(packed, dtype);
  if (nK != (Tkv + bk - 1) / bk) return false;
  if (packed) return (H / Hkv) * Tq <= bq && nQ == 1;
  return nQ == (Tq + bq - 1) / bq;
}

}  // namespace

extern "C" int flash_fwd_block_q(int packed, int dtype) { return block_q(packed, dtype); }
extern "C" int flash_fwd_block_kv(int packed, int dtype) { return block_kv(packed, dtype); }

// q [B*H, Tq, D], k/v [B*Hkv, Tkv, D] (dtype: 0 = fp32, 1 = bf16);
// seg/pos [B, T] int32; live_count [B, nQ] and live_idx [B, nQ, nK] int32;
// out [B*H, Tq, D] in the dtype of q, lse [B*H, Tq] fp32.  window < 0 means
// no window; packed = 1 takes the packed mode (bf16, g * Tq rows in one
// tile).  Launches on `stream` and returns the CUDA error code.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* q_seg, const int* kv_seg, const int* q_pos,
                         const int* kv_pos, const int* live_count, const int* live_idx,
                         void* out, float* lse, int B, int H, int Hkv, int Tq, int Tkv,
                         int D, int nQ, int nK, int causal, int window, float scale,
                         int packed, int dtype, void* stream) {
  if (B * H == 0 || nQ == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || (packed && dtype != 1) ||
      !tiles_ok(packed, dtype, H, Hkv, Tq, Tkv, nQ, nK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, q_seg, kv_seg, q_pos, kv_pos, live_count, live_idx, out, lse, \
                   B, H, Hkv, Tq, Tkv, nQ, nK, causal, window, scale, st
  if (dtype == 0 && D == 64) return (int)scalar::launch<64>(FLASH_ARGS);
  if (dtype == 0 && D == 128) return (int)scalar::launch<128>(FLASH_ARGS);
  if (dtype == 1 && D == 64 && packed) return (int)hop::launch<64, true>(FLASH_ARGS);
  if (dtype == 1 && D == 128 && packed) return (int)hop::launch<128, true>(FLASH_ARGS);
  if (dtype == 1 && D == 64) return (int)hop::launch<64, false>(FLASH_ARGS);
  if (dtype == 1 && D == 128) return (int)hop::launch<128, false>(FLASH_ARGS);
#undef FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}
