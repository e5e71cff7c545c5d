// Mamba-1 selective scan for Hopper (sm_90a): the forward kernel and the
// backward kernel.
//
// Replace the Pallas TPU kernels `_fwd_kernel` (src/repro/kernels/
// selective_scan.py:50) and `_bwd_kernel` (:87) and compute what they
// compute, per stream b and channel c, with keep_t = (t > 0 & seg_t > 0 &
// seg_t == seg_{t-1}):
//   h_t = keep_t * exp(dt_t A) * h_{t-1} + dt_t u_t B_t,   y_t = <h_t, C_t> + D u_t
// and, walking time in reverse with the adjoint g_t = dy_t C_t +
// keep_{t+1} exp(dt_{t+1} A) g_{t+1} (g_{T-1} starts from dL/dh_final):
//   du_t = D dy_t + dt_t <g_t, B_t>
//   ddt_t = <g_t, keep_t h_{t-1} A e^{dt_t A}> + u_t <g_t, B_t>
//   dA = sum_t keep_t dt_t g_t h_{t-1} e^{dt_t A}      dD = sum_t dy_t u_t
//   dB_t = sum_c g_t dt_t u_t                          dC_t = sum_c dy_t h_t
// u, dt, y, dy, du, ddt are [B, T, di] (channels contiguous) in bf16 or
// fp32; B, C are [B, T, N] in the same type; A [di, N] and D [di] fp32;
// seg [B, T] int32.  Arithmetic is fp32.  N is 1..64, any di and T.
//
// Design: time-parallel affine scans.  With a_t = keep_t ? 2^{dt_t A'} : 0
// (A' = A log2(e), prescaled once per (c, n); ex2.approx on the
// special-function units) and b_t = dt_t u_t B_t, a step is the affine map
// h -> a_t h + b_t, and maps compose as (a2, b2) o (a1, b1) = (a2 a1,
// a2 b1 + b2); a segment start is a_t = 0 (the keep flag enters as an
// exponent bias of 0 or -inf), with no branch.
//   * A block owns 32 channels of one stream, one per lane, and walks time
//     in chunks of CHUNK steps.  Its W warps split a chunk into runs of K
//     consecutive steps (W K = CHUNK), one run a warp.  Loads of u/dt/dy are
//     32 consecutive channels; B_t/C_t, which every channel reads, are read
//     as broadcasts from fp32 [n][t] tiles, four steps a load.
//   * Per state n a thread (1) composes its run's K maps, keeping the K
//     values a_t in registers, as two halves of K/2 steps side by side (two
//     independent chains); (2) the W run totals are scanned across the
//     block through shared memory (one barrier, totals double-buffered by
//     n's parity), each warp folding the chunk's carry through the runs
//     before its own; (3) the thread walks its run again from its incoming
//     state (the second half from the first half's total), reusing the a_t
//     it kept.  y_t is summed over the states in the thread that owns step
//     t.  One exponential per (t, c, n).
//   * Loads: TMA boxes of [CHUNK x 32 channels] of u/dt/dy from 3-D
//     [B, T, di] maps, and of [CHUNK x N] of B/C from [B, T, N] maps (a box
//     past T or di reads zeros), into a ring of STAGES stages with an
//     mbarrier each; seg (and the backward's checkpoint) by cp.async.  The
//     forward refills a stage as soon as its chunk is read into registers
//     and fp32 tiles, the backward after the chunk (it reads u again for
//     ddt); either way the chunks after this one are in flight while it is
//     scanned.  Shapes TMA cannot describe (rows that are no multiple of 16
//     bytes: bf16 B/C at N 4, u/dt at a di that is no multiple of 8 in bf16)
//     load that operand with plain loads in the same kernel.
//   * Steps past T are exact identities (a = 1, b = 0: zero-filled inputs,
//     keep forced to 1), so every chunk runs whole; outputs past T or di are
//     not written.  No length or segment id is read on the host.
//   * Forward: the state entering every chunk is written as its checkpoint
//     (ckpt [B, ceil(T/CHUNK), di, N] fp32), the last carry as h_final; y
//     is stored in 16-byte rows from a shared tile where alignment allows.
//   * Backward, chunks last first: the chunk's forward scan is recomputed
//     from its checkpoint exactly as above (a_t and h_t kept in registers),
//     then the adjoint runs as a reverse affine scan, m -> a_t (dy_t C_t + m)
//     (the run totals share the forward's products of a_t), with the same
//     run / halves / cross-warp structure and a carry across chunks that
//     starts from dL/dh_final.  du/ddt terms are summed over states in the
//     thread that owns step t; dA over time in shared memory, dD in
//     registers.  One exponential per (t, c, n), against three in the
//     scalar kernel this replaces.
//   * dB/dC, sums over channels: over a warp's lanes through its scratch
//     rows in shared memory (each value's row split over 32/K lanes, then a
//     shuffle), into the block's partial of the chunk; then over the CHAIN
//     blocks of a group (256 channels), which add their partials into the
//     group's partial in device memory in rank order, each block waiting for
//     the one before (a flag with acquire / release; blocks are dispatched
//     in order, so the wait always ends).  The partials in device memory
//     are [ceil(di/256), B, T, N]; the wrapper sums them.  A thread block
//     cluster of 8 would sum them on chip, but only 30 clusters of the
//     backward fit the card at once (240 of its 264 block slots), which
//     took a third wave at the training shape.  Every sum runs in a fixed
//     order: no atomics, and two launches are bitwise equal.
//
// Bound on the H100.  At falcon-mamba-7b's training shape the forward is
// bound by T*di*N exponentials on the special-function units (16 a clock
// per SM), the backward by its fp32 operations.  What holds both short of
// it is latency: a block's warps meet at a barrier per state, and the
// registers a run of K steps needs (K values of a_t, h_t, dt, x, dy and the
// du/ddt sums) allow 8-16 warps an SM.  The design spends few issue slots
// per (t, c, n) (exp2 with A prescaled, the keep flag as an exponent bias,
// B/C four steps a load) and gives each warp two independent chains.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {
using namespace hopper;

constexpr int CH = 32;         // channels per block, one per lane
constexpr int CHUNK = 64;      // steps per checkpoint and per pass of a block
constexpr int FWD_RUN = 16;    // steps a thread scans in the forward (K)
constexpr int BWD_RUN = 16;    // steps a thread scans in the backward
constexpr int FWD_WARPS = CHUNK / FWD_RUN;
constexpr int BWD_WARPS = CHUNK / BWD_RUN;
constexpr int FWD_BLOCKS = 4;  // forward blocks an SM holds (bounds the registers)
constexpr int BWD_BLOCKS = 2;  // backward blocks an SM holds
constexpr int STAGES = 2;      // ring depth; 1 where shared memory holds no more
constexpr int CHAIN = 8;       // blocks whose dB/dC partials one group partial sums
constexpr int MAX_N = 64;
constexpr int LDC = CHUNK;      // row stride of the fp32 [n][t] B/C tiles
constexpr int LDN = CH + 1;     // row stride of [n][channel] arrays
constexpr int LDR = CH + 4;     // row stride of a warp's lane-sum scratch [value][lane]
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAP_CH = 1, MAP_ST = 2, VEC = 4;  // launch flags
static_assert(FWD_WARPS * FWD_RUN == CHUNK && BWD_WARPS * BWD_RUN == CHUNK, "runs tile a chunk");
static_assert(FWD_RUN % 8 == 0 && BWD_RUN % 8 == 0,
              "a run is two halves of whole four-step loads");
static_assert(2 * BWD_RUN <= 32 && (BWD_RUN & (BWD_RUN - 1)) == 0,
              "a run's dB/dC values are summed over lanes in one pass");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// Shared memory of a block, in bytes from a 128-aligned base; every TMA
// destination is 128-aligned.  A stage holds the chunk's u, dt (and dy)
// [CHUNK][CH] and B, C [CHUNK][N] in the input type and seg[t0 - 1 .. t0 +
// CHUNK).
struct Layout {
  int u, dt, dy, bm, cm, seg, ck, stage;
  int ring, zero, conv_b, conv_c, kb, out, tf, carry, gcarry, a, da, datmp, dd, red, pbuf,
      bars, bytes;
};

__host__ __device__ inline int up128(int x) { return (x + 127) & ~127; }

__host__ __device__ inline Layout layout(bool bwd, int elt, int N, int stages) {
  Layout L{};
  const int W = bwd ? BWD_WARPS : FWD_WARPS;
  const int tile = up128(CHUNK * CH * elt), states = up128(CHUNK * N * elt);
  const int nrow = up128(N * LDN * 4);
  int o = 0;
  L.u = o, o += tile;
  L.dt = o, o += tile;
  L.dy = o, o += bwd ? tile : 0;
  L.bm = o, o += states;
  L.cm = o, o += states;
  L.seg = o, o += up128((CHUNK + 1) * 4);
  L.stage = o;
  o = 0;
  L.ring = o, o += stages * L.stage;
  L.zero = o;  // from here on zeroed at the start of a block
  L.conv_b = o, o += up128(N * LDC * 4);
  L.conv_c = o, o += up128(N * LDC * 4);
  L.kb = o, o += up128(CHUNK * 4);
  L.out = o, o += bwd ? 0 : tile;                       // fwd: the y tile
  L.tf = o, o += up128(2 * W * CH * (bwd ? 16 : 8));  // run totals, by n's parity
  L.carry = o, o += 2 * nrow;  // fwd: h carry by chunk parity; bwd: checkpoints, by parity
  L.gcarry = o, o += bwd ? nrow : 0;       // bwd: adjoint message entering from later chunks
  L.a = o, o += nrow;                      // fwd: A'; bwd: A
  L.da = o, o += bwd ? nrow : 0;
  L.datmp = o, o += bwd ? up128(2 * W * CH * 4) : 0;  // dA terms of a state, by n's parity
  L.dd = o, o += bwd ? up128(W * CH * 4) : 0;
  L.red = o, o += bwd ? up128(W * BWD_RUN * LDR * 4) : 0;  // per warp [value][lane]
  L.pbuf = o, o += bwd ? up128(2 * CHUNK * N * 4) : 0;    // [dB|dC][t][n]
  L.bars = o, o += up128(stages * 8);
  L.bytes = o + 128;  // room to align the base
  return L;
}

// The most ring stages (<= STAGES) whose layout fits a block; 0 if none.
inline int pick_stages(bool bwd, int elt, int N) {
  for (int s = STAGES; s >= 1; --s)
    if (layout(bwd, elt, N, s).bytes <= SMEM_LIMIT) return s;
  return 0;
}

// Wait for the cp.async group of the next chunk: with `stages` stages,
// up to stages - 1 later groups may stay in flight.
__device__ __forceinline__ void wait_next(int stages) {
  if (stages > 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// The operands of one launch and the copies that fill a stage.
template <typename T, bool BWD>
struct Loader {
  const CUtensorMap *mu, *mdt, *mdy, *mb, *mc;
  const T *u, *dt, *dy, *bm, *cm;
  const int* seg;
  const float* ckpt;
  Layout L;
  int b, c0, Tn, di, N, n_ck, flags;

  // Fill stage `st` (barrier `bar`) with chunk k: TMA for the mapped
  // operands (thread 0), plain loads for the others, cp.async for seg (the
  // caller commits the group).
  __device__ void fill(uint8_t* st, uint64_t* bar, int k, int tid, int nt) const {
    constexpr int elt = sizeof(T);
    const int t0 = k * CHUNK;
    if (tid == 0) {
      fence_proxy_async();
      uint32_t bytes = 0;
      if (flags & MAP_CH) bytes += (BWD ? 3 : 2) * CHUNK * CH * elt;
      if (flags & MAP_ST) bytes += 2 * CHUNK * N * elt;
      if (bytes == 0) {
        mbar_arrive(bar);
      } else {
        mbar_expect_tx(bar, bytes);
        if (flags & MAP_CH) {
          tma_3d(st + L.u, mu, bar, c0, t0, b);
          tma_3d(st + L.dt, mdt, bar, c0, t0, b);
          if constexpr (BWD) tma_3d(st + L.dy, mdy, bar, c0, t0, b);
        }
        if (flags & MAP_ST) {
          tma_3d(st + L.bm, mb, bar, 0, t0, b);
          tma_3d(st + L.cm, mc, bar, 0, t0, b);
        }
      }
    }
    if (!(flags & MAP_CH)) {
      plain_channels(reinterpret_cast<T*>(st + L.u), u, t0, tid, nt);
      plain_channels(reinterpret_cast<T*>(st + L.dt), dt, t0, tid, nt);
      if constexpr (BWD) plain_channels(reinterpret_cast<T*>(st + L.dy), dy, t0, tid, nt);
    }
    if (!(flags & MAP_ST)) {
      plain_states(reinterpret_cast<T*>(st + L.bm), bm, t0, tid, nt);
      plain_states(reinterpret_cast<T*>(st + L.cm), cm, t0, tid, nt);
    }
    int* sg = reinterpret_cast<int*>(st + L.seg);
    const int* row = seg + (size_t)b * Tn;
    for (int i = tid; i <= CHUNK; i += nt) {
      const int t = t0 - 1 + i;
      const bool ok = t >= 0 && t < Tn;
      cp_async4(sg + i, ok ? row + t : row, ok);
    }
  }

  // The checkpoint of chunk k into dst [n][LDN] by cp.async (the caller
  // commits the group).
  __device__ void load_ckpt(float* dst, int k, int tid, int nt) const {
    const float* src = ckpt + (((size_t)b * n_ck + k) * di + c0) * N;
    for (int e = tid; e < CH * N; e += nt) {
      const int ch = e / N, n = e - ch * N;
      const bool ok = c0 + ch < di;
      cp_async4(dst + n * LDN + ch, ok ? src + e : ckpt, ok);
    }
  }

  // [CHUNK][CH] of a [B, T, di] tensor; zeros past T and di.
  __device__ void plain_channels(T* dst, const T* src, int t0, int tid, int nt) const {
    for (int e = tid; e < CHUNK * CH; e += nt) {
      const int t = t0 + e / CH, c = c0 + e % CH;
      dst[e] = (t < Tn && c < di) ? src[((size_t)b * Tn + t) * di + c] : from_f32<T>(0.f);
    }
  }
  // [CHUNK][N] of a [B, T, N] tensor; zeros past T.
  __device__ void plain_states(T* dst, const T* src, int t0, int tid, int nt) const {
    for (int e = tid; e < CHUNK * N; e += nt) {
      const bool ok = t0 + e / N < Tn;
      dst[e] = ok ? src[((size_t)b * Tn + t0) * N + e] : from_f32<T>(0.f);
    }
  }
};

// B/C of a stage as fp32 [n][t] tiles, and the keep flags of the chunk as
// exponent biases: 0 (keep) or -inf (a segment starts: a_t = 2^-inf = 0).
template <typename T>
__device__ __forceinline__ void convert(const uint8_t* st, const Layout& L, float* conv_b,
                                        float* conv_c, float* kb, int t0, int Tn, int N,
                                        int tid, int nt) {
  const T* rb = reinterpret_cast<const T*>(st + L.bm);
  const T* rc = reinterpret_cast<const T*>(st + L.cm);
  for (int n = tid / 32; n < N; n += nt / 32) {
    for (int t = tid % 32; t < CHUNK; t += 32) {
      conv_b[n * LDC + t] = to_f32(rb[t * N + n]);
      conv_c[n * LDC + t] = to_f32(rc[t * N + n]);
    }
  }
  const int* sg = reinterpret_cast<const int*>(st + L.seg);  // sg[i] = seg[t0 - 1 + i]
  for (int t = tid; t < CHUNK; t += nt) {
    const int tg = t0 + t;
    const bool keep = tg >= Tn || (tg > 0 && sg[t + 1] > 0 && sg[t + 1] == sg[t]);
    kb[t] = keep ? 0.f : -__int_as_float(0x7f800000);
  }
}

template <int K>
__device__ __forceinline__ void load_run(float (&v)[K], const float* p) {
#pragma unroll
  for (int i = 0; i < K / 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = q.x, v[4 * i + 1] = q.y, v[4 * i + 2] = q.z, v[4 * i + 3] = q.w;
  }
}

// A run of K steps is scanned as two halves of K/2 steps side by side, two
// independent chains for the issue slots between their dependent steps.
// compose: each half's K/2 maps from a zero state, a_t kept in a[] and
// b_t = x_t B_t in bv[]; pa[h], pb[h] are half h's total (the product of
// its a_t, its folded b).
template <int K>
__device__ __forceinline__ void compose(float (&a)[K], float (&bv)[K], const float (&dt)[K],
                                        const float (&x)[K], float a2, const float* brow,
                                        const float* kbrow, float (&pa)[2], float (&pb)[2]) {
  constexpr int KH = K / 2;
  float bn[K], kb[K];
  load_run(bn, brow);
  load_run(kb, kbrow);
  pa[0] = pa[1] = 1.f;
  pb[0] = pb[1] = 0.f;
#pragma unroll
  for (int j = 0; j < KH; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int jj = h * KH + j;
      a[jj] = ex2(fmaf(dt[jj], a2, kb[jj]));
      bv[jj] = x[jj] * bn[jj];
      pa[h] *= a[jj];
      pb[h] = fmaf(a[jj], pb[h], bv[jj]);
    }
  }
}

// The sums of V values (a power of two, 8 <= V <= 32) over the warp's 32
// lanes, from the warp's scratch rows red[V][LDR] (value i of lane l at
// red[i LDR + l], stored before a __syncwarp): lane l gets the sum of value
// l / (32 / V), in a fixed order (32 / V lanes split each value's row; four
// running sums each, then across those lanes).
template <int V>
__device__ __forceinline__ float lane_sum(const float* red, int lane) {
  constexpr int PARTS = 32 / V;
  const float4* row = reinterpret_cast<const float4*>(red + (lane / PARTS) * LDR +
                                                      (lane % PARTS) * V);
  float4 acc = row[0];
#pragma unroll
  for (int q = 1; q < V / 4; ++q) {
    const float4 f = row[q];
    acc.x += f.x, acc.y += f.y, acc.z += f.z, acc.w += f.w;
  }
  float r = (acc.x + acc.y) + (acc.z + acc.w);
#pragma unroll
  for (int o = PARTS / 2; o >= 1; o /= 2) r += __shfl_xor_sync(FULL, r, o);
  return r;
}

// A [CHUNK][CH] tile of shared memory to rows t0.. of the stream `dst`
// ([T, di]): 16-byte stores where `vec` and the 8 (bf16) or 4 (fp32)
// channels are all inside di; element stores at the ragged edge.
template <typename T>
__device__ __forceinline__ void store_tile(const T* tile, T* dst, int t0, int Tn, int c0, int di,
                                           bool vec, int tid, int nt) {
  constexpr int V = 16 / sizeof(T), PER_ROW = CH / V;
  for (int e = tid; e < CHUNK * PER_ROW; e += nt) {
    const int t = e / PER_ROW, ch = (e % PER_ROW) * V, tg = t0 + t;
    if (tg >= Tn || c0 + ch >= di) continue;
    const T* src = tile + t * CH + ch;
    T* out = dst + (size_t)tg * di + c0 + ch;
    if (vec && c0 + ch + V <= di) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int i = 0; i < V && c0 + ch + i < di; ++i) out[i] = src[i];
    }
  }
}

__device__ __forceinline__ uint8_t* aligned128(uint8_t* raw) {
  return raw + ((128 - (smem_u32(raw) & 127)) & 127);
}

// Zero [from, to) of shared memory (128-aligned offsets), 16 bytes a store.
__device__ __forceinline__ void zero_smem(uint8_t* base, int from, int to, int tid, int nt) {
  for (int o = from + 16 * tid; o < to; o += 16 * nt)
    *reinterpret_cast<float4*>(base + o) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// ----------------------------------------------------------------------
// Forward.  grid (ceil(di/32), B), block 32 FWD_WARPS.
// ----------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(FWD_WARPS * 32, FWD_BLOCKS)
ssm_fwd_kernel(const __grid_constant__ CUtensorMap map_u,
               const __grid_constant__ CUtensorMap map_dt,
               const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_c,
               const T* __restrict__ u, const T* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
               const int* __restrict__ seg, T* __restrict__ y, float* __restrict__ ckpt,
               float* __restrict__ hfin, int Tn, int di, int N, int stages, int flags) {
  constexpr int W = FWD_WARPS, K = FWD_RUN, KH = K / 2, NT = W * 32;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* base = aligned128(smem_raw);
  const Layout L = layout(false, sizeof(T), N, stages);
  float* conv_b = reinterpret_cast<float*>(base + L.conv_b);
  float* conv_c = reinterpret_cast<float*>(base + L.conv_c);
  float* kb = reinterpret_cast<float*>(base + L.kb);
  float2* tf = reinterpret_cast<float2*>(base + L.tf);
  float* carry = reinterpret_cast<float*>(base + L.carry);
  float* sa = reinterpret_cast<float*>(base + L.a);
  T* yt = reinterpret_cast<T*>(base + L.out);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int b = blockIdx.y, c0 = blockIdx.x * CH, c = c0 + lane;
  const bool c_ok = c < di;
  const int n_ck = (Tn + CHUNK - 1) / CHUNK;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  zero_smem(base, L.zero, L.bars, tid, NT);  // the carry into chunk 0, ragged channels
  __syncthreads();
  for (int e = tid; e < CH * N; e += NT) {  // A' = A log2(e), [n][channel]
    const int ch = e / N, n = e - ch * N;
    if (c0 + ch < di) sa[n * LDN + ch] = A[(size_t)c0 * N + e] * LOG2E;
  }
  const float Dc = c_ok ? D[c] : 0.f;
  __syncthreads();

  const Loader<T, false> ld{&map_u, &map_dt, nullptr, &map_b, &map_c, u, dt, nullptr, Bm, Cm,
                            seg, nullptr, L, b, c0, Tn, di, N, n_ck, flags};
  for (int i = 0; i < stages; ++i) {
    if (i < n_ck) ld.fill(base + L.ring + i * L.stage, &full[i], i, tid, NT);
    cp_async_commit();
  }
  wait_next(stages);
  __syncthreads();

  for (int k = 0; k < n_ck; ++k) {
    const int s = k % stages, par = k & 1, t0 = k * CHUNK;
    uint8_t* st = base + L.ring + s * L.stage;
    mbar_wait(&full[s], (k / stages) & 1);
    const T* su = reinterpret_cast<const T*>(st + L.u);
    const T* sdt = reinterpret_cast<const T*>(st + L.dt);
    float dtv[K], x[K], yv[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int tl = w * K + j;
      const float uu = c_ok ? to_f32(su[tl * CH + lane]) : 0.f;
      dtv[j] = c_ok ? to_f32(sdt[tl * CH + lane]) : 0.f;
      x[j] = dtv[j] * uu;
      yv[j] = Dc * uu;
    }
    convert<T>(st, L, conv_b, conv_c, kb, t0, Tn, N, tid, NT);
    const float* hc = carry + par * N * LDN;  // the state entering chunk k
    float* hn = carry + (par ^ 1) * N * LDN;  // the state leaving it
    float* ck = ckpt + (((size_t)b * n_ck + k) * di + c0) * N;
    for (int e = tid; e < CH * N; e += NT) {
      const int ch = e / N, n = e - ch * N;
      if (c0 + ch < di) ck[e] = hc[n * LDN + ch];
    }
    __syncthreads();  // the stage is read: refill it
    if (k + stages < n_ck) ld.fill(st, &full[s], k + stages, tid, NT);
    cp_async_commit();

    for (int n = 0; n < N; ++n) {
      float a[K], bv[K], pa[2], pb[2];
      compose<K>(a, bv, dtv, x, sa[n * LDN + lane], conv_b + n * LDC + w * K, kb + w * K, pa,
                 pb);
      float2* tb = tf + (n & 1) * W * CH;
      tb[w * CH + lane] = make_float2(pa[0] * pa[1], fmaf(pa[1], pb[0], pb[1]));
      __syncthreads();
      float h = hc[n * LDN + lane];
#pragma unroll
      for (int v = 0; v < W - 1; ++v) {  // the carry through the runs before this one
        const float2 p = tb[v * CH + lane];
        if (v < w) h = fmaf(p.x, h, p.y);
      }
      float cn[K], hh[2] = {h, fmaf(pa[0], h, pb[0])};
      load_run(cn, conv_c + n * LDC + w * K);
#pragma unroll
      for (int j = 0; j < KH; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int jj = q * KH + j;
          hh[q] = fmaf(a[jj], hh[q], bv[jj]);
          yv[jj] = fmaf(hh[q], cn[jj], yv[jj]);
        }
      }
      if (w == W - 1) hn[n * LDN + lane] = hh[1];
    }

#pragma unroll
    for (int j = 0; j < K; ++j) yt[(w * K + j) * CH + lane] = from_f32<T>(yv[j]);
    wait_next(stages);
    __syncthreads();
    store_tile(yt, y + (size_t)b * Tn * di, t0, Tn, c0, di, flags & VEC, tid, NT);
  }

  const float* hc = carry + (n_ck & 1) * N * LDN;
  for (int e = tid; e < CH * N; e += NT) {
    const int ch = e / N, n = e - ch * N;
    if (c0 + ch < di) hfin[((size_t)b * di + c0) * N + e] = hc[n * LDN + ch];
  }
}

// ----------------------------------------------------------------------
// Backward.  grid (ceil(di/32), B), block 32 BWD_WARPS; blocks
// CHAIN g .. CHAIN g + CHAIN - 1 of a stream add their dB/dC into group g's
// partial in turn.
// ----------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(BWD_WARPS * 32, BWD_BLOCKS)
ssm_bwd_kernel(const __grid_constant__ CUtensorMap map_u,
               const __grid_constant__ CUtensorMap map_dt,
               const __grid_constant__ CUtensorMap map_dy,
               const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_c, const T* __restrict__ u,
               const T* __restrict__ dt, const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D, const int* __restrict__ seg,
               const float* __restrict__ ckpt, const T* __restrict__ dy,
               const float* __restrict__ dhf, T* __restrict__ du, T* __restrict__ ddt,
               float* __restrict__ dA_part, float* __restrict__ dB_part,
               float* __restrict__ dC_part, float* __restrict__ dD_part, int* __restrict__ chain,
               int Bsz, int Tn, int di, int N, int stages, int flags) {
  constexpr int W = BWD_WARPS, K = BWD_RUN, KH = K / 2, NT = W * 32, PARTS = 32 / K;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* base = aligned128(smem_raw);
  const Layout L = layout(true, sizeof(T), N, stages);
  float* conv_b = reinterpret_cast<float*>(base + L.conv_b);
  float* conv_c = reinterpret_cast<float*>(base + L.conv_c);
  float* kb = reinterpret_cast<float*>(base + L.kb);
  float4* tt = reinterpret_cast<float4*>(base + L.tf);
  float* gcarry = reinterpret_cast<float*>(base + L.gcarry);
  float* sa = reinterpret_cast<float*>(base + L.a);
  float* sda = reinterpret_cast<float*>(base + L.da);
  float* datmp = reinterpret_cast<float*>(base + L.datmp);
  float* ddtmp = reinterpret_cast<float*>(base + L.dd);
  float* pbuf = reinterpret_cast<float*>(base + L.pbuf);  // the chunk's partials
  float* ck_s = reinterpret_cast<float*>(base + L.carry);  // checkpoints, by parity
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int b = blockIdx.y, c0 = blockIdx.x * CH, c = c0 + lane;
  const bool c_ok = c < di;
  const int n_ck = (Tn + CHUNK - 1) / CHUNK;
  float* red_w = reinterpret_cast<float*>(base + L.red) + w * K * LDR;  // this warp's rows
  const int grp = blockIdx.x / CHAIN, rank = blockIdx.x % CHAIN;
  int* added = chain + ((size_t)grp * Bsz + b) * n_ck;  // added[k]: blocks that added chunk k
  T* du_b = du + (size_t)b * Tn * di;
  T* ddt_b = ddt + (size_t)b * Tn * di;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  zero_smem(base, L.zero, L.bars, tid, NT);  // dA sums, ragged channels
  __syncthreads();
  for (int e = tid; e < CH * N; e += NT) {  // A and dL/dh_final, [n][channel]
    const int ch = e / N, n = e - ch * N;
    if (c0 + ch < di) {
      sa[n * LDN + ch] = A[(size_t)c0 * N + e];
      gcarry[n * LDN + ch] = dhf[((size_t)b * di + c0) * N + e];
    }
  }
  const float Dc = c_ok ? D[c] : 0.f;
  __syncthreads();
  // After the barrier that follows state n: add its dA terms over the
  // warps (warp n % W, in warp order) and store the message leaving the
  // chunk (warp 0).
  auto flush = [&](int n, float m_leaving) {
    if (w == n % W) {
      float sum = 0.f;
#pragma unroll
      for (int v = 0; v < W; ++v) sum += datmp[((n & 1) * W + v) * CH + lane];
      sda[n * LDN + lane] += sum;
    }
    if (w == 0) gcarry[n * LDN + lane] = m_leaving;
  };
  // dB/dC of chunk k over this block's channels (`pb`, [dB|dC][t][n]),
  // added into the group's partial in device memory after the blocks
  // before it in the group, in rank order (thread 0 has waited for them;
  // chain_pass, after a barrier that follows, passes the chunk on).
  auto chain_add = [&](int k, const float* pb) {
    constexpr int U = 4;  // entries a thread has in flight
    const int t0 = k * CHUNK, rows = min(CHUNK, Tn - t0) * N;
    float* gb_ = dB_part + (((size_t)grp * Bsz + b) * Tn + t0) * N;
    float* gc_ = dC_part + (((size_t)grp * Bsz + b) * Tn + t0) * N;
    for (int e0 = tid; e0 < rows; e0 += U * NT) {
      float vb[U], vc[U];
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int e = e0 + q * NT;
        vb[q] = e < rows ? pb[e] : 0.f;
        vc[q] = e < rows ? pb[CHUNK * N + e] : 0.f;
        if (rank && e < rows) vb[q] += gb_[e], vc[q] += gc_[e];
      }
#pragma unroll
      for (int q = 0; q < U; ++q) {
        const int e = e0 + q * NT;
        if (e < rows) gb_[e] = vb[q], gc_[e] = vc[q];
      }
    }
  };
  auto chain_pass = [&](int k) {
    if (tid == 0) {
      __threadfence();
      st_release(added + k, rank + 1);
    }
  };

  const Loader<T, true> ld{&map_u, &map_dt, &map_dy, &map_b, &map_c, u, dt, dy, Bm, Cm, seg,
                           ckpt, L, b, c0, Tn, di, N, n_ck, flags};
  ld.load_ckpt(ck_s, n_ck - 1, tid, NT);
  cp_async_commit();
  for (int i = 0; i < stages; ++i) {
    if (i < n_ck) ld.fill(base + L.ring + i * L.stage, &full[i], n_ck - 1 - i, tid, NT);
    cp_async_commit();
  }
  wait_next(stages);
  __syncthreads();

  float dD_acc = 0.f;
  for (int i = 0; i < n_ck; ++i) {
    const int k = n_ck - 1 - i, s = i % stages, t0 = k * CHUNK;
    uint8_t* st = base + L.ring + s * L.stage;
    mbar_wait(&full[s], (i / stages) & 1);
    const T* su = reinterpret_cast<const T*>(st + L.u);
    const T* sdt = reinterpret_cast<const T*>(st + L.dt);
    const T* sdy = reinterpret_cast<const T*>(st + L.dy);
    float dtv[K], x[K], dyv[K], gb[K], dd[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int tl = w * K + j;
      const float uu = c_ok ? to_f32(su[tl * CH + lane]) : 0.f;
      dtv[j] = c_ok ? to_f32(sdt[tl * CH + lane]) : 0.f;
      dyv[j] = c_ok ? to_f32(sdy[tl * CH + lane]) : 0.f;
      x[j] = dtv[j] * uu;
      dD_acc = fmaf(dyv[j], uu, dD_acc);
      gb[j] = 0.f;
      dd[j] = 0.f;
    }
    convert<T>(st, L, conv_b, conv_c, kb, t0, Tn, N, tid, NT);
    if (i > 0 && tid == 0) wait_flag(added + k + 1, rank);  // the group's blocks before
    __syncthreads();  // the stage is read (u stays, for ddt): refill it after the states
    if (i + 1 < n_ck) ld.load_ckpt(ck_s + ((i + 1) & 1) * N * LDN, k - 1, tid, NT);
    cp_async_commit();
    if (i > 0) chain_add(k + 1, pbuf);  // the previous chunk's partials
    const float* hin_s = ck_s + (i & 1) * N * LDN;  // the state entering the chunk

    // State n's dB (q = 0) or dC (q = 1) terms of the run, summed over the
    // warp's lanes from its scratch rows into the block's partials.
    auto put_sums = [&](int n, int q) {
      const float r = lane_sum<K>(red_w, lane);
      if (lane % PARTS == 0) pbuf[(q * CHUNK + w * K + lane / PARTS) * N + n] = r;
    };
    float m_out = 0.f;  // warp 0: the message leaving the chunk, stored after the next barrier
    for (int n = 0; n < N; ++n) {
      // The run's forward map and its reverse map m -> a_first (dy C + ...
      // a_last (dy C + m)), which shares the product of a_t; by halves.
      const float an = sa[n * LDN + lane];
      const float* brow = conv_b + n * LDC + w * K;
      const float* crow = conv_c + n * LDC + w * K;
      float a[K], bv[K], pa[2], pb_[2], cn[K], mr[2] = {0.f, 0.f};
      compose<K>(a, bv, dtv, x, an * LOG2E, brow, kb + w * K, pa, pb_);
      load_run(cn, crow);
#pragma unroll
      for (int j = KH - 1; j >= 0; --j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int jj = q * KH + j;
          mr[q] = a[jj] * fmaf(dyv[jj], cn[jj], mr[q]);
        }
      }
      float4* tb = tt + (n & 1) * W * CH;
      tb[w * CH + lane] = make_float4(pa[0] * pa[1], fmaf(pa[1], pb_[0], pb_[1]),
                                      fmaf(pa[0], mr[1], mr[0]), 0.f);
      if (n > 0) put_sums(n - 1, 0);
      __syncthreads();
      if (n > 0) flush(n - 1, m_out);
      if (n == 0 && i > 0) chain_pass(k + 1);
      // The state entering the run (the checkpoint through the runs before
      // it) and the message entering its last step (from the later chunks
      // through the runs after it).
      float hin = hin_s[n * LDN + lane], m = gcarry[n * LDN + lane];
#pragma unroll
      for (int v = 0; v < W - 1; ++v) {
        const float4 p = tb[v * CH + lane];
        if (v < w) hin = fmaf(p.x, hin, p.y);
      }
#pragma unroll
      for (int v = W - 1; v > 0; --v) {
        const float4 p = tb[v * CH + lane];
        if (v > w) m = fmaf(p.x, m, p.z);
      }
      float bn[K], h[K];
      load_run(bn, brow);
      {
        float hh[2] = {hin, fmaf(pa[0], hin, pb_[0])};
#pragma unroll
        for (int j = 0; j < KH; ++j) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int jj = q * KH + j;
            h[jj] = hh[q] = fmaf(a[jj], hh[q], bv[jj]);
            red_w[jj * LDR + lane] = dyv[jj] * h[jj];
          }
        }
      }
      __syncwarp();
      put_sums(n, 1);  // dC
      __syncwarp();
      // The reverse walk; each step's dB and dC terms go to the warp's
      // scratch rows for the sums over its lanes.
      float ms[2] = {fmaf(pa[1], m, mr[1]), m}, da[2] = {0.f, 0.f};
#pragma unroll
      for (int j = KH - 1; j >= 0; --j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int jj = q * KH + j;
          const float g = fmaf(dyv[jj], cn[jj], ms[q]);
          gb[jj] = fmaf(g, bn[jj], gb[jj]);
          ms[q] = a[jj] * g;  // the message to step jj - 1
          const float ghe = ms[q] * (jj > 0 ? h[jj > 0 ? jj - 1 : 0] : hin);  // g a_t h_{t-1}
          dd[jj] = fmaf(ghe, an, dd[jj]);
          da[q] = fmaf(ghe, dtv[jj], da[q]);
          red_w[jj * LDR + lane] = g * x[jj];
        }
      }
      m_out = ms[0];
      datmp[((n & 1) * W + w) * CH + lane] = da[0] + da[1];
      __syncwarp();
    }
    put_sums(N - 1, 0);

    // du, ddt of the chunk, stored straight from registers (u from the
    // stage, which is refilled after).
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int tl = w * K + j, tg = t0 + tl;
      if (c_ok && tg < Tn) {
        const size_t o = (size_t)tg * di + c;
        du_b[o] = from_f32<T>(fmaf(Dc, dyv[j], dtv[j] * gb[j]));
        ddt_b[o] = from_f32<T>(fmaf(to_f32(su[tl * CH + lane]), gb[j], dd[j]));
      }
    }
    __syncthreads();  // the chunk's partials, its last dA terms, the stage read
    flush(N - 1, m_out);
    if (i + stages < n_ck) ld.fill(st, &full[s], k - stages, tid, NT);
    cp_async_commit();
    wait_next(stages);
    __syncthreads();  // the next chunk's seg and checkpoint are in
  }
  if (tid == 0) wait_flag(added, rank);  // the last chunk, 0
  __syncthreads();
  chain_add(0, pbuf);
  __syncthreads();
  chain_pass(0);

  for (int e = tid; e < CH * N; e += NT) {
    const int ch = e / N, n = e - ch * N;
    if (c0 + ch < di) dA_part[((size_t)b * di + c0) * N + e] = sda[n * LDN + ch];
  }
  ddtmp[w * CH + lane] = dD_acc;
  __syncthreads();
  if (w == 0 && c_ok) {
    float sum = 0.f;
    for (int v = 0; v < W; ++v) sum += ddtmp[v * CH + lane];
    dD_part[(size_t)b * di + c] = sum;
  }
}

// ----------------------------------------------------------------------
// Host side.
// ----------------------------------------------------------------------
template <typename T> constexpr CUtensorMapDataType map_type();
template <> constexpr CUtensorMapDataType map_type<float>() {
  return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}
template <> constexpr CUtensorMapDataType map_type<__nv_bfloat16>() {
  return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// TMA takes a tensor whose base is 16-byte aligned and whose rows are a
// multiple of 16 bytes.
inline bool mappable(const void* p, long row_bytes) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && row_bytes % 16 == 0;
}

// [B, T, width] as a 3-D map with boxes of `box_w` x CHUNK rows of one stream.
template <typename T>
bool stream_map(CUtensorMap* m, const void* p, int Bsz, int Tn, int width, int box_w) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)Tn, (cuuint64_t)Bsz};
  const cuuint64_t strides[2] = {(cuuint64_t)width * sizeof(T),
                                 (cuuint64_t)Tn * width * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)box_w, CHUNK, 1};
  return make_map(m, p, 3, dims, strides, box, map_type<T>(), CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Maps of the channel operands (u, dt[, dy]) and of B/C where TMA can
// describe them; the launch flags say which.
template <typename T>
bool make_maps(CUtensorMap (&m)[5], const void* const (&chans)[3], int n_chans, const void* Bm,
               const void* Cm, const void* out, int Bsz, int Tn, int di, int N, int& flags) {
  flags = 0;
  bool ch_ok = true;
  for (int i = 0; i < n_chans; ++i) ch_ok = ch_ok && mappable(chans[i], (long)di * sizeof(T));
  if (ch_ok) {
    for (int i = 0; i < n_chans; ++i)
      if (!stream_map<T>(&m[i], chans[i], Bsz, Tn, di, CH)) return false;
    flags |= MAP_CH;
  }
  if (mappable(Bm, (long)N * sizeof(T)) && mappable(Cm, (long)N * sizeof(T))) {
    if (!stream_map<T>(&m[3], Bm, Bsz, Tn, N, N) || !stream_map<T>(&m[4], Cm, Bsz, Tn, N, N))
      return false;
    flags |= MAP_ST;
  }
  if (mappable(out, (long)di * sizeof(T))) flags |= VEC;
  return true;
}

// Dynamic shared memory above 48 KB, allowed once per kernel and device.
template <typename T>
cudaError_t allow_fwd_smem() {
  static unsigned sized = 0;
  return allow_smem(ssm_fwd_kernel<T>, SMEM_LIMIT, sized);
}

template <typename T>
cudaError_t allow_bwd_smem() {
  static unsigned sized = 0;
  return allow_smem(ssm_bwd_kernel<T>, SMEM_LIMIT, sized);
}

template <typename T>
cudaError_t launch_fwd(const void* u, const void* dt, const float* A, const void* Bm,
                       const void* Cm, const float* D, const int* seg, void* y, float* ckpt,
                       float* hfin, int Bsz, int Tn, int di, int N, cudaStream_t st) {
  const int stages = pick_stages(false, sizeof(T), N);
  if (stages == 0) return cudaErrorInvalidValue;
  CUtensorMap m[5] = {};
  int flags = 0;
  const void* const chans[3] = {u, dt, nullptr};
  if (!make_maps<T>(m, chans, 2, Bm, Cm, y, Bsz, Tn, di, N, flags)) return cudaErrorInvalidValue;
  const cudaError_t rc = allow_fwd_smem<T>();
  if (rc != cudaSuccess) return rc;
  const dim3 grid((di + CH - 1) / CH, Bsz);
  ssm_fwd_kernel<T><<<grid, FWD_WARPS * 32, layout(false, sizeof(T), N, stages).bytes, st>>>(
      m[0], m[1], m[3], m[4], static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), D, seg, static_cast<T*>(y), ckpt,
      hfin, Tn, di, N, stages, flags);
  return cudaGetLastError();
}

// Blocks of a launch at state size N an SM holds at once (0 on error).
template <typename T>
int blocks_per_sm(bool bwd, int N) {
  const int stages = pick_stages(bwd, sizeof(T), N);
  if (stages == 0 || (bwd ? allow_bwd_smem<T>() : allow_fwd_smem<T>()) != cudaSuccess) return 0;
  const int bytes = layout(bwd, sizeof(T), N, stages).bytes;
  int n = 0;
  const cudaError_t rc =
      bwd ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssm_bwd_kernel<T>,
                                                          BWD_WARPS * 32, bytes)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssm_fwd_kernel<T>,
                                                          FWD_WARPS * 32, bytes);
  return rc == cudaSuccess ? n : 0;
}

template <typename T>
cudaError_t launch_bwd(const void* u, const void* dt, const float* A, const void* Bm,
                       const void* Cm, const float* D, const int* seg, const float* ckpt,
                       const void* dy, const float* dhf, void* du, void* ddt, float* dA_part,
                       float* dB_part, float* dC_part, float* dD_part, int* chain, int Bsz,
                       int Tn, int di, int N, cudaStream_t st) {
  const int stages = pick_stages(true, sizeof(T), N);
  if (stages == 0) return cudaErrorInvalidValue;
  CUtensorMap m[5] = {};
  int flags = 0;
  const void* const chans[3] = {u, dt, dy};
  if (!make_maps<T>(m, chans, 3, Bm, Cm, du, Bsz, Tn, di, N, flags)) return cudaErrorInvalidValue;
  if (!mappable(ddt, (long)di * sizeof(T))) flags &= ~VEC;
  const cudaError_t rc = allow_bwd_smem<T>();
  if (rc != cudaSuccess) return rc;
  const dim3 grid((di + CH - 1) / CH, Bsz);
  ssm_bwd_kernel<T><<<grid, BWD_WARPS * 32, layout(true, sizeof(T), N, stages).bytes, st>>>(
      m[0], m[1], m[2], m[3], m[4], static_cast<const T*>(u), static_cast<const T*>(dt), A,
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), D, seg, ckpt,
      static_cast<const T*>(dy), dhf, static_cast<T*>(du), static_cast<T*>(ddt), dA_part,
      dB_part, dC_part, dD_part, chain, Bsz, Tn, di, N, stages, flags);
  return cudaGetLastError();
}

}  // namespace

// Steps per checkpoint (ckpt is [B, ceil(T / chunk), di, N]), channels
// summed into one dB/dC partial (the partials are [ceil(di / channels), B,
// T, N]) and the largest state size the kernels take.
extern "C" int ssm_chunk() { return CHUNK; }
extern "C" int ssm_partial_channels() { return CH * CHAIN; }
extern "C" int ssm_max_state() { return MAX_N; }

// The kernels' tiling at state size N and dtype (0 = fp32, 1 = bf16), as 11
// ints: channels a block, forward warps and steps a warp's run, the same
// two of the backward, the chunk, the ring stages of a forward and of a
// backward launch, the blocks one dB/dC group partial sums, and the
// forward and backward blocks an SM holds (these two query the card).
extern "C" int ssm_tiling(int* out, int N, int dtype) {
  const int elt = dtype == 1 ? 2 : 4;
  const bool bf = dtype == 1;
  const int v[11] = {CH,
                     FWD_WARPS,
                     FWD_RUN,
                     BWD_WARPS,
                     BWD_RUN,
                     CHUNK,
                     pick_stages(false, elt, N),
                     pick_stages(true, elt, N),
                     CHAIN,
                     bf ? blocks_per_sm<__nv_bfloat16>(false, N) : blocks_per_sm<float>(false, N),
                     bf ? blocks_per_sm<__nv_bfloat16>(true, N) : blocks_per_sm<float>(true, N)};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// u/dt [B, T, di], B/C [B, T, N] (dtype: 0 = fp32, 1 = bf16), A [di, N] and
// D [di] fp32, seg [B, T] int32; writes y [B, T, di] (dtype), ckpt [B,
// ceil(T/64), di, N] and h_final [B, di, N] fp32.  Launches on `stream` and
// returns the CUDA error code.
extern "C" int ssm_fwd(const void* u, const void* dt, const float* A, const void* Bm,
                       const void* Cm, const float* D, const int* seg, void* y, float* ckpt,
                       float* hfin, int Bsz, int Tn, int di, int N, int dtype,
                       void* stream) {
  if (Bsz == 0 || Tn == 0 || di == 0) return 0;
  if (N < 1 || N > MAX_N) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd<float>(u, dt, A, Bm, Cm, D, seg, y, ckpt, hfin, Bsz, Tn, di, N, st);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(u, dt, A, Bm, Cm, D, seg, y, ckpt, hfin, Bsz, Tn, di,
                                          N, st);
  return (int)cudaErrorInvalidValue;
}

// As ssm_fwd, with ckpt from it, dy [B, T, di] (dtype) and dh_final [B, di,
// N] fp32; writes du/ddt [B, T, di] (dtype) and fp32 partials: dA [B, di, N],
// dB/dC [ceil(di/256), B, T, N], dD [B, di].  `chain` is int32 [ceil(di/256),
// B, ceil(T/64)], zero at the launch: the blocks' turns.
extern "C" int ssm_bwd(const void* u, const void* dt, const float* A, const void* Bm,
                       const void* Cm, const float* D, const int* seg, const float* ckpt,
                       const void* dy, const float* dhf, void* du, void* ddt,
                       float* dA_part, float* dB_part, float* dC_part, float* dD_part,
                       int* chain, int Bsz, int Tn, int di, int N, int dtype, void* stream) {
  if (Bsz == 0 || Tn == 0 || di == 0) return 0;
  if (N < 1 || N > MAX_N) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_ARGS u, dt, A, Bm, Cm, D, seg, ckpt, dy, dhf, du, ddt, dA_part, dB_part, dC_part, \
                 dD_part, chain, Bsz, Tn, di, N, st
  if (dtype == 0) return (int)launch_bwd<float>(BWD_ARGS);
  if (dtype == 1) return (int)launch_bwd<__nv_bfloat16>(BWD_ARGS);
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
