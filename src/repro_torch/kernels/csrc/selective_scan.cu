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
// seg [B, T] int32.  Arithmetic is fp32.
//
// Design.  The TPU grid tiled channels across its parallel axis and walked
// time in order, carrying the [bd, N] state in VMEM scratch.  Here the work
// is parallel over (stream, channel, state) and sequential over time:
//   * A block owns 32 channels of one stream, one per lane, and N_PAD/4
//     warps; warp w holds states 4w..4w+3 of its lane's channel in
//     registers (N_PAD is N rounded up to 4, 8, 16, 32 or 64; padded states
//     have A = B = C = 0 and stay 0).  A warp's loads of u/dt/dy are 32
//     consecutive channels; B_t/C_t, which every channel reads, and the
//     keep flags are staged in shared memory, as are u/dt/dy.
//   * Sums over states (y, <g,B>, the ddt sum) are per-warp partials in
//     shared memory, added over the warps once per 16-step sub-chunk.
//   * Sums over channels (dB, dC) are a butterfly reduce-scatter across the
//     warp's lanes (9 shuffles a step for 8 values) into one partial per
//     32-channel block, [di/32, B, T, N], which the wrapper sums, as the
//     JAX package sums dBp/dCp.  dA and dD are summed over time in
//     registers and written per stream; the wrapper sums the streams.
//     Every sum runs in a fixed order: no atomics, deterministic.
//   * The forward writes the state entering every 64-step chunk (ckpt
//     [B, ceil(T/64), di, N] fp32) and h_final.  The backward walks the
//     chunks in reverse.  A chunk's per-step states do not fit on chip
//     (32 channels x 64 steps x 16 states x 4 B is 128 KB a block), so it
//     recomputes twice: once through the chunk from its checkpoint to keep
//     the state entering each 16-step sub-chunk, then per sub-chunk, in
//     reverse, the 16 per-step states into registers (64 a thread), which
//     the reverse walk of that sub-chunk reads.  Three exponentials per
//     (t, c, n) in the backward against one in the forward.
//   * Steps past T are staged as exact identities (u = dt = B = C = dy = 0,
//     keep = 1), so every loop runs whole sub-chunks; their outputs are not
//     written.  No length or segment id is read on the host.
//
// Bound on the H100.  At falcon-mamba-7b's training shape both kernels are
// bound by operations: T*di*N exponentials on the special-function units
// (16 a clock per SM) before fp32 FMAs or bytes.  This simple design spends
// more than one exponential per (t, c, n) in the backward and issues
// scalar loads; what it leaves for later: a chunked parallel scan over time,
// exp2 with a prescaled A, and keeping dA for the reverse walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 32;              // channels per block, one per lane
constexpr int SPT = 4;              // states per thread
constexpr int SUB = 16;             // steps per sub-chunk
constexpr int CHUNK = 64;           // steps per checkpoint
constexpr int NSUB = CHUNK / SUB;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// keep_t of stream row `sg` (int32 [T]); steps past T are identities.
__device__ __forceinline__ int keep_at(const int* sg, int t, int Tn) {
  if (t >= Tn) return 1;
  return (t > 0 && sg[t] > 0 && sg[t] == sg[t - 1]) ? 1 : 0;
}

// Stage `steps` rows of a [T, di] channel slab (32 channels from c0) as
// fp32 into s[steps][CH]; rows past T and channels past di read 0.
template <typename T>
__device__ __forceinline__ void stage_channels(float* s, const T* src, int t0, int steps,
                                               int Tn, int c0, int di, int tid, int nt) {
  for (int e = tid; e < steps * CH; e += nt) {
    const int j = e / CH, ch = e % CH, t = t0 + j, c = c0 + ch;
    s[e] = (t < Tn && c < di) ? to_f32(src[(size_t)t * di + c]) : 0.f;
  }
}

// Stage `steps` rows of a [T, N] slab as fp32 into s[steps][NP].
template <typename T, int NP>
__device__ __forceinline__ void stage_states(float* s, const T* src, int t0, int steps,
                                             int Tn, int N, int tid, int nt) {
  for (int e = tid; e < steps * NP; e += nt) {
    const int j = e / NP, n = e % NP, t = t0 + j;
    s[e] = (t < Tn && n < N) ? to_f32(src[(size_t)t * N + n]) : 0.f;
  }
}

// ----------------------------------------------------------------------
// Forward.  grid (ceil(di/32), B), block 32 * NP/4.
// ----------------------------------------------------------------------
template <typename T, int NP>
__global__ void __launch_bounds__(CH * NP / SPT)
ssm_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D,
               const int* __restrict__ seg, T* __restrict__ y, float* __restrict__ ckpt,
               float* __restrict__ hfin, int Tn, int di, int N) {
  constexpr int W = NP / SPT;
  constexpr int NT = CH * W;
  __shared__ float s_u[SUB * CH], s_dt[SUB * CH], s_B[SUB * NP], s_C[SUB * NP];
  __shared__ float s_yp[W * SUB * CH];
  __shared__ int s_keep[SUB];

  const int tid = threadIdx.x, lane = tid % CH, w = tid / CH;
  const int b = blockIdx.y, c0 = blockIdx.x * CH, c = c0 + lane;
  const bool c_ok = c < di;
  const T* ub = u + (size_t)b * Tn * di;
  const T* dtb = dt + (size_t)b * Tn * di;
  const T* Bb = Bm + (size_t)b * Tn * N;
  const T* Cb = Cm + (size_t)b * Tn * N;
  const int* sg = seg + (size_t)b * Tn;
  T* yb = y + (size_t)b * Tn * di;
  const int n_ck = (Tn + CHUNK - 1) / CHUNK;

  float a[SPT], h[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int n = w * SPT + i;
    a[i] = (c_ok && n < N) ? A[(size_t)c * N + n] : 0.f;
    h[i] = 0.f;
  }

  for (int t0 = 0; t0 < Tn; t0 += SUB) {
    if (t0 % CHUNK == 0 && c_ok) {  // the state entering this chunk
      float* ck = ckpt + (((size_t)b * n_ck + t0 / CHUNK) * di + c) * N;
#pragma unroll
      for (int i = 0; i < SPT; ++i)
        if (w * SPT + i < N) ck[w * SPT + i] = h[i];
    }
    stage_channels(s_u, ub, t0, SUB, Tn, c0, di, tid, NT);
    stage_channels(s_dt, dtb, t0, SUB, Tn, c0, di, tid, NT);
    stage_states<T, NP>(s_B, Bb, t0, SUB, Tn, N, tid, NT);
    stage_states<T, NP>(s_C, Cb, t0, SUB, Tn, N, tid, NT);
    if (tid < SUB) s_keep[tid] = keep_at(sg, t0 + tid, Tn);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const float dtv = s_dt[j * CH + lane];
      const float x = dtv * s_u[j * CH + lane];
      const bool kp = s_keep[j] != 0;
      float yp = 0.f;
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const int n = w * SPT + i;
        const float dA = expf(dtv * a[i]);
        h[i] = (kp ? h[i] * dA : 0.f) + x * s_B[j * NP + n];
        yp += h[i] * s_C[j * NP + n];
      }
      s_yp[(w * SUB + j) * CH + lane] = yp;
    }
    __syncthreads();

    for (int e = tid; e < SUB * CH; e += NT) {
      const int j = e / CH, ch = e % CH, t = t0 + j;
      if (t < Tn && c0 + ch < di) {
        float yv = 0.f;
#pragma unroll
        for (int v = 0; v < W; ++v) yv += s_yp[(v * SUB + j) * CH + ch];
        yb[(size_t)t * di + c0 + ch] = from_f32<T>(yv + D[c0 + ch] * s_u[e]);
      }
    }
    __syncthreads();
  }

  if (c_ok) {
    float* hf = hfin + ((size_t)b * di + c) * N;
#pragma unroll
    for (int i = 0; i < SPT; ++i)
      if (w * SPT + i < N) hf[w * SPT + i] = h[i];
  }
}

// ----------------------------------------------------------------------
// Backward.  grid (ceil(di/32), B), block 32 * NP/4, dynamic shared memory
// (bwd_smem_floats).
// ----------------------------------------------------------------------
template <int NP>
constexpr int bwd_smem_floats() {
  // u, dt, dy [CHUNK][CH]; B, C [CHUNK][NP]; <g,B> and ddt partials
  // [W][SUB][CH]; dD partials [W][CH]; keep [CHUNK] (as int).
  return 3 * CHUNK * CH + 2 * CHUNK * NP + 2 * (NP / SPT) * SUB * CH + (NP / SPT) * CH +
         CHUNK;
}

// Sum 8 values (v[0..3]: dB terms of states 4w+s; v[4..7]: dC terms) over
// the warp's 32 lanes.  Returns the sum of value ((lane>>4)&1)*4 +
// ((lane>>3)&1)*2 + ((lane>>2)&1) (every lane of a group of 4 holds it).
__device__ __forceinline__ float reduce_scatter8(const float v[8], int lane) {
  float r4[4], r2[2];
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = hi16 ? v[i] : v[i + 4];
    r4[i] = (hi16 ? v[i + 4] : v[i]) + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = hi8 ? r4[i] : r4[i + 2];
    r2[i] = (hi8 ? r4[i + 2] : r4[i]) + __shfl_xor_sync(FULL, send, 8);
  }
  const float send = hi4 ? r2[0] : r2[1];
  float r = (hi4 ? r2[1] : r2[0]) + __shfl_xor_sync(FULL, send, 4);
  r += __shfl_xor_sync(FULL, r, 2);
  r += __shfl_xor_sync(FULL, r, 1);
  return r;
}

template <typename T, int NP>
__global__ void __launch_bounds__(CH * NP / SPT)
ssm_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ D,
               const int* __restrict__ seg, const float* __restrict__ ckpt,
               const T* __restrict__ dy, const float* __restrict__ dhf, T* __restrict__ du,
               T* __restrict__ ddt, float* __restrict__ dA_part,
               float* __restrict__ dB_part, float* __restrict__ dC_part,
               float* __restrict__ dD_part, int Bsz, int Tn, int di, int N) {
  constexpr int W = NP / SPT;
  constexpr int NT = CH * W;
  extern __shared__ float smem[];
  float* s_u = smem;
  float* s_dt = s_u + CHUNK * CH;
  float* s_dy = s_dt + CHUNK * CH;
  float* s_B = s_dy + CHUNK * CH;
  float* s_C = s_B + CHUNK * NP;
  float* s_gb = s_C + CHUNK * NP;        // [W][SUB][CH] partial <g, B>
  float* s_dd = s_gb + W * SUB * CH;     // [W][SUB][CH] partial ddt sum
  float* s_dD = s_dd + W * SUB * CH;     // [W][CH]
  int* s_keep = reinterpret_cast<int*>(s_dD + W * CH);

  const int tid = threadIdx.x, lane = tid % CH, w = tid / CH;
  const int b = blockIdx.y, c0 = blockIdx.x * CH, c = c0 + lane;
  const bool c_ok = c < di;
  const size_t off_c = (size_t)b * Tn * di, off_n = (size_t)b * Tn * N;
  const int* sg = seg + (size_t)b * Tn;
  const int n_ck = (Tn + CHUNK - 1) / CHUNK;
  // this block's slab of the dB/dC partials: [blockIdx.x][b][T][N]
  const size_t part = ((size_t)blockIdx.x * Bsz + b) * Tn * N;

  float a[SPT], g[SPT], dA_acc[SPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int n = w * SPT + i;
    const bool ok = c_ok && n < N;
    a[i] = ok ? A[(size_t)c * N + n] : 0.f;
    g[i] = ok ? dhf[((size_t)b * di + c) * N + n] : 0.f;
    dA_acc[i] = 0.f;
  }
  float dD_acc = 0.f;
  // the dB/dC value this lane holds after reduce_scatter8
  const int rs_which = (lane >> 4) & 1;
  const int rs_state = w * SPT + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
  const bool rs_writer = (lane & 3) == 0 && rs_state < N;

  for (int k = n_ck - 1; k >= 0; --k) {
    const int t0 = k * CHUNK;
    stage_channels(s_u, u + off_c, t0, CHUNK, Tn, c0, di, tid, NT);
    stage_channels(s_dt, dt + off_c, t0, CHUNK, Tn, c0, di, tid, NT);
    stage_channels(s_dy, dy + off_c, t0, CHUNK, Tn, c0, di, tid, NT);
    stage_states<T, NP>(s_B, Bm + off_n, t0, CHUNK, Tn, N, tid, NT);
    stage_states<T, NP>(s_C, Cm + off_n, t0, CHUNK, Tn, N, tid, NT);
    for (int j = tid; j < CHUNK; j += NT) s_keep[j] = keep_at(sg, t0 + j, Tn);
    __syncthreads();

    // Recompute once through the chunk: the state entering each sub-chunk.
    float hb[NSUB][SPT];
    {
      float h[SPT];
      const float* ck = ckpt + (((size_t)b * n_ck + k) * di + c) * N;
#pragma unroll
      for (int i = 0; i < SPT; ++i)
        h[i] = (c_ok && w * SPT + i < N) ? ck[w * SPT + i] : 0.f;
#pragma unroll
      for (int s = 0; s < NSUB; ++s) {
#pragma unroll
        for (int i = 0; i < SPT; ++i) hb[s][i] = h[i];
        if (s == NSUB - 1) break;
#pragma unroll 4
        for (int j = s * SUB; j < (s + 1) * SUB; ++j) {
          const float dtv = s_dt[j * CH + lane];
          const float x = dtv * s_u[j * CH + lane];
          const bool kp = s_keep[j] != 0;
#pragma unroll
          for (int i = 0; i < SPT; ++i)
            h[i] = (kp ? h[i] * expf(dtv * a[i]) : 0.f) + x * s_B[j * NP + w * SPT + i];
        }
      }
    }

#pragma unroll 1
    for (int s = NSUB - 1; s >= 0; --s) {
      // The sub-chunk's per-step states, recomputed into registers.
      float hs[SUB][SPT];
      float hprev0[SPT];
#pragma unroll
      for (int i = 0; i < SPT; ++i) hprev0[i] = hb[s][i];
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const int tl = s * SUB + j;
        const float dtv = s_dt[tl * CH + lane];
        const float x = dtv * s_u[tl * CH + lane];
        const bool kp = s_keep[tl] != 0;
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
          const float hp = j > 0 ? hs[j > 0 ? j - 1 : 0][i] : hprev0[i];
          hs[j][i] = (kp ? hp * expf(dtv * a[i]) : 0.f) + x * s_B[tl * NP + w * SPT + i];
        }
      }

      // Reverse walk of the sub-chunk.
#pragma unroll
      for (int j = SUB - 1; j >= 0; --j) {
        const int tl = s * SUB + j;
        const float dtv = s_dt[tl * CH + lane];
        const float uv = s_u[tl * CH + lane];
        const float dyv = s_dy[tl * CH + lane];
        const bool kp = s_keep[tl] != 0;
        float gb = 0.f, dd = 0.f, v[8];
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
          const int n = w * SPT + i;
          const float gi = dyv * s_C[tl * NP + n] + g[i];
          const float hm = kp ? (j > 0 ? hs[j > 0 ? j - 1 : 0][i] : hprev0[i]) : 0.f;
          const float e = expf(dtv * a[i]);
          const float ghe = gi * hm * e;
          gb += gi * s_B[tl * NP + n];
          dd += ghe * a[i];
          dA_acc[i] += ghe * dtv;
          v[i] = gi * dtv * uv;
          v[i + SPT] = dyv * hs[j][i];
          g[i] = kp ? e * gi : 0.f;
        }
        s_gb[(w * SUB + j) * CH + lane] = gb;
        s_dd[(w * SUB + j) * CH + lane] = dd;
        const float r = reduce_scatter8(v, lane);
        const int t = t0 + tl;
        if (rs_writer && t < Tn)
          (rs_which ? dC_part : dB_part)[part + (size_t)t * N + rs_state] = r;
      }
      __syncthreads();

      // du, ddt of the sub-chunk's (step, channel) pairs; dD terms.
      for (int e = tid; e < SUB * CH; e += NT) {
        const int j = e / CH, ch = e % CH, tl = s * SUB + j, t = t0 + tl;
        if (t < Tn && c0 + ch < di) {
          float gbs = 0.f, dds = 0.f;
#pragma unroll
          for (int v = 0; v < W; ++v) {
            gbs += s_gb[(v * SUB + j) * CH + ch];
            dds += s_dd[(v * SUB + j) * CH + ch];
          }
          const float uv = s_u[tl * CH + ch], dyv = s_dy[tl * CH + ch];
          const size_t o = off_c + (size_t)t * di + c0 + ch;
          du[o] = from_f32<T>(D[c0 + ch] * dyv + s_dt[tl * CH + ch] * gbs);
          ddt[o] = from_f32<T>(dds + uv * gbs);
          dD_acc += dyv * uv;  // e % CH == tid % CH: this thread's channel
        }
      }
      __syncthreads();
    }
  }

  // dA per stream; dD per stream, summed over the warps' time rows.
  if (c_ok) {
#pragma unroll
    for (int i = 0; i < SPT; ++i)
      if (w * SPT + i < N) dA_part[((size_t)b * di + c) * N + w * SPT + i] = dA_acc[i];
  }
  s_dD[w * CH + lane] = dD_acc;
  __syncthreads();
  if (w == 0 && c_ok) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < W; ++v) s += s_dD[v * CH + lane];
    dD_part[(size_t)b * di + c] = s;
  }
}

// Dynamic shared memory above 48 KB must be allowed once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int NP>
cudaError_t launch_fwd(const void* u, const void* dt, const float* A, const void* Bm,
                       const void* Cm, const float* D, const int* seg, void* y, float* ckpt,
                       float* hfin, int Bsz, int Tn, int di, int N, cudaStream_t st) {
  const dim3 grid((di + CH - 1) / CH, Bsz);
  ssm_fwd_kernel<T, NP><<<grid, CH * NP / SPT, 0, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, seg, static_cast<T*>(y), ckpt, hfin, Tn, di, N);
  return cudaGetLastError();
}

template <typename T, int NP>
cudaError_t launch_bwd(const void* u, const void* dt, const float* A, const void* Bm,
                       const void* Cm, const float* D, const int* seg, const float* ckpt,
                       const void* dy, const float* dhf, void* du, void* ddt,
                       float* dA_part, float* dB_part, float* dC_part, float* dD_part,
                       int Bsz, int Tn, int di, int N, cudaStream_t st) {
  const int bytes = bwd_smem_floats<NP>() * (int)sizeof(float);
  static const cudaError_t set = allow_smem(ssm_bwd_kernel<T, NP>, bytes);
  if (set != cudaSuccess) return set;
  const dim3 grid((di + CH - 1) / CH, Bsz);
  ssm_bwd_kernel<T, NP><<<grid, CH * NP / SPT, bytes, st>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, seg, ckpt, static_cast<const T*>(dy), dhf,
      static_cast<T*>(du), static_cast<T*>(ddt), dA_part, dB_part, dC_part, dD_part, Bsz,
      Tn, di, N);
  return cudaGetLastError();
}

}  // namespace

// Steps per checkpoint (ckpt is [B, ceil(T / chunk), di, N]), channels per
// block (the dB/dC partials are [ceil(di / channels), B, T, N]) and the
// largest state size the kernels take.
extern "C" int ssm_chunk() { return CHUNK; }
extern "C" int ssm_block_channels() { return CH; }
extern "C" int ssm_max_state() { return 64; }

// u/dt [B, T, di], B/C [B, T, N] (dtype: 0 = fp32, 1 = bf16), A [di, N] and
// D [di] fp32, seg [B, T] int32; writes y [B, T, di] (dtype), ckpt [B,
// ceil(T/64), di, N] and h_final [B, di, N] fp32.  Launches on `stream` and
// returns the CUDA error code.
extern "C" int ssm_fwd(const void* u, const void* dt, const float* A, const void* Bm,
                       const void* Cm, const float* D, const int* seg, void* y, float* ckpt,
                       float* hfin, int Bsz, int Tn, int di, int N, int dtype,
                       void* stream) {
  if (Bsz == 0 || Tn == 0 || di == 0) return 0;
  if (N < 1 || N > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD_ARGS u, dt, A, Bm, Cm, D, seg, y, ckpt, hfin, Bsz, Tn, di, N, st
#define FWD_N(T)                                                    \
  if (N <= 4) return (int)launch_fwd<T, 4>(FWD_ARGS);               \
  if (N <= 8) return (int)launch_fwd<T, 8>(FWD_ARGS);               \
  if (N <= 16) return (int)launch_fwd<T, 16>(FWD_ARGS);             \
  if (N <= 32) return (int)launch_fwd<T, 32>(FWD_ARGS);             \
  return (int)launch_fwd<T, 64>(FWD_ARGS);
  if (dtype == 0) { FWD_N(float) }
  if (dtype == 1) { FWD_N(__nv_bfloat16) }
#undef FWD_N
#undef FWD_ARGS
  return (int)cudaErrorInvalidValue;
}

// As ssm_fwd, with ckpt from it, dy [B, T, di] (dtype) and dh_final [B, di,
// N] fp32; writes du/ddt [B, T, di] (dtype) and fp32 partials: dA [B, di, N],
// dB/dC [ceil(di/32), B, T, N], dD [B, di].
extern "C" int ssm_bwd(const void* u, const void* dt, const float* A, const void* Bm,
                       const void* Cm, const float* D, const int* seg, const float* ckpt,
                       const void* dy, const float* dhf, void* du, void* ddt,
                       float* dA_part, float* dB_part, float* dC_part, float* dD_part,
                       int Bsz, int Tn, int di, int N, int dtype, void* stream) {
  if (Bsz == 0 || Tn == 0 || di == 0) return 0;
  if (N < 1 || N > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BWD_ARGS u, dt, A, Bm, Cm, D, seg, ckpt, dy, dhf, du, ddt, dA_part, dB_part, \
                 dC_part, dD_part, Bsz, Tn, di, N, st
#define BWD_N(T)                                                    \
  if (N <= 4) return (int)launch_bwd<T, 4>(BWD_ARGS);               \
  if (N <= 8) return (int)launch_bwd<T, 8>(BWD_ARGS);               \
  if (N <= 16) return (int)launch_bwd<T, 16>(BWD_ARGS);             \
  if (N <= 32) return (int)launch_bwd<T, 32>(BWD_ARGS);             \
  return (int)launch_bwd<T, 64>(BWD_ARGS);
  if (dtype == 0) { BWD_N(float) }
  if (dtype == 1) { BWD_N(__nv_bfloat16) }
#undef BWD_N
#undef BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
