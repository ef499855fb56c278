// RWKV6 (Finch) WKV recurrence with data-dependent decay, for Hopper
// (built for sm_90a).
//
// Replaces the TPU kernel `wkv6_pallas` (src/repro/kernels/wkv6.py:80;
// pallas_call at :102, body `_wkv_kernel` at :57, math `_chunk_math` at
// :33).  It computes the same function:
//
//   o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,      w_t = exp(logw_t)
//
// per (batch, head), with r, k, logw [B, T, H, K], v [B, T, H, V], u
// [H, K], an optional fp32 initial state [B, H, K, V], o [B, T, H, V] in
// r's dtype and the final state S_T [B, H, K, V] in fp32.  r, k and v are
// fp32 or bf16 (one dtype), logw fp32 or bf16; every operand is read in
// its own dtype and all arithmetic is fp32.
//
// The TPU kernel factors the decay of a chunk as exp(P_{t-1}) * exp(-P_s)
// with P the cumulative log decay, so that the chunk becomes matrix
// products for the MXU.  exp(-P) overflows in fp32 once a chunk's decay
// sums below about -88, and the output turns to NaN.  This kernel does not
// factor: it runs the recurrence token by token, which is exact for every
// decay the model's clip allows (logw down to -e^2 a step) and takes any
// T, T = 1 included, without padding.
//
// What bounds it on this card: at decode (T = 1) the work is a read and a
// write of the fp32 state, K * V * 8 bytes per (batch, head), against
// 7 FLOP per state value: far below the ridge point, so bytes bound it.
// In prefill the state stays on chip and the bound is the r, k, v, logw
// and o traffic; the recurrence itself is sequential in T.  The design:
//   * the columns of S are independent (S[:, j] needs only v_t[j]), so a
//     block owns one (batch, head) and up to 128 columns, one thread a
//     column, and each thread keeps its K state values in registers for
//     the whole sequence: the state is read once and written once;
//   * TC = 32 steps of r, k, w = exp(logw) (and u once) are staged in
//     shared memory as fp32 by all threads together, and each thread
//     stages its own v values, so one barrier pair serves 32 steps;
//   * each step reads r, k, w, u four at a time (16-byte shared loads,
//     broadcast to the warp) and sums o over K in four partial sums, to
//     shorten the chain of dependent adds.
// Left for later: several threads a column (more warps for a head at
// prefill), tensor cores for a prefill chunk, several heads a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 32;     // time steps staged per pass
constexpr int MAXT = 128;  // columns (threads) per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// One state value through one step: the bonus term enters o, then the
// decayed state takes the new outer product.
__device__ __forceinline__ void step(float& s, float r, float k, float w,
                                     float u, float vj, float& acc) {
  const float kv = k * vj;
  acc = fmaf(r, fmaf(u, kv, s), acc);
  s = fmaf(w, s, kv);
}

template <typename TX, typename TW, int KMAX>
__global__ void __launch_bounds__(MAXT)
wkv6_kernel(const TX* __restrict__ r, const TX* __restrict__ k,
            const TX* __restrict__ v, const TW* __restrict__ logw,
            const float* __restrict__ u, const float* s0, TX* __restrict__ o,
            float* sT, int T, int H, int K, int V) {
  // rows padded to KMAX with zeros: a padded state value stays 0 and adds
  // 0 to o, so the unrolled loop needs no bound on K
  __shared__ __align__(16) float r_s[TC][KMAX];
  __shared__ __align__(16) float k_s[TC][KMAX];
  __shared__ __align__(16) float w_s[TC][KMAX];
  __shared__ __align__(16) float u_s[KMAX];
  __shared__ float v_s[TC][MAXT];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = j < V;

  const size_t sbase = (size_t)bh * K * V;
  float S[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
    S[i] = (s0 != nullptr && live && i < K) ? s0[sbase + (size_t)i * V + j]
                                            : 0.0f;
  for (int i = threadIdx.x; i < KMAX; i += blockDim.x)
    u_s[i] = i < K ? u[(size_t)h * K + i] : 0.0f;

  const size_t rk0 = ((size_t)b * T * H + h) * K;  // element (b, 0, h, 0)
  const size_t v0 = ((size_t)b * T * H + h) * V;
  const size_t rk_t = (size_t)H * K, v_t = (size_t)H * V;

  for (int t0 = 0; t0 < T; t0 += TC) {
    const int n = min(TC, T - t0);
    __syncthreads();  // the previous pass is done with the staging buffers
    for (int e = threadIdx.x; e < n * KMAX; e += blockDim.x) {
      const int tt = e / KMAX, i = e % KMAX;
      float rv = 0.0f, kvv = 0.0f, wv = 0.0f;
      if (i < K) {
        const size_t off = rk0 + (size_t)(t0 + tt) * rk_t + i;
        rv = to_f(r[off]);
        kvv = to_f(k[off]);
        wv = expf(to_f(logw[off]));
      }
      r_s[tt][i] = rv;
      k_s[tt][i] = kvv;
      w_s[tt][i] = wv;
    }
    if (live)
      for (int tt = 0; tt < n; ++tt)
        v_s[tt][threadIdx.x] = to_f(v[v0 + (size_t)(t0 + tt) * v_t + j]);
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt][threadIdx.x];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i4 = 0; i4 < KMAX / 4; ++i4) {
        const float4 rr = reinterpret_cast<const float4*>(r_s[tt])[i4];
        const float4 kk = reinterpret_cast<const float4*>(k_s[tt])[i4];
        const float4 ww = reinterpret_cast<const float4*>(w_s[tt])[i4];
        const float4 uu = reinterpret_cast<const float4*>(u_s)[i4];
        step(S[4 * i4 + 0], rr.x, kk.x, ww.x, uu.x, vj, acc[0]);
        step(S[4 * i4 + 1], rr.y, kk.y, ww.y, uu.y, vj, acc[1]);
        step(S[4 * i4 + 2], rr.z, kk.z, ww.z, uu.z, vj, acc[2]);
        step(S[4 * i4 + 3], rr.w, kk.w, ww.w, uu.w, vj, acc[3]);
      }
      store(o + v0 + (size_t)(t0 + tt) * v_t + j,
            (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < K) sT[sbase + (size_t)i * V + j] = S[i];
  }
}

template <typename TX, typename TW, int KMAX>
cudaError_t launch_k(const void* r, const void* k, const void* v,
                     const void* logw, const void* u, const void* s0,
                     void* o, void* sT, int B, int T, int H, int K, int V,
                     cudaStream_t s) {
  const int threads = min(MAXT, (V + 31) / 32 * 32);
  const dim3 grid(B * H, (V + threads - 1) / threads);
  wkv6_kernel<TX, TW, KMAX><<<grid, threads, 0, s>>>(
      static_cast<const TX*>(r), static_cast<const TX*>(k),
      static_cast<const TX*>(v), static_cast<const TW*>(logw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<TX*>(o), static_cast<float*>(sT), T, H, K, V);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_types(const void* r, const void* k, const void* v,
                         const void* logw, const void* u, const void* s0,
                         void* o, void* sT, int B, int T, int H, int K, int V,
                         cudaStream_t s) {
  if (K <= 16)
    return launch_k<TX, TW, 16>(r, k, v, logw, u, s0, o, sT, B, T, H, K, V,
                                s);
  if (K <= 32)
    return launch_k<TX, TW, 32>(r, k, v, logw, u, s0, o, sT, B, T, H, K, V,
                                s);
  return launch_k<TX, TW, 64>(r, k, v, logw, u, s0, o, sT, B, T, H, K, V, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// x_type (r, k, v and o) and w_type (logw): 0 = fp32, 1 = bf16.  u and the
// states are fp32; s0 may be null (a zero initial state) and may alias sT.
// Pointers are device pointers to contiguous arrays, and the Python wrapper
// checked the shapes (B, T, H >= 1; 1 <= K <= 64; 1 <= V <= 1024).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, const void* s0,
                           void* o, void* sT, int B, int T, int H, int K,
                           int V, int x_type, int w_type, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > 64 || V < 1 || V > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (x_type == 0 && w_type == 0)
    err = launch_types<float, float>(r, k, v, logw, u, s0, o, sT, B, T, H, K,
                                     V, s);
  else if (x_type == 1 && w_type == 0)
    err = launch_types<__nv_bfloat16, float>(r, k, v, logw, u, s0, o, sT, B,
                                             T, H, K, V, s);
  else if (x_type == 0 && w_type == 1)
    err = launch_types<float, __nv_bfloat16>(r, k, v, logw, u, s0, o, sT, B,
                                             T, H, K, V, s);
  else if (x_type == 1 && w_type == 1)
    err = launch_types<__nv_bfloat16, __nv_bfloat16>(r, k, v, logw, u, s0, o,
                                                      sT, B, T, H, K, V, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
