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
// The columns of S are independent (S[:, j] needs only v_t[j]), so a block
// owns one (batch, head, column tile) and no reduction crosses blocks: the
// result does not depend on the order in which blocks run, and there are no
// atomics.  The blocks of one head each read its r, k and logw (from L2 after
// the first).  `wkv6_geometry` in kernels/wkv6.py picks the variant and the
// tile: column tiles of 64, 32 or 16 are halved until the grid holds at
// least 256 blocks (two per SM), never below 16 columns.  One launch a call.
//
// 1. Decode (`wkv6_decode_kernel`, T <= 4): bound by the bytes of the fp32
//    state, read and written once (K * V * 8 bytes per head against 7 FLOP
//    a state value).  A thread owns 4 rows x a float4 of columns of the
//    block's state slice, so K / 4 threads share a column and a block of a
//    32-column tile at K = 64 has 128 threads.  The state (16-byte loads
//    along V), u, and the first token's r, k, logw and v are all loaded
//    before the first use; each token's operands are loaded one token ahead.
//    Each row group's partial o goes to shared memory and the tile's threads
//    sum the groups in a fixed order.
// 2. Chunked (`wkv6_chunked_kernel`, T > 4; one instantiation a tile
//    width): at long T bound by its fp32 operations.  256 threads.  The
//    block's state slice [K, tile] stays on chip for the whole sequence: in
//    registers (each of the first threads holds 2 or 4 rows of one column
//    quad) and, for the output step, in one of two shared-memory copies.
//    The block walks chunks of CHUNK tokens: chunk c + 1's r, k, logw and v
//    are copied by cp.async into the second of two shared-memory stages
//    while chunk c is computed, and chunk c's o is gathered in shared
//    memory and written in 16-byte stores.  A chunk is computed in
//    sub-chunks of SUB tokens: with p_t the cumulative log decay since the
//    sub-chunk's start (p_{-1} = 0),
//      o_t = sum_{s<t} A[t,s] v_s + (r_t . (u * k_t)) v_t
//            + (r_t * e^{p_{t-1}}) S,
//      A[t,s] = sum_i r_{t,i} k_{s,i} e^{p_{t-1,i} - p_{s,i}},
//      S <- diag(e^{p_last}) S + sum_s (k_s * e^{p_last - p_s}) v_s^T.
//    Finiteness: every decay factor has an exponent <= 0.  Inside a
//    sub-chunk e^{p_{t-1} - p_s} (s < t) is computed directly for each pair;
//    a pair across sub-chunks is factored at the boundary b before t's
//    sub-chunk, e^{P_{t-1} - P_b} e^{P_b - P_s}: the first factor is the
//    e^{p_{t-1}} applied to r_t, the second is folded into the state at b by
//    the updates above, each factor <= 1.  p is a running sum of values
//    <= 0 taken in token order, so it never rises and no difference is
//    positive.  The TPU kernel divides by e^{P_s} instead, which overflows
//    fp32 once a chunk's decay sums below about -88; here every logw <= 0
//    gives a finite result, and an underflow to 0 stands only for a true
//    value below fp32's range.  Per sub-chunk, three barriers:
//      (1) a thread runs p over the sub-chunk for one row of K and keeps 4
//          tokens: p in log2 units, r, k and v in fp32, r e^{p_{t-1}}
//          (transposed), k e^{p_last - p_t} and e^{p_last};
//      (2) A in 4 x 4 blocks of token pairs, a block a warp below the
//          diagonal and two diagonal blocks for each of warps 6 and 7, lanes
//          along K, the 16 sums reduce-scattered over the warp;
//      (3) o in tiles of 2 tokens x 4 columns over 64 / tile lanes, each
//          with a share of K, reduce-scattered, and in the same phase (4)
//          the state update into the other copy of S.
//    Rows of S, v, A^T and r e^{p} in shared memory are padded so that the
//    rows a quarter-warp reads fall on distinct banks.  All on the CUDA
//    cores in fp32: about as many FLOP a token as the recurrence, but the
//    SUB tokens of a sub-chunk in parallel.  Tensor cores are left out: TF32
//    or one bf16 rounding of the decayed operands would break the fp32
//    tolerance of 1e-4 (max|y| + 1).
//
// s0 may alias sT: each state value is read, in either variant, by the
// thread that later writes it, before any write of the block, and blocks own
// disjoint slices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;     // tokens a cp.async stage
constexpr int SUB = 16;       // tokens a sub-chunk
constexpr int NT = 256;       // threads of a chunked block
constexpr int MAX_TILE = 64;  // columns a block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// p[0..3] as fp32, elements from n on read as 0: with `vec` (p 16-byte
// aligned for fp32, 8-byte for bf16) one load, else element loads
__device__ __forceinline__ float4 ld4(const float* p, int n, bool vec) {
  if (vec && n >= 4) return *reinterpret_cast<const float4*>(p);
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n > 0) x.x = p[0];
  if (n > 1) x.y = p[1];
  if (n > 2) x.z = p[2];
  if (n > 3) x.w = p[3];
  return x;
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p, int n,
                                      bool vec) {
  if (vec && n >= 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    return make_float4(bf_lo(w.x), bf_hi(w.x), bf_lo(w.y), bf_hi(w.y));
  }
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n > 0) x.x = to_f(p[0]);
  if (n > 1) x.y = to_f(p[1]);
  if (n > 2) x.z = to_f(p[2]);
  if (n > 3) x.w = to_f(p[3]);
  return x;
}
// the first n of four fp32 values to p
__device__ __forceinline__ void st4(float* p, float4 x, int n, bool vec) {
  if (vec && n >= 4) {
    *reinterpret_cast<float4*>(p) = x;
    return;
  }
  if (n > 0) p[0] = x.x;
  if (n > 1) p[1] = x.y;
  if (n > 2) p[2] = x.z;
  if (n > 3) p[3] = x.w;
}
// four floats from shared memory (16-byte aligned)
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 2^x on the special-function unit: 2 ulp, and 0 below 2^-126 (x < -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16-byte copy of which the first `bytes` are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// One level of a reduce-scatter over the warp: lanes O apart swap halves of
// x[0 .. 2N), and each keeps the sum of the half its bit O selects in x[0, N)
template <int N, int O>
__device__ __forceinline__ void rs_level(float* x, int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float send = up ? x[q] : x[q + N];
    const float keep = up ? x[q + N] : x[q];
    x[q] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

// One state value through one token: the bonus term enters o, then the
// decayed state takes the new outer product.
__device__ __forceinline__ void step(float& s, float r, float k, float w,
                                     float u, float vj, float& acc) {
  const float kv = k * vj;
  acc = fmaf(r, fmaf(u, kv, s), acc);
  s = fmaf(w, s, kv);
}
__device__ __forceinline__ void step4(float4& s, float r, float k, float w,
                                      float u, float4 v, float4& acc) {
  step(s.x, r, k, w, u, v.x, acc.x);
  step(s.y, r, k, w, u, v.y, acc.y);
  step(s.z, r, k, w, u, v.z, acc.z);
  step(s.w, r, k, w, u, v.w, acc.w);
}

// ---------------------------------------------------------------------------
// 1. decode: several threads a column
// ---------------------------------------------------------------------------

struct Tok {  // one token's operands for a thread's 4 rows and 4 columns
  float4 r, k, w, v;
};

template <typename TX, typename TW>
__device__ __forceinline__ Tok load_tok(const TX* r, const TX* k,
                                                const TW* lw, const TX* v,
                                                int nk, int nv, bool vec) {
  return {ld4(r, nk, vec), ld4(k, nk, vec), ld4(lw, nk, vec),
          ld4(v, nv, vec)};
}

template <typename TX, typename TW, int KMAX>
__global__ void __launch_bounds__(256)
wkv6_decode_kernel(const TX* __restrict__ r, const TX* __restrict__ k,
                   const TX* __restrict__ v, const TW* __restrict__ logw,
                   const float* __restrict__ u, const float* s0,
                   TX* __restrict__ o, float* sT, int T, int H, int K, int V,
                   int tn, int n_tiles, int vec) {
  constexpr int RG = KMAX / 4;  // row groups of 4 rows
  __shared__ __align__(16) float red[2][RG][MAX_TILE];

  const int tile = blockIdx.x % n_tiles, bh = blockIdx.x / n_tiles;
  const int b = bh / H, h = bh - b * H;
  const int ncq = tn / 4;
  const int cq = threadIdx.x % ncq, rg = threadIdx.x / ncq;
  const int i0 = rg * 4, jt = cq * 4, j = tile * tn + jt;
  const bool vq = vec & 1;
  const int nk = K - i0, nv = V - j;

  // every load of the first token is issued before the first use
  const size_t sbase = (size_t)bh * K * V + j;
  float4 S[4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
    S[a] = (s0 != nullptr && a < nk)
               ? ld4(s0 + sbase + (size_t)(i0 + a) * V, nv, vq)
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 uu = ld4(u + (size_t)h * K + i0, nk, vq);
  const size_t rk_t = (size_t)H * K, v_t = (size_t)H * V;
  const size_t rk0 = ((size_t)b * T * H + h) * K + i0;  // (b, 0, h, i0)
  const size_t v0 = ((size_t)b * T * H + h) * V;        // (b, 0, h, 0)
  Tok cur = load_tok(r + rk0, k + rk0, logw + rk0, v + v0 + j, nk, nv,
                             vq);

  for (int t = 0; t < T; ++t) {
    Tok nxt = cur;
    if (t + 1 < T) {
      const size_t d = (size_t)(t + 1) * rk_t;
      nxt = load_tok(r + rk0 + d, k + rk0 + d, logw + rk0 + d,
                     v + v0 + (size_t)(t + 1) * v_t + j, nk, nv, vq);
    }
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    step4(S[0], cur.r.x, cur.k.x, expf(cur.w.x), uu.x, cur.v, acc);
    step4(S[1], cur.r.y, cur.k.y, expf(cur.w.y), uu.y, cur.v, acc);
    step4(S[2], cur.r.z, cur.k.z, expf(cur.w.z), uu.z, cur.v, acc);
    step4(S[3], cur.r.w, cur.k.w, expf(cur.w.w), uu.w, cur.v, acc);
    *reinterpret_cast<float4*>(&red[t & 1][rg][jt]) = acc;
    __syncthreads();  // red[t & 1] is next written two tokens on
    if ((int)threadIdx.x < tn) {
      float sum = 0.0f;
#pragma unroll
      for (int g = 0; g < RG; ++g) sum += red[t & 1][g][threadIdx.x];
      const int jj = tile * tn + threadIdx.x;
      if (jj < V) store(o + v0 + (size_t)t * v_t + jj, sum);
    }
    cur = nxt;
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
    if (a < nk) st4(sT + sbase + (size_t)(i0 + a) * V, S[a], nv, vq);
}

// ---------------------------------------------------------------------------
// 2. chunked: an exact chunked form on the CUDA cores
// ---------------------------------------------------------------------------

// byte offsets into the dynamic shared memory of a chunked block
template <typename TX, typename TW, int KMAX>
struct Layout {
  int r, k, w, v, stage;  // one stage of staged operands, raw dtypes
  static constexpr int QS = SUB + 2;  // rows of qT and A^T, padded
  int sp;  // rows of S and v32: tn + tn / 4 words, so that the 8 rows a
           // quarter-warp reads in the output step fall on distinct banks
  int S, r32, k32, v32, P2, qT, kh, dec, u, A, o, total;
  __host__ __device__ explicit Layout(int tn) : sp(tn + tn / 4) {
    r = 0;
    k = r + CHUNK * KMAX * (int)sizeof(TX);
    w = k + CHUNK * KMAX * (int)sizeof(TX);
    v = w + CHUNK * KMAX * (int)sizeof(TW);
    stage = v + CHUNK * tn * (int)sizeof(TX);
    S = 2 * stage;                    // fp32 [2][KMAX][sp]
    r32 = S + 2 * KMAX * sp * 4;      // fp32 [SUB][KMAX]: r, k, log2 decay
    k32 = r32 + SUB * KMAX * 4;
    P2 = k32 + SUB * KMAX * 4;
    kh = P2 + SUB * KMAX * 4;         // fp32 [SUB][KMAX]
    v32 = kh + SUB * KMAX * 4;        // fp32 [SUB][sp]
    qT = v32 + SUB * sp * 4;          // fp32 [KMAX][QS], t fastest
    dec = qT + (KMAX * QS * 4 + 15) / 16 * 16;  // fp32 [KMAX]
    u = dec + KMAX * 4;               // fp32 [KMAX]
    A = u + KMAX * 4;                 // fp32 [SUB][QS], A^T
    o = A + SUB * QS * 4;             // TX [CHUNK][tn]: the chunk's o
    total = o + CHUNK * tn * (int)sizeof(TX);
  }
};

// Copies the CHUNK tokens from c0 on into one stage: r, k and logw rows of K
// elements, v rows of the tile's tn columns.  Tokens from T on and columns
// from V on are zero-filled (k = 0 and logw = 0: an identity update); the
// padding of rows past K was zeroed once and is never written.  With
// `async`, 16-byte cp.async copies (rows a multiple of 16 bytes, 16-byte
// aligned arrays), else element loads and stores.
template <typename TX, typename TW, int KMAX>
__device__ __forceinline__ void stage_chunk(
    unsigned char* st, const Layout<TX, TW, KMAX>& L, const TX* r,
    const TX* k, const TW* logw, const TX* v, int b, int h, int c0, int T,
    int H, int K, int V, int j0, int tn, bool async) {
  TX* rs = reinterpret_cast<TX*>(st + L.r);
  TX* ks = reinterpret_cast<TX*>(st + L.k);
  TW* ws = reinterpret_cast<TW*>(st + L.w);
  TX* vs = reinterpret_cast<TX*>(st + L.v);
  const int tid = threadIdx.x;
  if (async) {
    constexpr int EX = 16 / sizeof(TX), EW = 16 / sizeof(TW);
    const int pk = K / EX, pw = K / EW, pv = tn / EX;
#pragma unroll 1
    for (int e = tid; e < CHUNK * pk; e += NT) {
      const int row = e / pk, pc = e - row * pk, t = c0 + row;
      const bool ok = t < T;
      const size_t off =
          (((size_t)b * T + (ok ? t : 0)) * H + h) * K + pc * EX;
      cp_async16(rs + row * KMAX + pc * EX, r + off, ok ? 16 : 0);
      cp_async16(ks + row * KMAX + pc * EX, k + off, ok ? 16 : 0);
    }
#pragma unroll 1
    for (int e = tid; e < CHUNK * pw; e += NT) {
      const int row = e / pw, pc = e - row * pw, t = c0 + row;
      const bool ok = t < T;
      const size_t off =
          (((size_t)b * T + (ok ? t : 0)) * H + h) * K + pc * EW;
      cp_async16(ws + row * KMAX + pc * EW, logw + off, ok ? 16 : 0);
    }
#pragma unroll 1
    for (int e = tid; e < CHUNK * pv; e += NT) {
      const int row = e / pv, pc = e - row * pv, t = c0 + row;
      const bool ok = t < T && j0 + pc * EX < V;
      const size_t off =
          ok ? (((size_t)b * T + t) * H + h) * V + j0 + pc * EX : 0;
      cp_async16(vs + row * tn + pc * EX, v + off, ok ? 16 : 0);
    }
    return;
  }
#pragma unroll 1
  for (int e = tid; e < CHUNK * K; e += NT) {
    const int row = e / K, i = e - row * K, t = c0 + row;
    const bool ok = t < T;
    const size_t off = (((size_t)b * T + t) * H + h) * K + i;
    rs[row * KMAX + i] = ok ? r[off] : zero_of<TX>();
    ks[row * KMAX + i] = ok ? k[off] : zero_of<TX>();
    ws[row * KMAX + i] = ok ? logw[off] : zero_of<TW>();
  }
#pragma unroll 1
  for (int e = tid; e < CHUNK * tn; e += NT) {
    const int row = e / tn, jc = e - row * tn, t = c0 + row;
    const bool ok = t < T && j0 + jc < V;
    vs[row * tn + jc] =
        ok ? v[(((size_t)b * T + t) * H + h) * V + j0 + jc] : zero_of<TX>();
  }
}

template <typename TX, typename TW, int KMAX, int TN>
__global__ void __launch_bounds__(NT)
wkv6_chunked_kernel(const TX* __restrict__ r, const TX* __restrict__ k,
                    const TX* __restrict__ v, const TW* __restrict__ logw,
                    const float* __restrict__ u, const float* s0,
                    TX* __restrict__ o, float* sT, int T, int H, int K, int V,
                    int n_tiles, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  static_assert(SUB == 16 && NT == 256, "the warp schedules below");
  // the state: SQ float4s (rows KMAX / SQ apart, one column quad) in each
  // of the first NQT threads, so that a v quad loaded once serves SQ rows
  constexpr int SQ = KMAX * TN / 4 >= 2 * NT ? KMAX * TN / 4 / NT : 2;
  constexpr int NQT = KMAX * TN / 4 / SQ;
  constexpr int EPL = KMAX > 32 ? 2 : 1;        // rows of K a lane in (2)
  constexpr int QS = Layout<TX, TW, KMAX>::QS;
  constexpr float LOG2E = 1.4426950408889634f;
  constexpr int tn = TN, ncq = TN / 4;
  const Layout<TX, TW, KMAX> L(tn);
  float* S_s = reinterpret_cast<float*>(smem + L.S);
  float* r32 = reinterpret_cast<float*>(smem + L.r32);
  float* k32 = reinterpret_cast<float*>(smem + L.k32);
  float* v32 = reinterpret_cast<float*>(smem + L.v32);
  float* P2 = reinterpret_cast<float*>(smem + L.P2);
  float* qT = reinterpret_cast<float*>(smem + L.qT);
  float* kh_s = reinterpret_cast<float*>(smem + L.kh);
  float* dec_s = reinterpret_cast<float*>(smem + L.dec);
  float* u_s = reinterpret_cast<float*>(smem + L.u);
  float* A_s = reinterpret_cast<float*>(smem + L.A);
  TX* o_s = reinterpret_cast<TX*>(smem + L.o);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tile = blockIdx.x % n_tiles, bh = blockIdx.x / n_tiles;
  const int b = bh / H, h = bh - b * H;
  const int j0 = tile * tn, sp = L.sp;
  const bool vq = vec & 1, async = vec & 2;

  // with K < KMAX both stages are zeroed once: the rows' padding stays 0
  // (no decay, no input); the copies zero-fill tokens past T themselves
  if (K < KMAX)
    for (int e = tid; e < 2 * L.stage / 16; e += NT)
      reinterpret_cast<uint4*>(smem)[e] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < KMAX; i += NT)
    u_s[i] = i < K ? u[(size_t)h * K + i] : 0.0f;
  // the thread's state float4s: quad e is row e / ncq, columns 4 (e % ncq)
  const size_t sbase = (size_t)bh * K * V + j0;
  float4 S[SQ];
#pragma unroll
  for (int m = 0; m < SQ; ++m) {
    const int e = tid + m * NQT, i = e / ncq, jq = (e - i * ncq) * 4;
    S[m] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (tid < NQT && s0 != nullptr && i < K)
      S[m] = ld4(s0 + sbase + (size_t)i * V + jq, V - j0 - jq, vq);
    if (tid < NQT) *reinterpret_cast<float4*>(S_s + i * sp + jq) = S[m];
  }
  __syncthreads();  // the zeroed stages before any copy into them

  const int n_chunks = (T + CHUNK - 1) / CHUNK;
  int cur = 0;  // the shared copy of S that holds the state now
  const size_t o_t = (size_t)H * V;
  TX* ob = o + ((size_t)b * T * H + h) * V + j0;  // (b, 0, h, j0)

  for (int ch = 0; ch < n_chunks; ++ch) {
    // chunks 0 and 1 first, then chunk ch + 1 into the stage that chunk
    // ch - 1 was read from, whose final barrier has passed (one group a
    // chunk, an empty one past the end)
#pragma unroll 1
    for (int c = ch == 0 ? 0 : ch + 1; c <= ch + 1; ++c) {
      if (c < n_chunks)
        stage_chunk(smem + (c & 1) * L.stage, L, r, k, logw, v, b, h,
                    c * CHUNK, T, H, K, V, j0, tn, async);
      cp_async_commit();
    }
    cp_async_wait<1>();  // this thread's copies of chunk ch landed
    __syncthreads();     // and everyone's
    const unsigned char* st = smem + (ch & 1) * L.stage;

    for (int sc = 0; sc < CHUNK / SUB; ++sc) {
      const int t0 = ch * CHUNK + sc * SUB;
      if (t0 >= T) break;
      const TX* rs = reinterpret_cast<const TX*>(st + L.r) + sc * SUB * KMAX;
      const TX* ks = reinterpret_cast<const TX*>(st + L.k) + sc * SUB * KMAX;
      const TW* ws = reinterpret_cast<const TW*>(st + L.w) + sc * SUB * KMAX;
      const TX* vs = reinterpret_cast<const TX*>(st + L.v) + sc * SUB * tn;

      // (1) thread (g, i) takes row i and tokens 4g..4g+3: p_t = p_{t-1} +
      // logw_t over the whole sub-chunk in token order (every thread holds
      // the same bits of p), in log2 units from here on; r, k and v in
      // fp32; r e^{p_{t-1}} (transposed), k e^{p_last - p_t}, e^{p_last}
      for (int e = tid; e < SUB / 4 * KMAX; e += NT) {
        const int i = e % KMAX, g = e / KMAX;
        float lw[SUB];
#pragma unroll
        for (int t = 0; t < SUB; ++t) lw[t] = to_f(ws[t * KMAX + i]);
        float p = 0.0f, prev = 0.0f, mine[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int t = 0; t < SUB; ++t) {
          if (t == 4 * g) prev = p;
          p += lw[t];
          if (t / 4 == g) mine[t % 4] = p;
        }
        const float pl = p * LOG2E;
        float pv = prev * LOG2E;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int t = 4 * g + a;
          const float pp = mine[a] * LOG2E;
          const float rv = to_f(rs[t * KMAX + i]), kv = to_f(ks[t * KMAX + i]);
          P2[t * KMAX + i] = pp;
          r32[t * KMAX + i] = rv;
          k32[t * KMAX + i] = kv;
          qT[i * QS + t] = rv * ex2(pv);
          kh_s[t * KMAX + i] = kv * ex2(pl - pp);
          pv = pp;
        }
        if (g == 0) dec_s[i] = ex2(pl);
      }
      for (int e = tid; e < SUB * tn; e += NT)
        v32[e / tn * sp + e % tn] = to_f(vs[e]);
      __syncthreads();

      // (2) A[t][s], s <= t, in blocks of 4 tokens x 4 tokens: warps 0-5
      // take the six blocks below the diagonal, warps 6 and 7 two diagonal
      // blocks each; a lane takes rows lane, lane + 32 of K, so a block's
      // operands are 16 loads a lane and row, and the 16 partial sums are
      // reduce-scattered over the warp in 16 shuffles (a fixed order, the
      // same bits in both lanes that end with a sum)
#pragma unroll 1
      for (int task = 0; task < (warp < 6 ? 1 : 2); ++task) {
        int tb, sb;
        if (warp < 6) {  // (1,0) (2,0) (2,1) (3,0) (3,1) (3,2)
          tb = warp < 1 ? 1 : warp < 3 ? 2 : 3;
          sb = warp - (tb * (tb - 1)) / 2;
        } else {
          tb = sb = 2 * (warp - 6) + task;
        }
        float x[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) x[q] = 0.0f;
#pragma unroll
        for (int el = 0; el < EPL; ++el) {
          const int i = lane + 32 * el;
          const bool on = i < KMAX;
          float rv[4], pv[4], kv[4], sv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int t = 4 * tb + a, s2 = 4 * sb + a;
            rv[a] = on ? r32[t * KMAX + i] : 0.0f;
            pv[a] = on && t > 0 ? P2[(t - 1) * KMAX + i] : 0.0f;
            kv[a] = on ? k32[s2 * KMAX + i] : 0.0f;
            sv[a] = on ? P2[s2 * KMAX + i] : 0.0f;
          }
          const float uu = on ? u_s[i] : 0.0f;
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if (tb != sb || c < a)
                x[4 * a + c] = fmaf(rv[a] * kv[c], ex2(pv[a] - sv[c]),
                                    x[4 * a + c]);
              else if (c == a)
                x[4 * a + c] = fmaf(rv[a] * uu, kv[a], x[4 * a + c]);
            }
        }
        // reduce-scatter: lane keeps sum x[8 b4 + 4 b3 + 2 b2 + b1]
        rs_level<8, 16>(x, lane);
        rs_level<4, 8>(x, lane);
        rs_level<2, 4>(x, lane);
        rs_level<1, 2>(x, lane);
        x[0] += __shfl_xor_sync(FULL, x[0], 1);
        if ((lane & 1) == 0) {
          const int jx = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                         ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
          A_s[(4 * sb + jx % 4) * QS + 4 * tb + jx / 4] = x[0];
        }
      }
      __syncthreads();

      // (3) o: a tile of tokens 2tp, 2tp + 1 x columns 4cq .. 4cq + 3 takes
      // KS lanes of a warp, lane g the rows g, g + KS, ... of K and the
      // tokens s = g, g + KS, ... of A v; the 8 sums are reduce-scattered
      // over the KS lanes, and each lane puts what it ends with in the
      // chunk's o in shared memory
      {
        constexpr int KS = 32 / ncq;  // 256 threads over 8 x ncq tiles
        const int tile_i = tid / KS, g = tid % KS;
        const int tp = tile_i / ncq, cq = tile_i % ncq, t = 2 * tp;
        const float* Sc = S_s + cur * KMAX * sp + 4 * cq;
        float x[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) x[q] = 0.0f;
#pragma unroll
        for (int m = 0; m < SUB / KS; ++m) {
          const int s = g + m * KS;
          if (s > t + 1) break;
          const float2 a = *reinterpret_cast<const float2*>(A_s + s * QS + t);
          const float4 vv = lds4(v32 + s * sp + 4 * cq);
          x[0] = fmaf(a.x, vv.x, x[0]);
          x[1] = fmaf(a.x, vv.y, x[1]);
          x[2] = fmaf(a.x, vv.z, x[2]);
          x[3] = fmaf(a.x, vv.w, x[3]);
          x[4] = fmaf(a.y, vv.x, x[4]);
          x[5] = fmaf(a.y, vv.y, x[5]);
          x[6] = fmaf(a.y, vv.z, x[6]);
          x[7] = fmaf(a.y, vv.w, x[7]);
        }
#pragma unroll
        for (int m = 0; m < KMAX / KS; ++m) {
          const int i = g + m * KS;
          const float2 q = *reinterpret_cast<const float2*>(qT + i * QS + t);
          const float4 sv = lds4(Sc + i * sp);
          x[0] = fmaf(q.x, sv.x, x[0]);
          x[1] = fmaf(q.x, sv.y, x[1]);
          x[2] = fmaf(q.x, sv.z, x[2]);
          x[3] = fmaf(q.x, sv.w, x[3]);
          x[4] = fmaf(q.y, sv.x, x[4]);
          x[5] = fmaf(q.y, sv.y, x[5]);
          x[6] = fmaf(q.y, sv.z, x[6]);
          x[7] = fmaf(q.y, sv.w, x[7]);
        }
        // lane g ends with the sums x[idx + e], e < 8 / KS
        if constexpr (KS == 8) {
          rs_level<4, 4>(x, lane);
          rs_level<2, 2>(x, lane);
          rs_level<1, 1>(x, lane);
        } else if constexpr (KS == 4) {
          rs_level<4, 2>(x, lane);
          rs_level<2, 1>(x, lane);
        } else {
          rs_level<4, 1>(x, lane);
        }
        const int idx = 8 / KS * g;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e < 8 / KS) {
            const int tt = t + (idx + e) / 4, jc = 4 * cq + (idx + e) % 4;
            store(o_s + (sc * SUB + tt) * tn + jc, x[e]);
          }
        }
      }

      // (4) the state at the sub-chunk's end, into the other copy of S
      if (tid < NQT) {
        float* Sn = S_s + (cur ^ 1) * KMAX * sp;
        const int i0 = tid / ncq, jq = (tid % ncq) * 4;
#pragma unroll
        for (int m = 0; m < SQ; ++m) {
          const float d = dec_s[i0 + m * (KMAX / SQ)];
          S[m].x *= d;
          S[m].y *= d;
          S[m].z *= d;
          S[m].w *= d;
        }
#pragma unroll
        for (int s = 0; s < SUB; ++s) {
          const float4 vv = lds4(v32 + s * sp + jq);
#pragma unroll
          for (int m = 0; m < SQ; ++m) {
            const float kv = kh_s[s * KMAX + i0 + m * (KMAX / SQ)];
            S[m].x = fmaf(kv, vv.x, S[m].x);
            S[m].y = fmaf(kv, vv.y, S[m].y);
            S[m].z = fmaf(kv, vv.z, S[m].z);
            S[m].w = fmaf(kv, vv.w, S[m].w);
          }
        }
#pragma unroll
        for (int m = 0; m < SQ; ++m)
          *reinterpret_cast<float4*>(Sn + (i0 + m * (KMAX / SQ)) * sp + jq) =
              S[m];
      }
      cur ^= 1;
      __syncthreads();  // S_s[cur], the sub-chunk's buffers and the stage
    }
    // the chunk's o, staged in shared memory, in 16-byte stores where the
    // rows allow (fewer, wider stores than one element a lane)
    const int c0 = ch * CHUNK;
    if (async) {
      constexpr int EX = 16 / sizeof(TX);
      const int pv = tn / EX;
#pragma unroll 1
      for (int e = tid; e < CHUNK * pv; e += NT) {
        const int row = e / pv, pc = e - row * pv;
        if (c0 + row < T && j0 + pc * EX < V)
          *reinterpret_cast<uint4*>(ob + (size_t)(c0 + row) * o_t + pc * EX) =
              *reinterpret_cast<const uint4*>(o_s + row * tn + pc * EX);
      }
    } else {
#pragma unroll 1
      for (int e = tid; e < CHUNK * tn; e += NT) {
        const int row = e / tn, jc = e - row * tn;
        if (c0 + row < T && j0 + jc < V)
          ob[(size_t)(c0 + row) * o_t + jc] = o_s[row * tn + jc];
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int m = 0; m < SQ; ++m) {
    const int e = tid + m * NQT, i = e / ncq, jq = (e - i * ncq) * 4;
    if (tid < NQT && i < K)
      st4(sT + sbase + (size_t)i * V + jq, S[m], V - j0 - jq, vq);
  }
}

// one cudaFuncSetAttribute per instantiation, before its first launch
template <typename Kern>
cudaError_t raise_smem(Kern kern, size_t bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

struct Args {
  const void *r, *k, *v, *logw, *u, *s0;
  void *o, *sT;
  int B, T, H, K, V, tn, n_tiles, vec;
};

template <typename TX, typename TW, int KMAX, int TN>
cudaError_t launch_chunked(const Args& a, dim3 grid, cudaStream_t s) {
  auto kern = wkv6_chunked_kernel<TX, TW, KMAX, TN>;
  const size_t bytes = Layout<TX, TW, KMAX>(TN).total;
  static bool raised = false;
  const cudaError_t err = raise_smem(kern, bytes, raised);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, bytes, s>>>(
      static_cast<const TX*>(a.r), static_cast<const TX*>(a.k),
      static_cast<const TX*>(a.v), static_cast<const TW*>(a.logw),
      static_cast<const float*>(a.u), static_cast<const float*>(a.s0),
      static_cast<TX*>(a.o), static_cast<float*>(a.sT), a.T, a.H, a.K, a.V,
      a.n_tiles, a.vec);
  return cudaGetLastError();
}

template <typename TX, typename TW, int KMAX>
cudaError_t launch_k(const Args& a, int variant, cudaStream_t s) {
  const dim3 grid(a.B * a.H * a.n_tiles);
  const TX* r = static_cast<const TX*>(a.r);
  const TX* k = static_cast<const TX*>(a.k);
  const TX* v = static_cast<const TX*>(a.v);
  const TW* lw = static_cast<const TW*>(a.logw);
  const float* u = static_cast<const float*>(a.u);
  const float* s0 = static_cast<const float*>(a.s0);
  TX* o = static_cast<TX*>(a.o);
  float* sT = static_cast<float*>(a.sT);
  if (variant == 0) {
    const int threads = a.tn / 4 * (KMAX / 4);
    wkv6_decode_kernel<TX, TW, KMAX><<<grid, threads, 0, s>>>(
        r, k, v, lw, u, s0, o, sT, a.T, a.H, a.K, a.V, a.tn, a.n_tiles,
        a.vec);
    return cudaGetLastError();
  }
  if (a.tn == 16)
    return launch_chunked<TX, TW, KMAX, 16>(a, grid, s);
  if (a.tn == 32)
    return launch_chunked<TX, TW, KMAX, 32>(a, grid, s);
  return launch_chunked<TX, TW, KMAX, 64>(a, grid, s);
}

template <typename TX, typename TW>
cudaError_t launch_types(const Args& a, int variant, cudaStream_t s) {
  if (a.K <= 16) return launch_k<TX, TW, 16>(a, variant, s);
  if (a.K <= 32) return launch_k<TX, TW, 32>(a, variant, s);
  return launch_k<TX, TW, 64>(a, variant, s);
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// x_type (r, k, v and o) and w_type (logw): 0 = fp32, 1 = bf16.  u and the
// states are fp32; s0 may be null (a zero initial state) and may alias sT.
// variant 0 is the decode kernel, 1 the chunked kernel, whose chunk and
// sub_chunk must be this file's CHUNK and SUB; tile is the columns a block
// (16, 32 or 64), as `wkv6_geometry` picks them.  Pointers are device
// pointers to contiguous arrays, and the Python wrapper checked the shapes
// (B, T, H >= 1; 1 <= K <= 64; 1 <= V <= 1024; B * H * tiles < 2^31).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, const void* s0,
                           void* o, void* sT, int B, int T, int H, int K,
                           int V, int x_type, int w_type, int variant,
                           int tile, int chunk, int sub_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > 64 || V < 1 || V > 1024 || B < 1 || T < 1 || H < 1 ||
      (tile != 16 && tile != 32 && tile != 64) || variant < 0 ||
      variant > 1 || (variant == 1 && (chunk != CHUNK || sub_chunk != SUB)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sx = x_type == 1 ? 2 : 4, sw = w_type == 1 ? 2 : 4;
  const bool al = aligned16(r) && aligned16(k) && aligned16(v) &&
                  aligned16(logw);
  const bool quad = al && aligned16(u) && aligned16(s0) && aligned16(o) &&
                    aligned16(sT) && K % 4 == 0 && V % 4 == 0;
  const bool async = al && aligned16(o) && (K * sx) % 16 == 0 &&
                     (K * sw) % 16 == 0 && (V * sx) % 16 == 0;
  Args a{r, k, v, logw, u, s0, o, sT, B, T, H, K, V, tile,
         (V + tile - 1) / tile, (quad ? 1 : 0) | (async ? 2 : 0)};
  cudaError_t err;
  if (x_type == 0 && w_type == 0)
    err = launch_types<float, float>(a, variant, s);
  else if (x_type == 1 && w_type == 0)
    err = launch_types<__nv_bfloat16, float>(a, variant, s);
  else if (x_type == 0 && w_type == 1)
    err = launch_types<float, __nv_bfloat16>(a, variant, s);
  else if (x_type == 1 && w_type == 1)
    err = launch_types<__nv_bfloat16, __nv_bfloat16>(a, variant, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
