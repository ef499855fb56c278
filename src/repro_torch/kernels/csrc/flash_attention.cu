// GQA-native online-softmax attention, for Hopper (built for sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:92; pallas_call at :125, body
// `_attn_kernel` at :38).  It computes the same function:
//
//   o[b, t, h, :] = sum_j softmax_j(scale * q[b,t,h,:] . k[b,j,g,:]) v[b,j,g,:]
//
// over the unmasked keys j, with g = h / rep the kv head of query head h
// (rep = H / Hkv).  Masks: keys at absolute position < 0 (ring slots never
// written), causal (kpos <= qpos) and a sliding window (qpos - kpos <
// window); qpos = t + q_offset[b] and kpos = j + k_offset[b].  The offsets
// are read per batch row from a device int32 [B, 2] tensor, so decode at a
// dynamic position never recompiles and never synchronises.  The online
// softmax keeps the TPU kernel's guards: masked scores are NEG_INF, p is 0
// where masked, and l is replaced by 1 where it is 0, so a fully masked row
// gives 0.  As on the TPU, the rep query heads of a kv group are folded
// into the row axis (row r = head_in_group * Tq + t), so a K/V tile loaded
// once serves every query head of the group.
//
// Two variants, one launch a call; `flash_attention_geometry` in
// `kernels/flash_attention.py` picks the variant, the tiles and the splits.
//
// 1. Split-KV, on the CUDA cores (`attn_split_kernel`): every call with fp32
//    keys and values (the engine's decode, bf16 q over the fp32 cache), any
//    call with an fp32 q, and bf16 decode.  Decode reads the whole cache for
//    a few multiply-adds a byte, so it is bound by bytes; one block per
//    (batch, kv head) would leave most of the 132 SMs idle.  So:
//      * a grid axis over kv splits: a block owns 8 folded rows (at gemma
//        decode, the rep = 8 heads of one token: no padding rows) and one
//        chunk of keys; the geometry sizes the chunk so that a call fills
//        about one wave of the card;
//      * 8 warps, each an online softmax of its own over interleaved groups
//        of 4 keys; a lane owns 8 elements of D (q and the accumulator in
//        registers) and copies only its own 8 elements of each key and
//        value into a 3-stage cp.async ring in shared memory (16-byte
//        copies, two stages in flight, no barrier in the loop; element
//        copies where k or v rows are not 16-byte aligned); 8 warps
//        rather than 4 hide more of each step's chain of shuffles;
//      * dot products spread over the warp: each lane's 32 partials (8 rows
//        x 4 keys) are reduce-scattered in 31 shuffles, leaving one whole
//        score a lane; p and the rescale factors pass through 40 floats of
//        shared memory to the PV update, where lanes run along D;
//      * the warps are merged in a fixed order; with one split the block
//        writes o, else fp32 partials (m, l, acc) to scratch, and the last
//        block of the (batch, kv head, row block) to take its int32 ticket
//        (the per-device buffer shared with the split-K GEMMs, reset by
//        that block) combines them in split order: deterministic, no float
//        atomics.  The combine reads 16-byte chunks of eight splits at a
//        time with volatile loads, which the compiler cannot sink to their
//        use: with plain loads it served them about one at a time.  A
//        split that the masks leave empty still takes
//        its ticket and writes m = NEG_INF, l = 0, which adds exactly 0.
// 2. Tensor cores, for bf16 q, k and v in prefill (`attn_mma_kernel`): long
//    causal prefill is bound by its multiply-adds.  A block takes 64 folded
//    rows (16 rows a warp, FlashAttention-2's split of Q) on 8 warps in two
//    groups of 4 that take alternate key tiles, each with its own online
//    softmax and K/V ring, and merge (m, l, O) through shared memory at the
//    end in group order.  S = Q K^T and O += P V run on mma.sync m16n8k16
//    bf16 with fp32 sums (a bf16 product is exact in fp32, so S differs
//    from the fp32 dot of the widened operands only in summation order);
//    scale and masks are applied to the S fragment in fp32, masks only on
//    tiles that need them; P is rounded to bf16 in registers for PV, which
//    moves o by at most 2^-8 sum(p |v|) / l <= 2^-8 max|v| (bf16's unit
//    roundoff) and in practice by about 2^-8 sqrt(sum(p^2 v^2)) / l, as
//    the errors of the p cancel; l sums the unrounded p
//    (`mma_error_limit` in kernels/flash_attention.py states the bound
//    that the checks hold the variant to).  Q, K and V are staged by cp.async into shared memory
//    swizzled in 16-byte chunks (chunk c of row r at c ^ (r & 7)) and read
//    by ldmatrix (.trans for V); a group's next K tile loads during its
//    QK^T and softmax and its next V tile during PV, each waited for on its
//    own at a barrier of the group's 128 threads.  Tiles past the causal
//    edge or before the window are skipped.  Causal blocks differ in work
//    by up to 32x at T = 2048: the heaviest are launched first, and one
//    block of 8 warps keeps its SM as busy as two blocks of 4 did, so the
//    block with the most keys does not run at half speed once its
//    neighbour is done.  At head_dim 256 the O accumulator is 128 fp32
//    registers a thread: Q stays in shared memory, the key tile is 32 wide
//    (64 was slower), and ptxas must show no spill.
// Left for later: wgmma and TMA loads, warp specialisation, a persistent
// schedule; lane groups for head_dim < 256 in the split variant (a lane
// owns 8 elements of D, so D = 64 uses 8 lanes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.44269504088896341f;
constexpr int DMAX = 256;        // largest head_dim
constexpr unsigned FULL = 0xFFFFFFFFu;

// an offset: `val` for every batch row (kind 0), or element b * step of an
// int32 (kind 1) or int64 (kind 2) device array
struct Offset {
  const void* ptr;
  int val, kind, step;
};

struct Params {
  Offset qo, ko;                // q_offset, k_offset
  int B, Tq, Tk, H, Hkv, D, rep, rows, causal, window;  // window <= 0: none
  float scale;
  long long q_sb, q_st, q_sh;   // element strides of q [B, Tq, H, D]
  long long k_sb, k_st, k_sh;   // of k [B, Tk, Hkv, D]
  long long v_sb, v_st, v_sh;   // of v
  int n_rb, splits, kps, vec;   // row blocks, kv splits, keys a split
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}
__device__ __forceinline__ void zero(float& x) { x = 0.0f; }
__device__ __forceinline__ void zero(__nv_bfloat16& x) {
  x = __float2bfloat16(0.0f);
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
// an L2 load of 16 bytes that the compiler keeps in program order
__device__ __forceinline__ float4 ldcg4(const float4* p) {
  float4 r;
  asm volatile("ld.global.cg.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
               : "l"(p));
  return r;
}
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

__device__ __forceinline__ int offset_of(const Offset& o, int b) {
  if (o.kind == 1) return static_cast<const int*>(o.ptr)[b * o.step];
  if (o.kind == 2)
    return (int)static_cast<const long long*>(o.ptr)[b * o.step];
  return o.val;
}

// The keys [lo, hi) that some row of the folded rows [r0, r1) may see, and
// the rows' least and greatest absolute positions.
__device__ __forceinline__ void key_range(const Params& p, int r0, int r1,
                                          int q_off, int k_off, long long& lo,
                                          long long& hi, long long& qmin,
                                          long long& qmax) {
  int tmin = 0, tmax = p.Tq - 1;
  if (r1 - r0 < p.Tq) {
    const int t0 = r0 % p.Tq, t1 = (r1 - 1) % p.Tq;
    if (t0 <= t1) { tmin = t0; tmax = t1; }
  }
  qmin = (long long)tmin + q_off;
  qmax = (long long)tmax + q_off;
  lo = k_off < 0 ? -(long long)k_off : 0;
  hi = p.Tk;
  if (p.window > 0 && qmin - p.window + 1 - k_off > lo)
    lo = qmin - p.window + 1 - k_off;
  if (p.causal && qmax - k_off + 1 < hi) hi = qmax - k_off + 1;
}

__device__ __forceinline__ bool key_ok(const Params& p, long long qpos,
                                       long long kpos) {
  bool ok = kpos >= 0;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && qpos - kpos < p.window;
  return ok;
}

// ---------------------------------------------------------------------------
// 1. split-KV on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int SK_WARPS = 8;
constexpr int SK_NT = 32 * SK_WARPS;
constexpr int SK_ROWS = 8;                    // folded rows a block
constexpr int SK_KEYS = 4;                    // keys a warp a stage
constexpr int SK_STAGE = SK_WARPS * SK_KEYS;  // keys a block a stage (32)
constexpr int SK_RING = 3;
constexpr int SK_PAIRS = SK_ROWS * SK_KEYS;   // 32: one score a lane
constexpr int MAX_SPLITS = 64;
constexpr int SK_XCH = 48;                    // floats a warp: p[32], alpha[8]
constexpr int SK_UNROLL = 8;                  // splits a round of the combine

// ring: [warp][stage][key][k, v][DMAX elements]; lane l owns 8 l .. 8 l + 7
template <typename TKV>
__host__ __device__ constexpr int sk_ring_bytes() {
  return SK_WARPS * SK_RING * SK_KEYS * 2 * DMAX * (int)sizeof(TKV);
}
// after the loop the ring is reused for the merge:
constexpr int SK_CACC = 0;                                       // [W][R][DMAX]
constexpr int SK_CM = SK_CACC + SK_WARPS * SK_ROWS * DMAX;       // [W][R]
constexpr int SK_CL = SK_CM + SK_WARPS * SK_ROWS;                // [W][R]
constexpr int SK_WGT = SK_CL + SK_WARPS * SK_ROWS;               // [S][R]
constexpr int SK_ROWM = SK_WGT + MAX_SPLITS * SK_ROWS;           // [R]
constexpr int SK_ROWL = SK_ROWM + SK_ROWS;                       // [R]
constexpr int SK_PM = SK_ROWL + SK_ROWS;                         // [S][R]
constexpr int SK_PL = SK_PM + MAX_SPLITS * SK_ROWS;              // [S][R]
constexpr int SK_FLAG = SK_PL + MAX_SPLITS * SK_ROWS;            // int
constexpr int SK_MERGE_BYTES = (SK_FLAG + 4) * 4;
static_assert(SK_MERGE_BYTES <= SK_WARPS * SK_RING * SK_KEYS * 2 * DMAX * 2,
              "the merge must fit in the bf16 ring");

template <typename TKV>
__host__ __device__ constexpr size_t sk_smem_bytes() {
  return (size_t)sk_ring_bytes<TKV>() + SK_WARPS * SK_XCH * 4;
}

// one lane's 8 elements of a key or value row into its ring slot, zero
// past D and for keys outside the block's range
template <typename TKV>
__device__ __forceinline__ void copy8(TKV* dst, const TKV* __restrict__ row,
                                      const TKV* __restrict__ base, int d0,
                                      int D, bool ok, bool vec) {
  constexpr int E = 16 / (int)sizeof(TKV);  // elements a 16-byte copy
  if (vec) {
#pragma unroll
    for (int c = 0; c < 8 / E; ++c) {
      const int d = d0 + c * E;
      const int n = ok ? min(max(D - d, 0), E) : 0;
      cp_async16(dst + c * E, n > 0 ? row + d : base, n * (int)sizeof(TKV));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (ok && d0 + e < D)
        dst[e] = row[d0 + e];
      else
        zero(dst[e]);
    }
  }
}

__device__ __forceinline__ void load8(const float* s, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* s, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(s);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// One step of a reduce-scatter over the warp: N values a lane become N / 2,
// lanes with bit N / 2 set keeping the upper half.  After the steps for
// N = 32 .. 2, v[0] of lane l is the warp's sum of value l.
template <int N>
__device__ __forceinline__ void rs_step(float* v, int lane) {
  constexpr int HALF = N / 2;
  const bool up = (lane & HALF) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, HALF);
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(SK_NT)
attn_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                  const TKV* __restrict__ v, TQ* __restrict__ o,
                  float* __restrict__ part, int* __restrict__ tickets,
                  Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rb = blockIdx.x, split = blockIdx.y, bg = blockIdx.z;
  const int b = bg / p.Hkv, g = bg - b * p.Hkv;
  const int q_off = offset_of(p.qo, b), k_off = offset_of(p.ko, b);
  const int r0 = rb * SK_ROWS;
  long long lo, hi, qmin, qmax;
  key_range(p, r0, min(r0 + SK_ROWS, p.rows), q_off, k_off, lo, hi, qmin,
            qmax);
  const long long c0 = (long long)split * p.kps;
  const long long kstart = lo > c0 ? lo : c0;
  long long kend = c0 + p.kps < p.Tk ? c0 + p.kps : p.Tk;
  if (hi < kend) kend = hi;
  const int n_st =
      kend > kstart ? (int)((kend - kstart + SK_STAGE - 1) / SK_STAGE) : 0;

  // this lane's 8 elements of the block's rows, scaled as on the TPU
  const int d0 = lane * 8;
  float qr[SK_ROWS][8];
#pragma unroll
  for (int i = 0; i < SK_ROWS; ++i) {
    const int r = r0 + i;
    const bool rok = r < p.rows;
    const int hg = rok ? r / p.Tq : 0, t = rok ? r - hg * p.Tq : 0;
    const TQ* row = q + b * p.q_sb + t * p.q_st + (g * p.rep + hg) * p.q_sh;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[i][e] = rok && d0 + e < p.D ? to_f(row[d0 + e]) * p.scale : 0.0f;
  }
  // the score this lane holds after the reduce-scatter: row i_own, key j_own
  const int i_own = lane / SK_KEYS, j_own = lane % SK_KEYS;
  const bool row_ok = r0 + i_own < p.rows;
  const long long qpos = (long long)((r0 + i_own) % p.Tq) + q_off;

  TKV* ring = reinterpret_cast<TKV*>(smem) +
              warp * (SK_RING * SK_KEYS * 2 * DMAX) + d0;
  float* xch = reinterpret_cast<float*>(smem + sk_ring_bytes<TKV>()) +
               warp * SK_XCH;
  const TKV* kb = k + b * p.k_sb + g * p.k_sh;
  const TKV* vb = v + b * p.v_sb + g * p.v_sh;
  auto fetch = [&](int s) {
    TKV* slot = ring + (s % SK_RING) * (SK_KEYS * 2 * DMAX);
#pragma unroll
    for (int j = 0; j < SK_KEYS; ++j) {
      const long long kidx =
          kstart + (long long)s * SK_STAGE + warp * SK_KEYS + j;
      const bool ok = kidx < kend;
      const long long kr = ok ? kidx : 0;
      copy8(slot + (2 * j) * DMAX, kb + kr * p.k_st, k, d0, p.D, ok, p.vec);
      copy8(slot + (2 * j + 1) * DMAX, vb + kr * p.v_st, v, d0, p.D, ok,
            p.vec);
    }
  };

  float m_own = NEG_INF, l_own = 0.0f;   // of row i_own, same on its 4 lanes
  float acc[SK_ROWS][8];
#pragma unroll
  for (int i = 0; i < SK_ROWS; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.0f;

  if (n_st > 0) fetch(0);
  cp_async_commit();
  if (n_st > 1) fetch(1);
  cp_async_commit();
  for (int s = 0; s < n_st; ++s) {
    if (s + 2 < n_st) fetch(s + 2);  // the slot this lane read at step s - 1
    cp_async_commit();
    cp_async_wait<2>();              // this lane's copies of step s landed
    const TKV* slot = ring + (s % SK_RING) * (SK_KEYS * 2 * DMAX);

    float sp[SK_PAIRS];              // partial score of (row i, key j)
#pragma unroll
    for (int j = 0; j < SK_KEYS; ++j) {
      float kx[8];
      load8(slot + (2 * j) * DMAX, kx);
#pragma unroll
      for (int i = 0; i < SK_ROWS; ++i) {
        float a = qr[i][0] * kx[0];
#pragma unroll
        for (int e = 1; e < 8; ++e) a = fmaf(qr[i][e], kx[e], a);
        sp[i * SK_KEYS + j] = a;
      }
    }
    rs_step<32>(sp, lane);
    rs_step<16>(sp, lane);
    rs_step<8>(sp, lane);
    rs_step<4>(sp, lane);
    rs_step<2>(sp, lane);

    const long long kidx =
        kstart + (long long)s * SK_STAGE + warp * SK_KEYS + j_own;
    const bool ok = row_ok && kidx < kend && key_ok(p, qpos, kidx + k_off);
    const float sc = ok ? sp[0] : NEG_INF;
    float mx = fmaxf(sc, __shfl_xor_sync(FULL, sc, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    const float m_new = fmaxf(m_own, mx);
    const float pr = ok ? expf(sc - m_new) : 0.0f;
    const float alpha = expf(m_own - m_new);
    float psum = pr + __shfl_xor_sync(FULL, pr, 1);
    psum += __shfl_xor_sync(FULL, psum, 2);
    l_own = alpha * l_own + psum;
    m_own = m_new;

    __syncwarp();                    // the last step's reads of xch are done
    xch[lane] = pr;
    if (j_own == 0) xch[SK_PAIRS + i_own] = alpha;
    __syncwarp();
    float pv[SK_ROWS][SK_KEYS], al[SK_ROWS];
#pragma unroll
    for (int i = 0; i < SK_ROWS; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(xch + i * SK_KEYS);
      pv[i][0] = t.x; pv[i][1] = t.y; pv[i][2] = t.z; pv[i][3] = t.w;
      al[i] = xch[SK_PAIRS + i];
    }
#pragma unroll
    for (int i = 0; i < SK_ROWS; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= al[i];
#pragma unroll
    for (int j = 0; j < SK_KEYS; ++j) {
      float vx[8];
      load8(slot + (2 * j + 1) * DMAX, vx);
#pragma unroll
      for (int i = 0; i < SK_ROWS; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(pv[i][j], vx[e], acc[i][e]);
    }
  }
  cp_async_wait<0>();

  // merge the warps in order: M = max m_w, L = sum e^(m_w - M) l_w, ...
  __syncthreads();                   // every warp is done with its ring
  float* sm = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < SK_ROWS; ++i) {
    float* c = sm + SK_CACC + (warp * SK_ROWS + i) * DMAX + d0;
    *reinterpret_cast<float4*>(c) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(c + 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (j_own == 0) {
    sm[SK_CM + warp * SK_ROWS + i_own] = m_own;
    sm[SK_CL + warp * SK_ROWS + i_own] = l_own;
  }
  __syncthreads();
  if (tid < SK_ROWS) {
    float M = sm[SK_CM + tid];
#pragma unroll
    for (int w = 1; w < SK_WARPS; ++w) M = fmaxf(M, sm[SK_CM + w * SK_ROWS + tid]);
    float L = 0.0f;
#pragma unroll
    for (int w = 0; w < SK_WARPS; ++w) {
      const float a = expf(sm[SK_CM + w * SK_ROWS + tid] - M);
      sm[SK_WGT + w * SK_ROWS + tid] = a;
      L = w == 0 ? a * sm[SK_CL + tid] : fmaf(a, sm[SK_CL + w * SK_ROWS + tid], L);
    }
    sm[SK_ROWM + tid] = M;
    sm[SK_ROWL + tid] = L;
  }
  __syncthreads();

  // this thread's chunks of 4 values: row ci / (DMAX / 4), column 4 (ci %
  // (DMAX / 4)) with ci = tid + c * SK_NT
  constexpr int CH = SK_ROWS * DMAX / 4 / SK_NT;
  float4 val[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int ci = tid + c * SK_NT, i = ci / (DMAX / 4);
    const float* src = sm + SK_CACC + i * DMAX + (ci % (DMAX / 4)) * 4;
    float4 a = *reinterpret_cast<const float4*>(src);
    const float w0 = sm[SK_WGT + i];
    a = make_float4(w0 * a.x, w0 * a.y, w0 * a.z, w0 * a.w);
#pragma unroll
    for (int w = 1; w < SK_WARPS; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(src + w * SK_ROWS * DMAX);
      const float ww = sm[SK_WGT + w * SK_ROWS + i];
      a = make_float4(fmaf(ww, x.x, a.x), fmaf(ww, x.y, a.y),
                      fmaf(ww, x.z, a.z), fmaf(ww, x.w, a.w));
    }
    val[c] = a;
  }

  const int tiles = gridDim.z * p.n_rb;
  const int tile = bg * p.n_rb + rb;
  if (p.splits > 1) {
    // this split's partials, [split][tile][row][DMAX] and [split][tile][row]
    // x (m, l); the last split of the tile to finish merges them
    float* pacc = part + ((size_t)split * tiles + tile) * SK_ROWS * DMAX;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int ci = tid + c * SK_NT;
      if ((ci % (DMAX / 4)) * 4 < p.D)
        reinterpret_cast<float4*>(pacc)[ci] = val[c];
    }
    float* pml = part + (size_t)p.splits * tiles * SK_ROWS * DMAX;
    if (tid < SK_ROWS) {
      const size_t at = (((size_t)split * tiles + tile) * SK_ROWS + tid) * 2;
      pml[at] = sm[SK_ROWM + tid];
      pml[at + 1] = sm[SK_ROWL + tid];
    }
    __syncthreads();                 // partials stored
    int* is_last = reinterpret_cast<int*>(sm + SK_FLAG);
    if (tid == 0) {
      fence_acq_rel_gpu();           // the block's partials, then
      *is_last = atomicAdd(tickets + tile, 1) == p.splits - 1;  // its ticket
      if (*is_last) {
        tickets[tile] = 0;           // ready for the next launch
        fence_acq_rel_gpu();         // the other splits' partials
      }
    }
    __syncthreads();
    if (!*is_last) return;
    for (int x = tid; x < p.splits * SK_ROWS; x += SK_NT) {
      const size_t at = ((size_t)(x / SK_ROWS) * tiles + tile) * SK_ROWS +
                        x % SK_ROWS;
      sm[SK_PM + x] = __ldcg(pml + 2 * at);
      sm[SK_PL + x] = __ldcg(pml + 2 * at + 1);
    }
    __syncthreads();
    if (tid < SK_ROWS) {
      float M = sm[SK_PM + tid];
      for (int s = 1; s < p.splits; ++s) M = fmaxf(M, sm[SK_PM + s * SK_ROWS + tid]);
      float L = 0.0f;
      for (int s = 0; s < p.splits; ++s) {
        const float a = expf(sm[SK_PM + s * SK_ROWS + tid] - M);
        sm[SK_WGT + s * SK_ROWS + tid] = a;
        L = s == 0 ? a * sm[SK_PL + tid]
                   : fmaf(a, sm[SK_PL + s * SK_ROWS + tid], L);
      }
      sm[SK_ROWL + tid] = L;
    }
    __syncthreads();
    // acc = sum_s w_s acc_s in split order; the loads of SK_UNROLL splits
    // are sent together (volatile loads stay in program order) before
    // their sums, so they are in flight at once
    const float4* pall = reinterpret_cast<const float4*>(
        part + (size_t)tile * SK_ROWS * DMAX);
    const size_t plane = (size_t)tiles * SK_ROWS * DMAX / 4;   // float4s
    for (int s0 = 0; s0 < p.splits; s0 += SK_UNROLL) {
      float4 x[SK_UNROLL][CH];
#pragma unroll
      for (int u = 0; u < SK_UNROLL; ++u)
#pragma unroll
        for (int c = 0; c < CH; ++c)
          x[u][c] = ldcg4(pall + min(s0 + u, p.splits - 1) * plane + tid +
                          c * SK_NT);
#pragma unroll
      for (int u = 0; u < SK_UNROLL; ++u) {
        if (s0 + u >= p.splits) break;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float w = sm[SK_WGT + (s0 + u) * SK_ROWS +
                             (tid + c * SK_NT) / (DMAX / 4)];
          const float4 y = x[u][c];
          val[c] = s0 + u == 0
                       ? make_float4(w * y.x, w * y.y, w * y.z, w * y.w)
                       : make_float4(fmaf(w, y.x, val[c].x),
                                     fmaf(w, y.y, val[c].y),
                                     fmaf(w, y.z, val[c].z),
                                     fmaf(w, y.w, val[c].w));
        }
      }
    }
  }

  // o = acc / l, with l = 1 where it is 0 (a fully masked row gives 0)
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int ci = tid + c * SK_NT, i = ci / (DMAX / 4);
    const int d = (ci % (DMAX / 4)) * 4, r = r0 + i;
    if (r >= p.rows || d >= p.D) continue;
    const float L = sm[SK_ROWL + i], den = L > 0.0f ? L : 1.0f;
    const int hg = r / p.Tq;
    TQ* orow = o + (((long long)b * p.Tq + (r - hg * p.Tq)) * p.H +
                    g * p.rep + hg) * p.D + d;
    const float v4[4] = {val[c].x, val[c].y, val[c].z, val[c].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < p.D) store(orow + e, v4[e] / den);
  }
}

// ---------------------------------------------------------------------------
// 2. bf16 tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int MM_NT = 256;    // 8 warps: two groups of 4
constexpr int MM_ROWS = 64;   // folded rows a block, 16 a warp of a group

template <int DP>
struct MmaTile {
  static constexpr int BN = DP == 256 ? 32 : 64;   // keys a tile
  static constexpr int RB = DP * 2;                // bytes a row
  static constexpr int CPR = DP / 8;               // 16-byte chunks a row
  static constexpr int Q_BYTES = MM_ROWS * RB;
  static constexpr int T_BYTES = BN * RB;
  static constexpr int G_BYTES = 4 * T_BYTES;      // a group's 2 K, 2 V
  static constexpr int SMEM = Q_BYTES + 2 * G_BYTES;
  static_assert(MM_ROWS * DP * 4 <= G_BYTES, "group 1's O must fit its ring");
};

// byte offset of 16-byte chunk c of row r in a swizzled tile of RB-byte rows
template <int RB>
__device__ __forceinline__ int sw(int r, int c) {
  return r * RB + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
// d += a * b, m16n8k16, bf16 operands, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the 128 threads of key group grp meet (named barrier 1 + grp)
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + grp) : "memory");
}

template <int DP>
__global__ void __launch_bounds__(MM_NT, 1)
attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, Params p) {
  using T = MmaTile<DP>;
  constexpr int BN = T::BN, RB = T::RB, CPR = T::CPR;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // key group: the block's key tiles alternate between groups 0 and 1; the
  // 4 warps of a group take 16 of the 64 rows each
  const int grp = warp >> 2, wg = warp & 3, gtid = tid & 127;
  unsigned char* ks = smem + T::Q_BYTES + grp * T::G_BYTES;
  unsigned char* vs = ks + 2 * T::T_BYTES;
  // Work order, heaviest first: with Tq % 64 == 0 row block rb is t-block
  // tb of head hg (rb = hg * ntb + tb), ordered by tb descending; else rb
  // descending.  The scheduler hands the next block to the first free SM.
  const int nbg = p.B * p.Hkv;
  const int bg = blockIdx.x % nbg, u = blockIdx.x / nbg;
  int rb = p.n_rb - 1 - u;
  if (p.Tq % MM_ROWS == 0) {
    const int ntb = p.Tq / MM_ROWS;
    rb = (u % p.rep) * ntb + ntb - 1 - u / p.rep;
  }
  const int b = bg / p.Hkv, g = bg - b * p.Hkv;
  const int q_off = offset_of(p.qo, b), k_off = offset_of(p.ko, b);
  const int r0 = rb * MM_ROWS;
  long long lo, hi, qmin, qmax;
  key_range(p, r0, min(r0 + MM_ROWS, p.rows), q_off, k_off, lo, hi, qmin,
            qmax);

  for (int c = tid; c < MM_ROWS * CPR; c += MM_NT) {
    const int row = c / CPR, ch = c % CPR, r = r0 + row;
    const bool ok = r < p.rows && ch * 8 < p.D;
    const __nv_bfloat16* src = q;
    if (ok) {
      const int hg = r / p.Tq;
      src = q + b * p.q_sb + (r - hg * p.Tq) * p.q_st +
            (g * p.rep + hg) * p.q_sh + ch * 8;
    }
    cp_async16(qs + sw<RB>(row, ch), src, ok ? 16 : 0);
  }
  cp_async_commit();
  const __nv_bfloat16* kb = k + b * p.k_sb + g * p.k_sh;
  const __nv_bfloat16* vb = v + b * p.v_sb + g * p.v_sh;
  // one tile of K (kv = 0) or V (kv = 1) into this group's buffer buf
  auto load_tile = [&](int kt, int buf, int kv) {
    const __nv_bfloat16* src = kv ? vb : kb;
    const long long st = kv ? p.v_st : p.k_st;
    unsigned char* dst = (kv ? vs : ks) + buf * T::T_BYTES;
    for (int c = gtid; c < BN * CPR; c += 128) {
      const int row = c / CPR, ch = c % CPR, kidx = kt * BN + row;
      const bool ok = kidx < p.Tk && ch * 8 < p.D;
      cp_async16(dst + sw<RB>(row, ch), ok ? src + kidx * st + ch * 8 : k,
                 ok ? 16 : 0);
    }
  };
  const int t_lo = (int)(lo / BN);
  const int t_hi = hi > lo ? (int)((hi + BN - 1) / BN) : t_lo;
  const int t0 = t_lo + grp;                        // this group's tiles:
  const int n_my = t0 < t_hi ? (t_hi - t0 + 1) / 2 : 0;  // t0, t0 + 2, ...
  if (n_my > 0) load_tile(t0, 0, 0);
  cp_async_commit();
  if (n_my > 0) load_tile(t0, 0, 1);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();     // Q landed, every thread's share of it

  // accumulator rows of this thread: gq and gq + 8 of its warp's 16
  const int gq = lane >> 2, tq = lane & 3;
  const int orow = wg * 16 + gq;
  const long long qp0 = (long long)((r0 + orow) % p.Tq) + q_off;
  const long long qp1 = (long long)((r0 + orow + 8) % p.Tq) + q_off;
  float oacc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  // ldmatrix lane roles: Q rows (l & 15) at chunk l >> 4; K rows (l & 7) +
  // 8 (l >> 4) at chunk (l >> 3) & 1; V rows (l & 7) + 8 ((l >> 3) & 1) at
  // chunk l >> 4.  Tile rows 16 apart share the swizzle.
  const uint32_t qa = smem_addr(qs), ka = smem_addr(ks), va = smem_addr(vs);
  const int a_row = wg * 16 + (lane & 15), a_ch = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_ch = (lane >> 3) & 1;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_ch = lane >> 4;

  // groups in flight at the top of step i: K and V of tile t0 + 2 i
  for (int i = 0; i < n_my; ++i) {
    const int kt = t0 + 2 * i, buf = i & 1;
    cp_async_wait<1>();
    group_sync(grp);   // K of kt landed; K of the step before is read
    if (i + 1 < n_my) load_tile(kt + 2, buf ^ 1, 0);
    cp_async_commit();

    float sacc[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.0f;
    const uint32_t kt_a = ka + buf * T::T_BYTES;
    const uint32_t vt_a = va + buf * T::T_BYTES;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qa + sw<RB>(a_row, 2 * kk + a_ch));
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t bb[4];
        ldmatrix_x4(bb, kt_a + sw<RB>(np * 16 + b_row, 2 * kk + b_ch));
        mma_bf16(sacc[2 * np], a, bb[0], bb[1]);
        mma_bf16(sacc[2 * np + 1], a, bb[2], bb[3]);
      }
    }

    // scale in fp32; masks only where some (row, key) of the tile is masked
    const int kb0 = kt * BN;
    const long long kp0 = (long long)kb0 + k_off;
    const bool full = kb0 + BN <= p.Tk && kp0 >= 0 &&
                      (!p.causal || kp0 + BN - 1 <= qmin) &&
                      (p.window <= 0 || qmax - kp0 < p.window);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sacc[n][e] * p.scale;
        if (!full) {
          const int kidx = kb0 + n * 8 + 2 * tq + (e & 1);
          if (!(kidx < p.Tk && key_ok(p, e < 2 ? qp0 : qp1,
                                      (long long)kidx + k_off)))
            s = NEG_INF;
        }
        sacc[n][e] = s;
      }

    // online softmax on rows gq (values 0, 1) and gq + 8 (values 2, 3)
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sacc[n][0], sacc[n][1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[n][2], sacc[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row masked so far keeps m = NEG_INF: its p and alpha must be 0
    const float ref0 = mn0 == NEG_INF ? 0.0f : mn0;
    const float ref1 = mn1 == NEG_INF ? 0.0f : mn1;
    const float al0 = exp2f((m0 - ref0) * LOG2E);
    const float al1 = exp2f((m1 - ref1) * LOG2E);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.0f, rs1 = 0.0f;
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const float p0 = exp2f((sacc[n][0] - ref0) * LOG2E);
      const float p1 = exp2f((sacc[n][1] - ref0) * LOG2E);
      const float p2 = exp2f((sacc[n][2] - ref1) * LOG2E);
      const float p3 = exp2f((sacc[n][3] - ref1) * LOG2E);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = al0 * l0 + rs0;
    l1 = al1 * l1 + rs1;
    cp_async_wait<1>();
    group_sync(grp);   // V of kt landed; V of the step before is read
    if (i + 1 < n_my) load_tile(kt + 2, buf ^ 1, 1);
    cp_async_commit();
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      oacc[n][0] *= al0;
      oacc[n][1] *= al0;
      oacc[n][2] *= al1;
      oacc[n][3] *= al1;
    }
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t vv[4];
        ldmatrix_x4_trans(vv, vt_a + sw<RB>(kc * 16 + v_row, 2 * np + v_ch));
        mma_bf16(oacc[2 * np], pa[kc], vv[0], vv[1]);
        mma_bf16(oacc[2 * np + 1], pa[kc], vv[2], vv[3]);
      }
  }
  cp_async_wait<0>();
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  __syncthreads();     // both groups are done with their rings

  // group 1 hands (m, l, O) over in shared memory: O in its own ring, fp32
  // [64][DP]; (m, l) in group 0's ring.  Group 0 merges in group order,
  // M = max m, w = e^(m - M): o = (w0 O0 + w1 O1) / (w0 l0 + w1 l1), with
  // the sum replaced by 1 where it is 0 (a fully masked row gives 0)
  float* xo = reinterpret_cast<float*>(smem + T::Q_BYTES + T::G_BYTES);
  float* xml = reinterpret_cast<float*>(smem + T::Q_BYTES);
  if (grp == 1) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      *reinterpret_cast<float2*>(xo + orow * DP + n * 8 + 2 * tq) =
          make_float2(oacc[n][0], oacc[n][1]);
      *reinterpret_cast<float2*>(xo + (orow + 8) * DP + n * 8 + 2 * tq) =
          make_float2(oacc[n][2], oacc[n][3]);
    }
    if (tq == 0) {
      xml[orow * 2] = m0;
      xml[orow * 2 + 1] = l0;
      xml[(orow + 8) * 2] = m1;
      xml[(orow + 8) * 2 + 1] = l1;
    }
  }
  __syncthreads();
  if (grp == 1) return;
  const float mb0 = xml[orow * 2], lb0 = xml[orow * 2 + 1];
  const float mb1 = xml[(orow + 8) * 2], lb1 = xml[(orow + 8) * 2 + 1];
  const float M0 = fmaxf(m0, mb0), M1 = fmaxf(m1, mb1);
  const float wa0 = exp2f((m0 - M0) * LOG2E), wb0 = exp2f((mb0 - M0) * LOG2E);
  const float wa1 = exp2f((m1 - M1) * LOG2E), wb1 = exp2f((mb1 - M1) * LOG2E);
  const float L0 = fmaf(wb0, lb0, wa0 * l0), L1 = fmaf(wb1, lb1, wa1 * l1);
  const float d0 = L0 > 0.0f ? L0 : 1.0f, d1 = L1 > 0.0f ? L1 : 1.0f;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const float2 x0 =
        *reinterpret_cast<const float2*>(xo + orow * DP + n * 8 + 2 * tq);
    const float2 x1 = *reinterpret_cast<const float2*>(
        xo + (orow + 8) * DP + n * 8 + 2 * tq);
    oacc[n][0] = fmaf(wb0, x0.x, wa0 * oacc[n][0]);
    oacc[n][1] = fmaf(wb0, x0.y, wa0 * oacc[n][1]);
    oacc[n][2] = fmaf(wb1, x1.x, wa1 * oacc[n][2]);
    oacc[n][3] = fmaf(wb1, x1.y, wa1 * oacc[n][3]);
  }

  // o through this warp's 16 rows of the Q tile, out in 16-byte stores
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    *reinterpret_cast<uint32_t*>(qs + sw<RB>(orow, n) + tq * 4) =
        pack_bf16(oacc[n][0] / d0, oacc[n][1] / d0);
    *reinterpret_cast<uint32_t*>(qs + sw<RB>(orow + 8, n) + tq * 4) =
        pack_bf16(oacc[n][2] / d1, oacc[n][3] / d1);
  }
  __syncwarp();
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int row = wg * 16 + c / CPR, ch = c % CPR, r = r0 + row;
    if (r >= p.rows || ch * 8 >= p.D) continue;
    const int hg = r / p.Tq;
    *reinterpret_cast<uint4*>(
        o + (((long long)b * p.Tq + (r - hg * p.Tq)) * p.H + g * p.rep + hg) *
                p.D + ch * 8) =
        *reinterpret_cast<const uint4*>(qs + sw<RB>(row, ch));
  }
}

// one cudaFuncSetAttribute per instantiation, before its first launch
template <typename K>
cudaError_t raise_smem(K kern, size_t bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

template <typename TQ, typename TKV>
cudaError_t launch_split(const void* q, const void* k, const void* v, void* o,
                         float* part, int* tickets, const Params& p,
                         cudaStream_t s) {
  auto kern = attn_split_kernel<TQ, TKV>;
  const size_t bytes = sk_smem_bytes<TKV>();
  static bool raised = false;
  cudaError_t err = raise_smem(kern, bytes, raised);
  if (err != cudaSuccess) return err;
  dim3 grid(p.n_rb, p.splits, p.B * p.Hkv);
  kern<<<grid, SK_NT, bytes, s>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(o), part, tickets, p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       const Params& p, cudaStream_t s) {
  auto kern = attn_mma_kernel<DP>;
  const size_t bytes = MmaTile<DP>::SMEM;
  static bool raised = false;
  cudaError_t err = raise_smem(kern, bytes, raised);
  if (err != cudaSuccess) return err;
  dim3 grid(p.n_rb * p.B * p.Hkv);
  kern<<<grid, MM_NT, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      p);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns a cudaError_t; 0 means launched.
// q_type / kv_type: 0 = fp32, 1 = bf16 (the output has q's type).  o is
// contiguous [B, Tq, H, D]; q, k and v have unit stride along D and the
// element strides given.  Each offset is a value for every batch row
// (kind 0) or read at b * step from an int32 (kind 1) or int64 (kind 2)
// device array.  window <= 0 means no window.  variant 0 is split-KV (n_rb
// blocks of 8 folded rows, `splits` chunks of `kps` keys; with splits > 1,
// part is fp32 scratch of splits * B * Hkv * n_rb * 8 * (256 + 2) floats
// and tickets holds one zeroed int32 per (batch, kv head, row block), left
// zeroed; vec: k and v rows are 16-byte aligned), variant 1 the bf16
// tensor-core kernel (n_rb blocks of 64 folded rows; bf16 q, k, v, 16-byte
// aligned rows, D a multiple of 16).  Shapes were checked by the Python
// wrapper (D <= 256, H = rep * Hkv, B * Hkv <= 65535).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    const void* q_off_ptr, const void* k_off_ptr, void* part, void* tickets,
    int q_off_val, int q_off_kind, int q_off_step, int k_off_val,
    int k_off_kind, int k_off_step, int B, int Tq, int Tk, int H, int Hkv,
    int D, int causal, int window, float scale, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    int q_type, int kv_type, int variant, int n_rb, int splits, int kps,
    int vec, void* stream) {
  Params p;
  p.qo = Offset{q_off_ptr, q_off_val, q_off_kind, q_off_step};
  p.ko = Offset{k_off_ptr, k_off_val, k_off_kind, k_off_step};
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H; p.Hkv = Hkv; p.D = D;
  p.rep = H / Hkv; p.rows = p.rep * Tq; p.causal = causal; p.window = window;
  p.scale = scale;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.n_rb = n_rb; p.splits = splits; p.kps = kps; p.vec = vec;
  if (D < 1 || D > DMAX || n_rb < 1 || splits < 1 || splits > MAX_SPLITS ||
      (splits > 1 && (part == nullptr || tickets == nullptr)) ||
      q_off_kind < 0 || q_off_kind > 2 || k_off_kind < 0 || k_off_kind > 2 ||
      (q_off_kind != 0 && q_off_ptr == nullptr) ||
      (k_off_kind != 0 && k_off_ptr == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  int* tp = static_cast<int*>(tickets);
  cudaError_t err;
  if (variant == 1) {
    if (q_type != 1 || kv_type != 1 || D % 16 != 0 || splits != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    err = D <= 64    ? launch_mma<64>(q, k, v, o, p, s)
          : D <= 128 ? launch_mma<128>(q, k, v, o, p, s)
                     : launch_mma<256>(q, k, v, o, p, s);
  } else if (variant != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (q_type == 0 && kv_type == 0) {
    err = launch_split<float, float>(q, k, v, o, pp, tp, p, s);
  } else if (q_type == 1 && kv_type == 1) {
    err = launch_split<__nv_bfloat16, __nv_bfloat16>(q, k, v, o, pp, tp, p,
                                                      s);
  } else if (q_type == 1 && kv_type == 0) {
    err = launch_split<__nv_bfloat16, float>(q, k, v, o, pp, tp, p, s);
  } else if (q_type == 0 && kv_type == 1) {
    err = launch_split<float, __nv_bfloat16>(q, k, v, o, pp, tp, p, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
