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
// softmax keeps the TPU kernel's guards: masked scores are filled with
// NEG_INF, p is zeroed where masked, and l is replaced by 1 where it is 0,
// so a fully masked row gives 0.
//
// As on the TPU, the rep query heads of a kv group are folded into the row
// axis (row r = head_in_group * Tq + t), so each K/V tile is loaded once
// per kv head and serves every query head of the group.  A block owns BQ
// = 16 folded rows of one (batch, kv head) and walks the kv tiles of BKV =
// 32 keys in order, carrying the running max m, sum l and the fp32
// accumulator [BQ, D] across tiles (the TPU grid's sequential kv axis
// becomes a loop inside the block).  Tiles that are masked for every row
// of the block (beyond the causal edge, before the window, at positions
// < 0) are skipped; they would add exactly nothing.  q, k and v are read
// in their stored dtypes (fp32 or bf16) and converted to fp32 in shared
// memory: at head_dim 256 that is 16 KB of q, 33 KB of k (rows padded by
// one float against bank conflicts) and 32 KB of v, above the 48 KB
// default, so the kernel raises its dynamic shared-memory limit.
//
// What bounds it on this card: serving decode (one query row per slot,
// rep = 8 folded rows) reads the whole KV cache for few multiply-adds, so
// it is bound by bytes; long prefill is bound by the fp32 multiply-adds on
// the CUDA cores.  Left for later: a split over the kv axis for decode
// (one block per (batch, kv head) leaves most SMs idle), tensor cores
// (wgmma) for QK^T and PV, TMA loads of the K/V tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads per block
constexpr int BQ = 16;      // folded query rows per block
constexpr int BKV = 32;     // keys per tile (one per lane in the softmax)
constexpr int DMAX = 256;   // largest head_dim
constexpr int TPR = NT / BQ;          // threads per row in the PV update (16)
constexpr int CPT = DMAX / TPR;       // accumulator entries per thread (16)
constexpr float NEG_INF = -1e30f;

struct Params {
  int B, Tq, Tk, H, Hkv, D, rep, causal, window;  // window <= 0: none
  float scale;
  long long q_sb, q_st, q_sh;   // element strides of q [B, Tq, H, D]
  long long k_sb, k_st, k_sh;   // of k [B, Tk, Hkv, D]
  long long v_sb, v_st, v_sh;   // of v
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)BQ * D + (size_t)BKV * (D + 1) +
                          (size_t)BKV * D + (size_t)BQ * (BKV + 1) + 3 * BQ) +
         (size_t)BQ * BKV;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(NT)
attn_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
            const TKV* __restrict__ v, TQ* __restrict__ o,
            const int* __restrict__ offs, Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  float* qs = smem;                       // [BQ][D]
  float* ks = qs + BQ * D;                // [BKV][D + 1]
  float* vs = ks + BKV * (D + 1);         // [BKV][D]
  float* ps = vs + BKV * D;               // [BQ][BKV + 1]
  float* m_s = ps + BQ * (BKV + 1);       // [BQ]
  float* l_s = m_s + BQ;                  // [BQ]
  float* a_s = l_s + BQ;                  // [BQ]
  unsigned char* mk = reinterpret_cast<unsigned char*>(a_s + BQ);  // [BQ][BKV]

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BQ;
  const int g = blockIdx.y;               // kv head
  const int b = blockIdx.z;
  const int rows = p.rep * p.Tq;
  const int q_off = offs[2 * b];
  const int k_off = offs[2 * b + 1];

  // rows of the block: query head g*rep + r / Tq at position r % Tq
  long long qmin = 0x7fffffffffffLL, qmax = -0x7fffffffffffLL;
  for (int i = 0; i < BQ; ++i) {
    const int r = r0 + i;
    if (r >= rows) break;
    const long long qp = (long long)(r % p.Tq) + q_off;
    qmin = qp < qmin ? qp : qmin;
    qmax = qp > qmax ? qp : qmax;
  }

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int i = idx / D;
    const int d = idx - i * D;
    const int r = r0 + i;
    float val = 0.0f;
    if (r < rows) {
      const int head = g * p.rep + r / p.Tq;
      const int t = r % p.Tq;
      val = to_f(q[b * p.q_sb + t * p.q_st + head * p.q_sh + d]) * p.scale;
    }
    qs[idx] = val;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }

  // keys that some row of the block may see: kidx in [lo, hi)
  long long lo = 0, hi = p.Tk;
  if (-(long long)k_off > lo) lo = -(long long)k_off;
  if (p.window > 0 && qmin - p.window + 1 - k_off > lo)
    lo = qmin - p.window + 1 - k_off;
  if (p.causal && qmax - k_off + 1 < hi) hi = qmax - k_off + 1;
  const int t_lo = (int)(lo / BKV);
  const int t_hi = hi > lo ? (int)((hi + BKV - 1) / BKV) : t_lo;

  const int ar = tid / TPR;               // accumulator row of this thread
  const int ad = tid % TPR;               // its first column
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.0f;

  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int kbase = kt * BKV;
    for (int idx = tid; idx < BKV * D; idx += NT) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kidx = kbase + j;
      float kv = 0.0f, vv = 0.0f;
      if (kidx < p.Tk) {
        kv = to_f(k[b * p.k_sb + kidx * p.k_st + g * p.k_sh + d]);
        vv = to_f(v[b * p.v_sb + kidx * p.v_st + g * p.v_sh + d]);
      }
      ks[j * (D + 1) + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    // scores and masks: thread pairs (i, j), one row i per warp pass
    for (int pidx = tid; pidx < BQ * BKV; pidx += NT) {
      const int i = pidx / BKV;
      const int j = pidx - i * BKV;
      const int r = r0 + i;
      const int kidx = kbase + j;
      const long long qpos = (long long)(r % p.Tq) + q_off;
      const long long kpos = (long long)kidx + k_off;
      bool ok = r < rows && kidx < p.Tk && kpos >= 0;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
      float s = 0.0f;
      const float* qrow = qs + i * D;
      const float* krow = ks + j * (D + 1);
      for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
      ps[i * (BKV + 1) + j] = ok ? s : NEG_INF;
      mk[i * BKV + j] = ok;
    }
    __syncthreads();

    // online softmax: each warp owns BQ / 8 rows, one key per lane
    for (int i = warp; i < BQ; i += NT / 32) {
      const float s = ps[i * (BKV + 1) + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, off));
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);
      const float pv = mk[i * BKV + lane] ? expf(s - m_new) : 0.0f;
      float sum = pv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
      ps[i * (BKV + 1) + lane] = pv;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[i] = alpha;
        l_s[i] = alpha * l_s[i] + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + p @ v
    const float alpha = a_s[ar];
    const float* prow = ps + ar * (BKV + 1);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = ad + c * TPR;
      if (d < D) {
        float a = alpha * acc[c];
        float pv_sum = 0.0f;
        for (int j = 0; j < BKV; ++j) pv_sum = fmaf(prow[j], vs[j * D + d], pv_sum);
        acc[c] = a + pv_sum;
      }
    }
    __syncthreads();
  }

  const int r = r0 + ar;
  if (r < rows) {
    const int head = g * p.rep + r / p.Tq;
    const int t = r % p.Tq;
    const float l = l_s[ar] > 0.0f ? l_s[ar] : 1.0f;
    TQ* orow = o + (((long long)b * p.Tq + t) * p.H + head) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = ad + c * TPR;
      if (d < D) store(orow + d, acc[c] / l);
    }
  }
}

template <typename TQ, typename TKV>
cudaError_t launch_types(const void* q, const void* k, const void* v, void* o,
                         const int* offs, const Params& p, cudaStream_t s) {
  auto kern = attn_kernel<TQ, TKV>;
  const size_t bytes = smem_bytes(p.D);
  static bool raised = false;  // one attribute call per instantiation
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(DMAX));
    if (err != cudaSuccess) return err;
    raised = true;
  }
  dim3 grid((p.rep * p.Tq + BQ - 1) / BQ, p.Hkv, p.B);
  kern<<<grid, NT, bytes, s>>>(static_cast<const TQ*>(q),
                               static_cast<const TKV*>(k),
                               static_cast<const TKV*>(v), static_cast<TQ*>(o),
                               offs, p);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns a cudaError_t; 0 means launched.
// q_type / kv_type: 0 = fp32, 1 = bf16 (the output has q's type).  o is
// contiguous [B, Tq, H, D]; q, k and v have unit stride along D and the
// element strides given; offs is a contiguous int32 [B, 2] of (q_offset,
// k_offset) per batch row.  window <= 0 means no window.  Shapes were
// checked by the Python wrapper (D <= 256, H = rep * Hkv).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, const void* offs,
    int B, int Tq, int Tk, int H, int Hkv, int D, int causal, int window,
    float scale, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, int q_type, int kv_type, void* stream) {
  Params p;
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H; p.Hkv = Hkv; p.D = D;
  p.rep = H / Hkv; p.causal = causal; p.window = window; p.scale = scale;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  if (D < 1 || D > DMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* op = static_cast<const int*>(offs);
  cudaError_t err;
  if (q_type == 0 && kv_type == 0)
    err = launch_types<float, float>(q, k, v, o, op, p, s);
  else if (q_type == 1 && kv_type == 1)
    err = launch_types<__nv_bfloat16, __nv_bfloat16>(q, k, v, o, op, p, s);
  else if (q_type == 1 && kv_type == 0)
    err = launch_types<__nv_bfloat16, float>(q, k, v, o, op, p, s);
  else if (q_type == 0 && kv_type == 1)
    err = launch_types<float, __nv_bfloat16>(q, k, v, o, op, p, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
