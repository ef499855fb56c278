// Matmul against packed 6-bit(+sign) base-sqrt(2) log codes, for Hopper
// (built for sm_90a).
//
// Replaces the TPU kernel `log_matmul_pallas`
// (src/repro/kernels/log_matmul.py:73; pallas_call at :95, body
// `_log_matmul_kernel` at :49).  It computes the same function:
//
//   y[m, n] = scale[n] * sum_k x[m, k] * dec(codes[k, n])
//
// x is fp32 or bf16 [M, K], codes int8 [K, N], scale fp32 [N]; the sum is
// taken in fp32 and y is written as fp32 or bf16.  dec() is eq. (8) of the
// paper, sign * LUT[c & 1] * 2^(c >> 1) with the LUT {1, sqrt(2)}: the
// kernel writes the IEEE bits of that product directly, so every code
// decodes exactly, bit for bit with `decode_codes`.  Ragged M, K and N are
// handled by bounds checks (codes outside the matrix read as the zero
// code), never by padded copies.
//
// What bounds it on this card: the LM dense layers it serves run at small
// M (decode: one row per engine slot), where each code byte is used for M
// multiply-adds.  That is far below the H100's ridge point, so the limit
// is the bytes of codes read from device memory; the decode arithmetic
// (about ten integer operations a code) comes next.  The design:
//   * a block owns BN = 32 output columns and BM rows (4, or 8 when M > 4)
//     and walks the whole K: no sum crosses blocks;
//   * each thread loads 16 codes of one row as one 16-byte load, two
//     threads cover a 32-byte row segment, and 128 k-lanes stride over K;
//     each thread keeps UNROLL such loads in flight;
//   * the BM x (K chunk) slice of x is staged in shared memory as fp32;
//   * the 128 k-lanes' partial sums are reduced with warp shuffles and a
//     small shared-memory pass, and the per-column scale multiplies the
//     sum in the epilogue.
// Left for later: split-K across blocks (N = 256 gives only 8 blocks),
// tensor cores (wgmma) for large M, TMA loads into a ring of stages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                  // threads per block
constexpr int COLS = 16;                 // columns per thread (16 bytes)
constexpr int BN = 32;                   // columns per block
constexpr int CG = BN / COLS;            // column groups per block (2)
constexpr int KL = NT / CG;              // k-lanes per block (128)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's cast
}

// eq. (8), exact: the IEEE bits of LUT[c & (steps-1)] * 2^(c >> frac_bits)
// with c = biased - (2^bits - 1) in [-(2^bits - 2), 0].  For bits <= 7 the
// exponent stays >= -126, so no value is subnormal.  Biased code 0 is the
// zero code and decodes to +0.0.
__device__ __forceinline__ float decode(uint32_t p, int bits, int frac_bits) {
  const int mask = (1 << bits) - 1;
  const int biased = (int)p & mask;
  const int code = biased - mask;
  const int e = code >> frac_bits;       // arithmetic shift: floor
  const int base = (frac_bits == 1 && (code & 1)) ? 0x3FB504F3   // sqrt(2)
                                                  : 0x3F800000;  // 1.0
  const uint32_t b = (uint32_t)(base + e * (1 << 23)) |
                     (((p >> bits) & 1u) << 31);
  return biased ? __uint_as_float(b) : 0.0f;
}

// 16 codes of row k starting at column n0, as four little-endian words.
template <bool VEC>
__device__ __forceinline__ uint4 load_codes(const int8_t* __restrict__ w,
                                            int k, int n0, int K, int N) {
  uint4 c = make_uint4(0u, 0u, 0u, 0u);
  if (k >= K || n0 >= N) return c;
  const int8_t* row = w + (size_t)k * N + n0;
  if (VEC) {  // N % 16 == 0 and a 16-byte aligned base: one load
    return __ldg(reinterpret_cast<const uint4*>(row));
  }
  uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < COLS; ++j)
    if (n0 + j < N)
      words[j >> 2] |= (uint32_t)(uint8_t)__ldg(row + j) << (8 * (j & 3));
  return make_uint4(words[0], words[1], words[2], words[3]);
}

template <typename TX, typename TY, int BM, int UNROLL, bool VEC>
__global__ void __launch_bounds__(NT)
log_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, TY* __restrict__ y,
                  int M, int K, int N, int bits, int frac_bits) {
  constexpr int KCH = KL * UNROLL;       // rows of K per x chunk
  __shared__ float xs[BM][KCH];
  __shared__ float red[NT / 32][BM][BN];

  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int kl = tid / CG;
  const int n0 = blockIdx.x * BN + cg * COLS;
  const int m0 = blockIdx.y * BM;

  float acc[BM][COLS];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[m][j] = 0.0f;

  for (int kc = 0; kc < K; kc += KCH) {
    for (int i = tid; i < BM * KCH; i += NT) {
      const int m = i / KCH;
      const int k = i - m * KCH;
      float v = 0.0f;
      if (m0 + m < M && kc + k < K) v = to_f(x[(size_t)(m0 + m) * K + kc + k]);
      xs[m][k] = v;
    }
    uint4 c[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      c[u] = load_codes<VEC>(w, kc + kl + u * KL, n0, K, N);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int kk = kl + u * KL;
      float xv[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) xv[m] = xs[m][kk];
      const uint32_t words[4] = {c[u].x, c[u].y, c[u].z, c[u].w};
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float d =
            decode((words[j >> 2] >> (8 * (j & 3))) & 0xFFu, bits, frac_bits);
#pragma unroll
        for (int m = 0; m < BM; ++m) acc[m][j] = fmaf(xv[m], d, acc[m][j]);
      }
    }
    __syncthreads();
  }

  // reduce over the k-lanes: within a warp, lanes of one column group
  // differ in the lane bits above the lowest, then across the eight warps
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int off = CG; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
      acc[m][j] = v;
    }
  if (lane < CG) {
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < COLS; ++j) red[warp][m][lane * COLS + j] = acc[m][j];
  }
  __syncthreads();
  for (int i = tid; i < BM * BN; i += NT) {
    const int m = i / BN;
    const int nn = i - m * BN;
    const int n = blockIdx.x * BN + nn;
    if (m0 + m >= M || n >= N) continue;
    float s = 0.0f;
#pragma unroll
    for (int wi = 0; wi < NT / 32; ++wi) s += red[wi][m][nn];
    store(y + (size_t)(m0 + m) * N + n, s * scale[n]);
  }
}

template <typename TX, typename TY, int BM, int UNROLL>
cudaError_t launch_bm(const void* x, const void* w, const void* scale, void* y,
                      int M, int K, int N, int bits, int frac_bits, bool vec,
                      cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const TX* xp = static_cast<const TX*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  TY* yp = static_cast<TY*>(y);
  if (vec)
    log_matmul_kernel<TX, TY, BM, UNROLL, true>
        <<<grid, NT, 0, s>>>(xp, wp, sp, yp, M, K, N, bits, frac_bits);
  else
    log_matmul_kernel<TX, TY, BM, UNROLL, false>
        <<<grid, NT, 0, s>>>(xp, wp, sp, yp, M, K, N, bits, frac_bits);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t launch_types(const void* x, const void* w, const void* scale,
                         void* y, int M, int K, int N, int bits, int frac_bits,
                         bool vec, cudaStream_t s) {
  if (M <= 4)
    return launch_bm<TX, TY, 4, 8>(x, w, scale, y, M, K, N, bits, frac_bits,
                                   vec, s);
  return launch_bm<TX, TY, 8, 4>(x, w, scale, y, M, K, N, bits, frac_bits,
                                 vec, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// x_type / y_type: 0 = fp32, 1 = bf16.  Pointers are device pointers and
// shapes were checked by the Python wrapper (contiguous row-major x, codes
// and y; M, K, N >= 1).
extern "C" int log_matmul_launch(const void* x, const void* w,
                                 const void* scale, void* y, int M, int K,
                                 int N, int bits, int frac_bits, int x_type,
                                 int y_type, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (N % COLS == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  cudaError_t err;
  if (x_type == 0 && y_type == 0)
    err = launch_types<float, float>(x, w, scale, y, M, K, N, bits, frac_bits,
                                     vec, s);
  else if (x_type == 1 && y_type == 1)
    err = launch_types<__nv_bfloat16, __nv_bfloat16>(x, w, scale, y, M, K, N,
                                                     bits, frac_bits, vec, s);
  else if (x_type == 1 && y_type == 0)
    err = launch_types<__nv_bfloat16, float>(x, w, scale, y, M, K, N, bits,
                                             frac_bits, vec, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
