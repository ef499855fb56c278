// Log requantization of an activation map, for Hopper (built for sm_90a):
// the paper's post-processing block (ReLU, then the base-sqrt(2) log
// requantization before the map is written back), and the same
// requantization of a signed map without the ReLU (RELU = false).
//
// Replaces no TPU kernel: the JAX package's `relu_q`
// (src/repro/models/cnn.py:86) is plain jnp, which XLA fuses.  In plain
// torch the same function is some 39 kernels a call, each reading and
// writing the whole map.  This source does it in two.  For x [R, C] (an
// NHWC map, channels last and contiguous, R = B*H*W rows):
//
//   v = max(x, 0);  s[c] = max_r v[r, c];  scale = s > 0 ? s : 1
//   code = clamp(rint(log2(max(v / scale, 1e-38)) * steps), code_min, 0)
//   y = v == 0 ? 0 : exp2(code / steps) * scale
//
// which is `log_quantize` then `log_dequantize` (core/logquant.py) on
// relu(x), operation for operation in the same order: a true division,
// log2f, rintf (round half to even, as torch.round), exp2f, one product.
// The build takes no --use_fast_math, so each of them is the IEEE-rounded
// function torch's own kernels call, and y equals the plain ops on the card
// bit for bit.  code / steps is an exact product by 1 / steps (a power of
// two), as torch computes a division by a Python number.
//
// Signed (RELU = false), for maps that carry negative values (after a
// LayerNorm, a GELU, a residual add): v = |x| in place of max(x, 0), and y
// takes x's sign, -(exp2(code / steps) * scale) for x < 0.  That is
// `log_quantize` then `log_dequantize` of x itself: torch forms
// (sign * mag) * scale, and a negation is exact, so the two agree bit for
// bit as well; a -0.0 input gives +0.0 and the zero code in both.  Each
// pass is a template on RELU, so the ReLU instances compile as before.
//
// What bounds it on this card: bytes.  A map is read twice (the max, then
// the quantize pass) and written once, 12 bytes an element; a few tens of
// floating-point operations an element stay below the H100's ridge.  The
// design, by what it buys:
//   * two launches a call, no memset: the per-channel maxima gather in a
//     [C] int32 workspace that starts at zero, and the quantize pass leaves
//     it at zero again (its last block to start, counted on a ticket after
//     every block has read its scales), so the next call finds it ready;
//   * an exact max in any order: every value is >= +0, so a signed atomicMax
//     on the float bits orders them as floats; -0.0 (0x80000000) sorts below
//     +0.  The signed max takes |x|, whose bits are >= +0 too.  A block
//     folds its threads' maxima in shared memory first, then writes C
//     atomics to the workspace;
//   * 16-byte loads: where C % 4 == 0 and x is 16-byte aligned a thread
//     reads 4 channels at once (VEC = 4), else one;
//   * fixed channels a thread: the grid-stride step is a whole number of
//     rows' vectors, so a thread keeps the same channels (and scales, in
//     registers) over its whole walk; threads past the last whole row's
//     worth stay idle;
//   * loads in flight: each thread starts UNROLL vector loads before it uses
//     any of them, at four resident blocks of 256 threads an SM (the
//     wrapper's grid: four blocks an SM at most, one wave).
// Measured on an H100 80GB HBM3: the max pass reads at ~2.1 TB/s (torch's
// per-channel amax of the same map: 1.8); the quantize pass is held back
// by its arithmetic (a true division, log2f and exp2f an element): with a
// trivial body it moves 2.9 TB/s.  Unrolling
// by 2 or 8, six or eight resident blocks, loads of the next step started
// before the current one's arithmetic, and a walk by adjacent whole rows
// all read the same or slower.
// The optional codes output writes the packed int8 codes ((sign << bits) |
// biased code; the sign is set only on a signed map's x < 0) beside y.
//
// NaN inputs are not matched: fmaxf drops a NaN where torch keeps it.  A workspace shared by two streams at once would race: the port's
// callers run on one stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads a block
constexpr int MIN_BLOCKS = 4; // blocks an SM: at most 64 registers a thread
constexpr int UNROLL = 4;     // vector loads in flight a thread
constexpr int MAX_C = 12288;  // the max pass's 4 bytes a channel in 48 KB

struct Quant {
  float steps, inv_steps, code_min;
  int bias;
};

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&a)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    a[0] = t.x; a[1] = t.y; a[2] = t.z; a[3] = t.w;
  } else {
    a[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p,
                                      const float (&a)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  else
    *p = a[0];
}

template <int V>
__device__ __forceinline__ void store_codes(int8_t* __restrict__ p,
                                            const int (&b)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<char4*>(p) = make_char4(
        static_cast<signed char>(b[0]), static_cast<signed char>(b[1]),
        static_cast<signed char>(b[2]), static_cast<signed char>(b[3]));
  else
    *p = static_cast<int8_t>(b[0]);
}

// one element of max(x, 0) -> the value written back; code: its clamped code
__device__ __forceinline__ float requant(float v, float scale, const Quant& q,
                                         float& code) {
  code = rintf(log2f(fmaxf(v / scale, 1e-38f)) * q.steps);
  code = fminf(fmaxf(code, q.code_min), 0.0f);
  return v == 0.0f ? 0.0f : exp2f(code * q.inv_steps) * scale;
}

// one vector of x -> y (and its packed codes, biased, 0 for an exact zero;
// signed, with the sign bit above them for x < 0)
template <int V, bool RELU>
__device__ __forceinline__ void requant_vector(const float (&a)[V],
                                               const float (&sc)[V],
                                               const Quant& q, float* y,
                                               int8_t* codes) {
  float v[V], o[V], code[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    v[j] = RELU ? fmaxf(a[j], 0.0f) : fabsf(a[j]);
    o[j] = requant(v[j], sc[j], q, code[j]);
    if (!RELU && a[j] < 0.0f) o[j] = -o[j];
  }
  store<V>(y, o);
  if (codes != nullptr) {
    int b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      b[j] = v[j] == 0.0f ? 0 : static_cast<int>(code[j]) + q.bias;
      if (!RELU && a[j] < 0.0f) b[j] |= q.bias + 1;  // the sign, 1 << bits
    }
    store_codes<V>(codes, b);
  }
}

// the walk over x's vectors shared by both passes: the step, a whole number
// of rows, and whether this thread takes part
struct Walk {
  long long total, step, i;
  int c0;
  __device__ Walk(long long rows, int cv, int V) {
    total = rows * cv;
    const long long threads = static_cast<long long>(gridDim.x) * NT;
    step = threads - threads % cv;
    i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
    c0 = static_cast<int>(i % cv) * V;
  }
  __device__ bool active() const { return i < step; }
};

template <int V, bool RELU>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    requant_max(const float* __restrict__ x, int* __restrict__ smax,
                long long rows, int C) {
  extern __shared__ int part[];
  for (int c = threadIdx.x; c < C; c += NT) part[c] = 0;
  __syncthreads();
  Walk w(rows, C / V, V);
  if (w.active()) {
    float m[V];
#pragma unroll
    for (int j = 0; j < V; ++j) m[j] = 0.0f;
    long long i = w.i;
    for (; i + (UNROLL - 1) * w.step < w.total; i += UNROLL * w.step) {
      float a[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) load<V>(x + (i + u * w.step) * V, a[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j)
          m[j] = fmaxf(m[j], RELU ? a[u][j] : fabsf(a[u][j]));
    }
    for (; i < w.total; i += w.step) {
      float a[V];
      load<V>(x + i * V, a);
#pragma unroll
      for (int j = 0; j < V; ++j)
        m[j] = fmaxf(m[j], RELU ? a[j] : fabsf(a[j]));
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      atomicMax(part + w.c0 + j, __float_as_int(m[j]));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    const int p = part[c];
    if (p > 0) atomicMax(smax + c, p);
  }
}

template <int V, bool RELU>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    requant_quantize(const float* __restrict__ x, int* __restrict__ smax,
                     unsigned int* __restrict__ ticket, float* __restrict__ y,
                     int8_t* __restrict__ codes, long long rows, int C,
                     Quant q) {
  __shared__ int is_last;
  Walk w(rows, C / V, V);
  float sc[V];
  if (w.active()) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float s = __int_as_float(smax[w.c0 + j]);
      sc[j] = s > 0.0f ? s : 1.0f;
    }
  }
  // every block has read its scales before the last one zeroes them
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (is_last) {
      *ticket = 0;
      __threadfence();
    }
  }
  __syncthreads();
  if (is_last)
    for (int c = threadIdx.x; c < C; c += NT) smax[c] = 0;
  if (!w.active()) return;

  long long i = w.i;
  for (; i + (UNROLL - 1) * w.step < w.total; i += UNROLL * w.step) {
    float a[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) load<V>(x + (i + u * w.step) * V, a[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long e = (i + u * w.step) * V;
      requant_vector<V, RELU>(a[u], sc, q, y + e,
                        codes != nullptr ? codes + e : nullptr);
    }
  }
  for (; i < w.total; i += w.step) {
    float a[V];
    load<V>(x + i * V, a);
    requant_vector<V, RELU>(a, sc, q, y + i * V,
                      codes != nullptr ? codes + i * V : nullptr);
  }
}

template <int V, bool RELU>
cudaError_t launch(const float* x, float* y, int8_t* codes, int* smax,
                   unsigned int* ticket, long long rows, int C, int blocks,
                   const Quant& q, cudaStream_t s) {
  requant_max<V, RELU><<<blocks, NT, C * sizeof(int), s>>>(x, smax, rows, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  requant_quantize<V, RELU><<<blocks, NT, 0, s>>>(x, smax, ticket, y, codes,
                                                  rows, C, q);
  return cudaGetLastError();
}

}  // namespace

// x, y: float32 [rows, C], contiguous; codes: int8 [rows, C] or null;
// work: int32 [1 + C] (the ticket, then C maxima), zero on entry and left
// zero.  vec: 4 (C % 4 == 0, x and y 16-byte aligned) or 1.  blocks: the
// grid of both passes, at least ceil(C / vec / 256).  C <= MAX_C.  relu: 1
// quantizes max(x, 0), 0 the signed x.  Returns the cudaError of the
// launches.
extern "C" int log_requant_launch(const void* x, void* y, void* codes,
                                  void* work, long long rows, int C, int bits,
                                  int frac_bits, int vec, int blocks, int relu,
                                  void* stream) {
  if (rows < 1 || C < 1 || C > MAX_C || bits < 1 || bits > 7 ||
      frac_bits < 0 || frac_bits > 4 || (vec != 1 && vec != 4) ||
      C % vec != 0 || static_cast<long long>(blocks) * NT < C / vec)
    return static_cast<int>(cudaErrorInvalidValue);
  const int steps = 1 << frac_bits;
  const Quant q{static_cast<float>(steps), 1.0f / static_cast<float>(steps),
                static_cast<float>(-((1 << bits) - 2)), (1 << bits) - 1};
  unsigned int* ticket = static_cast<unsigned int*>(work);
  int* smax = static_cast<int*>(work) + 1;
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  int8_t* cp = static_cast<int8_t*>(codes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = vec == 4 ? (relu ? &launch<4, true> : &launch<4, false>)
                           : (relu ? &launch<1, true> : &launch<1, false>);
  return static_cast<int>(go(xf, yf, cp, smax, ticket, rows, C, blocks, q, s));
}
