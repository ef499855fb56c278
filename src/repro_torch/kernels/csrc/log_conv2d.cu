// NHWC conv2d against packed 6-bit(+sign) base-sqrt(2) log codes, for
// Hopper (built for sm_90a).
//
// Replaces the TPU kernel `log_conv2d_fused_pallas`
// (src/repro/kernels/log_conv2d.py:385; pallas_call at :491, body
// `_fused_kernel` at :342).  It computes the same function:
//
//   y[b,ho,wo,o] = scale[o] * sum_{kh,kw,i} x[b, ho*s+kh-ph, wo*s+kw-pw, g*cin_g+i]
//                                         * dec(code(kh,kw,i,o)),   g = o / cout_g
//
// with fp32 accumulation, any stride, SAME/VALID/explicit padding (taps
// outside the image read as zero through bounds checks, so no padded copy
// of x is made) and groups.  dec() is eq. (8) of the paper:
// sign * LUT[c & 1] * 2^(c >> 1) with the two-entry LUT {1, sqrt(2)}, done
// with ldexpf so that every code decodes exactly (exp2f is only documented
// to within 2 ulp).
//
// Codes are read as they are stored, in one of two layouts:
//   natural HWIO  [K, K, cin_g, Cout]                        (g_b = 1)
//   lane-packed   [n_sb, K*K, g_b*cin_lane, cout_g]          (g_b > 1)
// The host passes the strides of either, and the kernel forms the address
//   code(tap, i, o) = w[(g / g_b)*w_sb + (g % g_b)*w_gl + (o % cout_g)
//                       + tap*w_tap + i*w_in].
// The TPU kernel's o-major column interleave has no counterpart here:
// outputs are written in natural NHWC order.
//
// What bounds it on this card: at the shapes of the paper's four CNNs the
// dense convolutions do 2*K*K*cin_g FLOP per output value against a few
// bytes moved, far above the H100's fp32 ridge point, so the limit is
// fp32 FMA throughput on the CUDA cores.  The design keeps operands in
// shared memory and registers to feed the FMAs:
//   * dense path (cin_g > 1): an implicit GEMM, M = B*Ho*Wo output pixels,
//     N = the group's output channels, reduction over (tap, channel)
//     flattened tap-major, which is the order of the im2col reference.  A
//     block owns a 64 x 64 output tile inside one group; 256 threads each
//     hold a 4 x 4 fp32 accumulator.  Each step of 16 reduction indices
//     stages the activation patch and the decoded weights in shared memory.
//     The per-channel scale multiplies the sum in the epilogue.
//   * depthwise path (cin_g == 1): one thread per output value, K*K taps
//     of its own channel; it is bound by memory traffic, not FMAs.
// Left for later: tensor cores (wgmma on tf32 or bf16 operands), TMA loads
// into a ring of shared-memory stages with mbarriers, double buffering, a
// shared-memory tile for the depthwise path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geom {
  int B, H, W, C;           // input, NHWC
  int Ho, Wo, Cout;         // output, NHWC
  int K, stride, pad_h, pad_w;
  int cin_g, cout_g;
  int g_b, w_sb, w_gl, w_tap, w_in;  // code addressing (see above)
  int bits, frac_bits;
};

constexpr int BM = 64;    // output pixels per block
constexpr int BN = 64;    // output channels per block (within one group)
constexpr int BK = 16;    // reduction indices per shared-memory step
constexpr int NT = 256;   // threads per block
constexpr int PAD = 4;    // keeps float4 alignment, breaks bank conflicts

// eq. (8): packed code -> float, exact.  Biased code 0 is the zero code.
__device__ __forceinline__ float decode(int p, int bits, int frac_bits) {
  const int mask = (1 << bits) - 1;
  const int biased = p & mask;
  if (biased == 0) return 0.0f;
  const int code = biased - mask;  // unbiased, in [-(2^bits - 2), 0]
  const float lut = (frac_bits == 1 && (code & 1)) ? 1.41421356237309515f
                                                   : 1.0f;
  const float mag = ldexpf(lut, code >> frac_bits);
  return ((p >> bits) & 1) ? -mag : mag;
}

__device__ __forceinline__ int code_base(const Geom& g, int o) {
  const int grp = o / g.cout_g;
  return (grp / g.g_b) * g.w_sb + (grp % g.g_b) * g.w_gl +
         (o - grp * g.cout_g);
}

__global__ void __launch_bounds__(NT)
log_conv2d_dense_kernel(const float* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ scale,
                        float* __restrict__ y, Geom g) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int M = g.B * g.Ho * g.Wo;
  const int KK = g.K * g.K;
  const int R = KK * g.cin_g;           // reduction length
  const int grp = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // loaders: thread owns reduction lane kk and rows/cols ld + 16*j
  const int kk_ld = tid % BK;
  const int ld = tid / BK;              // 0..15
  const int HWC = g.H * g.W * g.C;
  const int NEG = -(1 << 29);           // pushes invalid rows out of bounds
  int a_hi[4], a_wi[4], a_off[4];
  int b_base[4];
  bool b_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + ld + 16 * j;
    if (m < M) {
      const int bb = m / (g.Ho * g.Wo);
      const int rem = m - bb * g.Ho * g.Wo;
      const int ho = rem / g.Wo;
      const int wo = rem - ho * g.Wo;
      a_hi[j] = ho * g.stride - g.pad_h;
      a_wi[j] = wo * g.stride - g.pad_w;
      a_off[j] = bb * HWC + grp * g.cin_g;
    } else {
      a_hi[j] = NEG;
      a_wi[j] = NEG;
      a_off[j] = 0;
    }
    const int n = n0 + ld + 16 * j;
    b_ok[j] = n < g.cout_g;
    b_base[j] = b_ok[j] ? code_base(g, grp * g.cout_g + n) : 0;
  }

  // compute: thread owns the 4 x 4 tile at rows ty*4.., cols tx*4..
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < R; k0 += BK) {
    const int r = k0 + kk_ld;
    const bool r_ok = r < R;
    const int tap = r / g.cin_g;
    const int ci = r - tap * g.cin_g;
    const int kh = r_ok ? tap / g.K : NEG;
    const int kw = tap - (tap / g.K) * g.K;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int hi = a_hi[j] + kh;
      const int wi = a_wi[j] + kw;
      float v = 0.0f;
      if (hi >= 0 && hi < g.H && wi >= 0 && wi < g.W)
        v = x[(long long)a_off[j] + ((long long)hi * g.W + wi) * g.C + ci];
      As[kk_ld][ld + 16 * j] = v;
      float d = 0.0f;
      if (r_ok && b_ok[j])
        d = decode(w[b_base[j] + tap * g.w_tap + ci * g.w_in], g.bits,
                   g.frac_bits);
      Bs[kk_ld][ld + 16 * j] = d;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: per-channel scale, natural NHWC store
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
    float* yrow = y + (long long)m * g.Cout + grp * g.cout_g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.cout_g) yrow[n] = acc[i][j] * scale[grp * g.cout_g + n];
    }
  }
}

__global__ void __launch_bounds__(NT)
log_conv2d_depthwise_kernel(const float* __restrict__ x,
                            const int8_t* __restrict__ w,
                            const float* __restrict__ scale,
                            float* __restrict__ y, Geom g) {
  const long long total = (long long)g.B * g.Ho * g.Wo * g.Cout;
  const long long idx = (long long)blockIdx.x * NT + threadIdx.x;
  if (idx >= total) return;
  const int o = (int)(idx % g.Cout);
  const int m = (int)(idx / g.Cout);
  const int bb = m / (g.Ho * g.Wo);
  const int rem = m - bb * g.Ho * g.Wo;
  const int ho = rem / g.Wo;
  const int wo = rem - ho * g.Wo;
  const int ch = o / g.cout_g;          // cin_g == 1: the group's channel
  const int base = code_base(g, o);
  const float* xb = x + (long long)bb * g.H * g.W * g.C + ch;
  float acc = 0.0f;
  for (int kh = 0; kh < g.K; ++kh) {
    const int hi = ho * g.stride - g.pad_h + kh;
    if (hi < 0 || hi >= g.H) continue;
    for (int kw = 0; kw < g.K; ++kw) {
      const int wi = wo * g.stride - g.pad_w + kw;
      if (wi < 0 || wi >= g.W) continue;
      const float d = decode(w[base + (kh * g.K + kw) * g.w_tap], g.bits,
                             g.frac_bits);
      acc = fmaf(xb[((long long)hi * g.W + wi) * g.C], d, acc);
    }
  }
  y[idx] = acc * scale[o];
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// Pointers are device pointers; shapes were checked by the Python wrapper.
extern "C" int log_conv2d_launch(const void* x, const void* w,
                                 const void* scale, void* y, int B, int H,
                                 int W, int C, int Ho, int Wo, int Cout,
                                 int K, int stride, int pad_h, int pad_w,
                                 int groups, int g_b, int w_sb, int w_gl,
                                 int w_tap, int w_in, int bits, int frac_bits,
                                 void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.C = C;
  g.Ho = Ho; g.Wo = Wo; g.Cout = Cout;
  g.K = K; g.stride = stride; g.pad_h = pad_h; g.pad_w = pad_w;
  g.cin_g = C / groups; g.cout_g = Cout / groups;
  g.g_b = g_b; g.w_sb = w_sb; g.w_gl = w_gl; g.w_tap = w_tap; g.w_in = w_in;
  g.bits = bits; g.frac_bits = frac_bits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* yp = static_cast<float*>(y);
  if (g.cin_g == 1) {
    const long long total = (long long)B * Ho * Wo * Cout;
    const unsigned blocks = (unsigned)((total + NT - 1) / NT);
    log_conv2d_depthwise_kernel<<<blocks, NT, 0, s>>>(xp, wp, sp, yp, g);
  } else {
    const int M = B * Ho * Wo;
    dim3 grid((M + BM - 1) / BM, (g.cout_g + BN - 1) / BN, groups);
    log_conv2d_dense_kernel<<<grid, NT, 0, s>>>(xp, wp, sp, yp, g);
  }
  return static_cast<int>(cudaGetLastError());
}
