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
// with fp32 sums, any stride, SAME/VALID/explicit padding (taps outside the
// image read as zero, so no padded copy of x is made) and groups.  dec() is
// eq. (8) of the paper: sign * LUT[c & 1] * 2^(c >> 1), LUT {1, sqrt(2)}.
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
// What bounds it on this card: the dense convolutions of the paper's four
// CNNs do 2*K*K*cin_g FLOP per output value against a few bytes moved, far
// above the ridge point, so the limit is arithmetic.  fp32 FMAs on the CUDA
// cores give at most 67 TFLOP/s; the bf16 tensor cores give 989, but bf16
// operands would round x and the sqrt(2) codes.  The design, by what it
// buys:
//   * exact operands on the tensor cores: a decoded code is s*2^e (even
//     code) or s*sqrt(2)*2^e (odd code), so dec(c) = W_e(c) + sqrt(2)*W_o(c)
//     with two planes that each hold +-2^e or 0, exact bf16 numbers.  x is
//     split into x_hi = bf16(x) and x_lo = bf16(x - x_hi) (about 2^-17
//     relative left out).  mma.sync m16n8k16 (bf16 in, fp32 sums) takes the
//     four products x_hi*W_e, x_lo*W_e into acc_e and x_hi*W_o, x_lo*W_o
//     into acc_o; the epilogue forms scale * (acc_e + fp32(sqrt(2))*acc_o).
//     With x = 1 this is fp32(sqrt(2))*2^e, the exact decode.  The planes
//     come from a table, two bf16 bit patterns a code, that the wrapper
//     builds in PyTorch (`plane_table`) and the block stages in shared
//     memory;
//   * an implicit GEMM: M = B*Ho*Wo output pixels, N = the group's output
//     channels, R = K*K*cin_g reduction indices, tap-major (the im2col
//     order).  A block of 8 warps owns a 128 x 64 tile inside one group
//     (a warp 32 x 32) and walks R in stages of 32;
//   * loads under the math: raw stages (x as fp32, codes as int8) stream
//     through a ring of 3 in shared memory, three stages ahead of the
//     tensor cores.  Where cin_g % 16 == 0 (every dense conv of the four
//     nets but the C = 3 stems) each 16-index chunk of a stage lies in one
//     tap, so a pixel's chunk is 64 contiguous bytes of x: 16-byte cp.async
//     copies, zero-filled for taps outside the image.  The codes go by
//     16-byte cp.async where the strides allow.  Other shapes gather with
//     bounds checks into the same layout;
//   * one conversion a stage: all threads split the stage's x into bf16
//     hi/lo and decode its codes into the two planes once, into a double
//     buffer of swizzled operand tiles that ldmatrix reads without bank
//     conflicts; one barrier a stage;
//   * filling 132 SMs: `log_conv2d_geometry` (kernels/log_conv2d.py) splits
//     R into shares where the tiles alone would leave SMs idle (the 7x7 and
//     14x14 layers).  Shares write fp32 partials to a scratch; the last
//     block of a tile to finish (an int32 ticket per tile, reset by that
//     block) sums them in split order, applies the scale and writes y.  No
//     float atomics: the same inputs give the same bits on every run, and a
//     conv is one launch;
//   * occupancy: 256 threads at <= 128 registers and 105 KB of shared
//     memory, two blocks an SM.
// The depthwise path (cin_g == 1, MobileNet's 13 depthwise convs) does
// 2*K*K FLOP per output value against 8 bytes of x and y, so it is bound by
// bytes; the tensor cores have nothing to do there.  Its design:
//   * a block owns a tile of th output rows x tw columns x ct channels of
//     one image (`log_conv2d_geometry` picks it, so that every MobileNet
//     conv at batch 8 launches at least one block an SM) and stages the
//     input patch it needs, halo included, in shared memory once: 16-byte
//     cp.async copies along the channels where C % 4 == 0 and cout_g == 1
//     (NHWC keeps a pixel's channels contiguous), zero-filled outside the
//     image; a bounds-checked gather otherwise (channel multiplier > 1:
//     output channel o reads input channel o / cout_g).  So each x value
//     leaves L2 about once a block, not once a tap;
//   * the block's K*K*ct codes are decoded once, into shared memory;
//   * a thread owns 4 channels (a float4) of 4 adjacent outputs along W;
//     at K = 3 (compiled in for strides 1 and 2) one patch row in
//     registers feeds every tap of that row;
//   * per output, fp32 fmaf over (kh, kw) in row-major order from 0, then
//     the scale: a zero-filled halo tap adds an exact +0, so the sums are
//     those of a loop that skips it.  No atomics, the same bits every run.
// Left for later: wgmma and TMA, a persistent schedule; for the depthwise
// path, overlapping one tile's loads with the previous tile's math.

#include <cuda_bf16.h>
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

constexpr int NT = 256;   // threads per block of the dense path
constexpr int BM = 128;   // output pixels per block
constexpr int BN = 64;    // output channels per block (within one group)
constexpr int BK = 32;    // reduction indices per stage
constexpr int RING = 3;   // raw stages in shared memory
constexpr int MAX_ENTRIES = 256;  // plane-table entries, 2^(bits+1)

// dynamic shared memory, in bytes
constexpr int RAW_A = BM * BK * 4;           // fp32 x, [BM][BK]
constexpr int RAW_B = BK * BN;               // int8 codes, [BK][BN]
constexpr int OP_A = BM * BK * 2;            // one bf16 piece, [BM][BK]
constexpr int OP_B = BK * BN * 2;            // one bf16 plane, [BK][BN]
constexpr int OFF_RAW_B = RING * RAW_A;
constexpr int OFF_OP_A = OFF_RAW_B + RING * RAW_B;  // [2 bufs][hi, lo]
constexpr int OFF_OP_B = OFF_OP_A + 2 * 2 * OP_A;   // [2 bufs][e, o]
constexpr int OFF_TAB = OFF_OP_B + 2 * 2 * OP_B;
constexpr int OFF_ROWS = OFF_TAB + MAX_ENTRIES * 4;
constexpr int SMEM = OFF_ROWS + BM * 16;            // 107520

constexpr float SQRT2 = 1.41421356237309515f;  // fp32(sqrt(2)), as the LUT

// eq. (8): packed code -> float, exact.  Biased code 0 is the zero code.
__device__ __forceinline__ float decode(int p, int bits, int frac_bits) {
  const int mask = (1 << bits) - 1;
  const int biased = p & mask;
  if (biased == 0) return 0.0f;
  const int code = biased - mask;  // unbiased, in [-(2^bits - 2), 0]
  const float lut = (frac_bits == 1 && (code & 1)) ? SQRT2 : 1.0f;
  const float mag = ldexpf(lut, code >> frac_bits);
  return ((p >> bits) & 1) ? -mag : mag;
}

__device__ __forceinline__ int code_base(const Geom& g, int o) {
  const int grp = o / g.cout_g;
  return (grp / g.g_b) * g.w_sb + (grp % g.g_b) * g.w_gl +
         (o - grp * g.cout_g);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
// ldmatrix at a shared-memory address (32 bits, one register)
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
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Operand tiles are swizzled in 16-byte chunks so that the eight rows an
// ldmatrix reads at one logical chunk fall in distinct banks:
//   A, 64-byte rows (4 chunks): chunk c of row r at c ^ ((r >> 1) & 3)
//   B, 128-byte rows (8 chunks): chunk c of row k at c ^ (k & 7)
// Rows 16 or 32 apart share the swizzle, and flipping bit 1 of a chunk
// flips bit 5 of its offset, so a thread adds and XORs constants to one
// base offset instead of keeping an offset per fragment.
__device__ __forceinline__ int a_off(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}
__device__ __forceinline__ int b_off(int k, int c) {
  return k * 128 + ((c ^ (k & 7)) << 4);
}

// (tap, channel, kh, kw) of reduction index r, tap-major
struct RIdx {
  int ci, kh, kw;
};
__device__ __forceinline__ RIdx split_r(const Geom& g, int r) {
  const int tap = r / g.cin_g;
  const int kh = tap / g.K;
  return {r - tap * g.cin_g, kh, tap - kh * g.K};
}

// One raw stage of x into a ring slot [BM][BK] fp32.  rows[i] = {offset of
// pixel (b, 0, 0) plus the group's first channel, ho*s - ph, wo*s - pw};
// rows past M carry an h that is never inside the image.
template <bool VA>
__device__ __forceinline__ void load_x(float* dst, const float* __restrict__ x,
                                       const int4* rows, const Geom& g,
                                       int r0, int R, int tid) {
  if (VA) {
    // 1024 copies of 16 bytes: row (tid >> 3) + 32 j, chunk (tid >> 2) & 1
    // of 16 indices, quarter tid & 3 of the chunk
    const int ch = (tid >> 2) & 1, q = tid & 3;
    const int r = r0 + ch * 16;
    const bool r_ok = r < R;
    const RIdx ri = split_r(g, r_ok ? r : 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = (tid >> 3) + 32 * j;
      const int4 ro = rows[row];
      const int hi = ro.y + ri.kh, wi = ro.z + ri.kw;
      const bool ok =
          r_ok && hi >= 0 && hi < g.H && wi >= 0 && wi < g.W;
      const float* src =
          ok ? x + ro.x + ((long long)hi * g.W + wi) * g.C + ri.ci + q * 4
             : x;
      cp_async16(dst + row * BK + ch * 16 + q * 4, src, ok);
    }
  } else {
    // 4096 scalar loads: reduction lane tid & 31, rows (tid >> 5) + 8 j
    const int k = tid & 31;
    const int r = r0 + k;
    const bool r_ok = r < R;
    const RIdx ri = split_r(g, r_ok ? r : 0);
#pragma unroll 1
    for (int j0 = 0; j0 < BM / 8; j0 += 4) {   // four loads in flight
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int4 ro = rows[(tid >> 5) + 8 * (j0 + j)];
        const int hi = ro.y + ri.kh, wi = ro.z + ri.kw;
        v[j] = (r_ok && hi >= 0 && hi < g.H && wi >= 0 && wi < g.W)
                   ? __ldg(x + ro.x + ((long long)hi * g.W + wi) * g.C + ri.ci)
                   : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dst[((tid >> 5) + 8 * (j0 + j)) * BK + k] = v[j];
    }
  }
}

// One raw stage of codes into a ring slot [BK][BN] bytes; the zero code
// outside [.., R) x [.., cout_g).  wg points at the group's codes, column n0.
template <bool VB>
__device__ __forceinline__ void load_w(uint8_t* dst,
                                       const int8_t* __restrict__ wg,
                                       const Geom& g, int r0, int R,
                                       int ncols, int tid) {
  if (VB) {
    // 128 copies of 16 bytes: row tid >> 2, columns 16 (tid & 3)
    if (tid < BK * BN / 16) {
      const int k = tid >> 2, c = tid & 3;
      const int r = r0 + k;
      const bool ok = r < R && c * 16 < ncols;
      const RIdx ri = split_r(g, ok ? r : 0);
      const int8_t* src =
          ok ? wg + (ri.kh * g.K + ri.kw) * g.w_tap + ri.ci * g.w_in + c * 16
             : wg;
      cp_async16(dst + k * BN + c * 16, src, ok);
    }
  } else {
    // 8 codes a thread: row tid >> 3, columns 8 (tid & 7)
    const int k = tid >> 3, n8 = (tid & 7) * 8;
    const int r = r0 + k;
    uint32_t v[2] = {0u, 0u};
    if (r < R) {
      const RIdx ri = split_r(g, r);
      const int8_t* src =
          wg + (ri.kh * g.K + ri.kw) * g.w_tap + ri.ci * g.w_in + n8;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (n8 + j < ncols)
          v[j >> 2] |= (uint32_t)(uint8_t)__ldg(src + j) << (8 * (j & 3));
    }
    *reinterpret_cast<uint2*>(dst + k * BN + n8) = make_uint2(v[0], v[1]);
  }
}

// A raw stage → bf16 operand tiles: x → (hi, lo), codes → planes (e, o).
__device__ __forceinline__ void convert(const float* ra, const uint8_t* rb,
                                        char* oa, char* ob,
                                        const uint32_t* tab, uint32_t emask,
                                        int tid) {
  // x: four float4 a thread, rows (tid >> 3) + 32 j, indices 4 (tid & 7)
  const int q = tid & 7;
  const int a0 = a_off(tid >> 3, q >> 1) + (q & 1) * 8;
  ra += (tid >> 3) * BK + q * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(ra + j * 32 * BK);
    const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
    const float2 f01 = __bfloat1622float2(h01);
    const float2 f23 = __bfloat1622float2(h23);
    const __nv_bfloat162 l01 = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
    const __nv_bfloat162 l23 = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
    const int off = a0 + j * 32 * 64;
    *reinterpret_cast<uint2*>(oa + off) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&h01),
                   *reinterpret_cast<const uint32_t*>(&h23));
    *reinterpret_cast<uint2*>(oa + OP_A + off) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&l01),
                   *reinterpret_cast<const uint32_t*>(&l23));
  }
  // codes: eight a thread, row tid >> 3, columns 8 (tid & 7); an entry is
  // (even-plane bf16) | (odd-plane bf16) << 16
  {
    const int k = tid >> 3, c = tid & 7;
    const uint2 codes = *reinterpret_cast<const uint2*>(rb + k * BN + c * 8);
    uint32_t e[4], o[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t word = p < 2 ? codes.x : codes.y;
      const int sh = (p & 1) * 16;
      const uint32_t t0 = tab[(word >> sh) & emask];
      const uint32_t t1 = tab[(word >> (sh + 8)) & emask];
      e[p] = __byte_perm(t0, t1, 0x5410);
      o[p] = __byte_perm(t0, t1, 0x7632);
    }
    const int off = b_off(k, c);
    *reinterpret_cast<uint4*>(ob + off) = make_uint4(e[0], e[1], e[2], e[3]);
    *reinterpret_cast<uint4*>(ob + OP_B + off) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// grid: (n tiles, m tiles, groups * splits); a share walks stages
// [split * sps, min(stages, (split + 1) * sps)) of BK indices
template <bool VA, bool VB>
__global__ void __launch_bounds__(NT, 2)
log_conv2d_dense_kernel(const float* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ scale,
                        const uint32_t* __restrict__ table,
                        float* __restrict__ y, float* __restrict__ part,
                        int* __restrict__ tickets, Geom g, int sps,
                        int splits) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* raw_a = reinterpret_cast<float*>(smem);
  uint8_t* raw_b = reinterpret_cast<uint8_t*>(smem + OFF_RAW_B);
  char* op_a = smem + OFF_OP_A;
  char* op_b = smem + OFF_OP_B;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + OFF_TAB);
  int4* rows = reinterpret_cast<int4*>(smem + OFF_ROWS);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;   // warp tile: 32 rows x 32 cols
  const int M = g.B * g.Ho * g.Wo;
  const int R = g.K * g.K * g.cin_g;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int grp = blockIdx.z / splits;
  const int split = blockIdx.z - grp * splits;
  const int stages = (R + BK - 1) / BK;
  const int st0 = split * sps;
  const int nst = min(stages, st0 + sps) - st0;   // >= 1
  const int ncols = min(BN, g.cout_g - n0);
  const int8_t* wg = w + code_base(g, grp * g.cout_g) + n0;

  const int entries = 2 << g.bits;
  const uint32_t emask = (uint32_t)(entries - 1);
  for (int i = tid; i < entries; i += NT) tab[i] = __ldg(table + i);
  if (tid < BM) {
    const int m = m0 + tid;
    int4 ro = make_int4(0, -(1 << 29), -(1 << 29), 0);
    if (m < M) {
      const int b = m / (g.Ho * g.Wo);
      const int rem = m - b * g.Ho * g.Wo;
      const int ho = rem / g.Wo;
      ro = make_int4(b * g.H * g.W * g.C + grp * g.cin_g,
                     ho * g.stride - g.pad_h,
                     (rem - ho * g.Wo) * g.stride - g.pad_w, 0);
    }
    rows[tid] = ro;
  }
  __syncthreads();

  // the first RING stages go out; stage 0 is converted as soon as it lands
#pragma unroll
  for (int s = 0; s < RING; ++s) {
    if (s < nst) {
      load_x<VA>(raw_a + s * (BM * BK), x, rows, g, (st0 + s) * BK, R, tid);
      load_w<VB>(raw_b + s * RAW_B, wg, g, (st0 + s) * BK, R, ncols, tid);
    }
    cp_async_commit();
  }
  cp_async_wait<RING - 1>();
  __syncthreads();
  convert(raw_a, raw_b, op_a, op_b, tab, emask, tid);

  float acc_e[2][4][4], acc_o[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc_e[i][j][q] = acc_o[i][j][q] = 0.0f;

  // warp-uniform: which of the warp's 8-column tiles hold real columns
  const int wcols = ncols - wn * 32;
  // ldmatrix lane roles: A rows (l & 15) of a 16-row tile at chunk l >> 4;
  // B k-rows (l & 15) at 8-column tile l >> 4 of a pair
  const uint32_t a_base = smem_addr(op_a);
  const uint32_t b_base = smem_addr(op_b);
  const int a0 = a_off(wm * 32 + (lane & 15), lane >> 4);
  const int b0 = b_off(lane & 15, wn * 4 + (lane >> 4));

  for (int t = 0; t < nst; ++t) {
    cp_async_wait<RING - 2>();   // this thread's copies of stage t + 1
    __syncthreads();  // op tiles of t written; stage t + 1 landed; slot free
    if (t + RING < nst) {
      const int slot = (t + RING) % RING;
      load_x<VA>(raw_a + slot * (BM * BK), x, rows, g,
                 (st0 + t + RING) * BK, R, tid);
      load_w<VB>(raw_b + slot * RAW_B, wg, g, (st0 + t + RING) * BK, R,
                 ncols, tid);
    }
    cp_async_commit();

    if (wcols > 0) {
      const uint32_t pa = a_base + (t & 1) * 2 * OP_A;
      const uint32_t pb = b_base + (t & 1) * 2 * OP_B;
      // B fragments once per k16, A once per (k16, 16-row tile), within 128
      // registers; the x_hi products of a row tile go before its x_lo ones,
      // so that two products into one accumulator are not back to back
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t be[2][4], bo[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const uint32_t boff = (b0 ^ (np << 5)) + kk * 16 * 128;
          ldmatrix_x4_trans(be[np], pb + boff);
          ldmatrix_x4_trans(bo[np], pb + OP_B + boff);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t ah[4], al[4];
          const uint32_t aoff = (a0 ^ (kk << 5)) + mt * 16 * 64;
          ldmatrix_x4(ah, pa + aoff);
          ldmatrix_x4(al, pa + OP_A + aoff);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (wcols <= nt * 8) continue;
            const uint32_t* e = be[nt >> 1] + 2 * (nt & 1);
            const uint32_t* o = bo[nt >> 1] + 2 * (nt & 1);
            mma_bf16(acc_e[mt][nt], ah, e[0], e[1]);
            mma_bf16(acc_o[mt][nt], ah, o[0], o[1]);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (wcols <= nt * 8) continue;
            const uint32_t* e = be[nt >> 1] + 2 * (nt & 1);
            const uint32_t* o = bo[nt >> 1] + 2 * (nt & 1);
            mma_bf16(acc_e[mt][nt], al, e[0], e[1]);
            mma_bf16(acc_o[mt][nt], al, o[0], o[1]);
          }
        }
      }
    }
    if (t + 1 < nst) {
      const int slot = (t + 1) % RING;
      convert(raw_a + slot * (BM * BK), raw_b + slot * RAW_B,
              op_a + ((t + 1) & 1) * 2 * OP_A, op_b + ((t + 1) & 1) * 2 * OP_B,
              tab, emask, tid);
    }
  }

  // epilogue: this thread's values at rows g_ + {0, 8} and columns
  // 2 t_ + {0, 1} of each 16 x 8 tile (the mma.sync accumulator layout);
  // one share writes y, several write their partials
  const int gq = lane >> 2, tq = lane & 3;
  const int col0 = grp * g.cout_g + n0;
  const size_t plane = (size_t)M * g.Cout;
  float* out = splits == 1 ? y : part + split * plane;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = m0 + wm * 32 + mt * 16 + gq + (q >> 1) * 8;
        const int n = wn * 32 + nt * 8 + tq * 2 + (q & 1);
        if (m < M && n < ncols) {
          const float v = fmaf(SQRT2, acc_o[mt][nt][q], acc_e[mt][nt][q]);
          out[(size_t)m * g.Cout + col0 + n] =
              splits == 1 ? v * __ldg(scale + col0 + n) : v;
        }
      }
  if (splits == 1) return;

  // the last share of this tile to finish sums all shares in split order
  __shared__ int is_last;
  fence_acq_rel_gpu();                   // this thread's partials
  __syncthreads();
  if (tid == 0) {
    const int tile = (grp * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    is_last = atomicAdd(tickets + tile, 1) == splits - 1;
    if (is_last) {
      tickets[tile] = 0;                 // ready for the next launch
      fence_acq_rel_gpu();               // the other shares' partials
    }
  }
  __syncthreads();
  if (!is_last) return;
#pragma unroll 1
  for (int f = 0; f < 8; ++f) {          // one 16 x 8 tile at a time
    const int mt = f >> 2, nt = f & 3;
    size_t at[4];
    bool in[4];
    float sum[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + wm * 32 + mt * 16 + gq + (q >> 1) * 8;
      const int n = wn * 32 + nt * 8 + tq * 2 + (q & 1);
      in[q] = m < M && n < ncols;
      at[q] = in[q] ? (size_t)m * g.Cout + col0 + n : 0;
      sum[q] = 0.0f;
    }
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float v[4][8];                     // all loads in flight, then sums
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[q][u] = in[q] && s0 + u < splits
                        ? __ldcg(part + (s0 + u) * plane + at[q])
                        : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (s0 + u < splits)
            sum[q] = s0 + u == 0 ? v[q][u] : sum[q] + v[q][u];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (in[q]) {
        const int n = wn * 32 + nt * 8 + tq * 2 + (q & 1);
        y[at[q]] = sum[q] * __ldg(scale + col0 + n);
      }
  }
}

// ---------------------------------------------------------------------------
// the depthwise path (cin_g == 1)
// ---------------------------------------------------------------------------

constexpr int DW_PW = 4;             // outputs a thread, adjacent along W
constexpr int DW_NT = 256;           // threads a block, at most
constexpr int DW_SMEM_MAX = 232448;  // dynamic shared memory a block, at most

// A block's tile: th output rows x tw output columns x ct output channels
// of one image, with (ct / 4) * th * (tw / DW_PW) threads.  The grid is
// B * tiles_h * tiles_w * tiles_c blocks, the channel tile fastest.  The
// input patch the tile needs, halo included, is pr x pc pixels of ct
// channels.
struct DwTile {
  int th, tw, ct, lq;             // lq = log2(ct / 4)
  int tiles_h, tiles_w, tiles_c;
  int pr, pc;
  int vec_y;                      // 16-byte stores of y
};

__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y),
                     fmaf(a.z, b.z, c.z), fmaf(a.w, b.w, c.w));
}

// KK, SS: the kernel size and stride, compiled in for K = 3 at stride 1 or
// 2 (every depthwise conv of MobileNet v1); 0 reads both from g.  ASYNC:
// x reaches shared memory by 16-byte cp.async copies (C % 4 == 0,
// cout_g == 1, x 16-byte aligned), else by a bounds-checked gather.
template <int KK, int SS, bool ASYNC>
__global__ void __launch_bounds__(DW_NT, 2)
log_conv2d_depthwise_kernel(const float* __restrict__ x,
                            const int8_t* __restrict__ w,
                            const float* __restrict__ scale,
                            float* __restrict__ y, Geom g, DwTile t) {
  extern __shared__ float4 smem4[];
  float* patch = reinterpret_cast<float*>(smem4);  // [pr][pc][ct]
  float* wd = patch + t.pr * t.pc * t.ct;          // [K*K][ct]
  const int K = KK > 0 ? KK : g.K;
  const int S = KK > 0 ? SS : g.stride;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nq = t.ct >> 2, lc = t.lq + 2;

  int bid = blockIdx.x;
  const int tc_i = bid % t.tiles_c;
  bid /= t.tiles_c;
  const int tw_i = bid % t.tiles_w;
  bid /= t.tiles_w;
  const int th_i = bid % t.tiles_h;
  const int b = bid / t.tiles_h;
  const int ho0 = th_i * t.th, wo0 = tw_i * t.tw, c0 = tc_i * t.ct;
  const int h0 = ho0 * S - g.pad_h, w0 = wo0 * S - g.pad_w;
  const float* xb = x + b * g.H * g.W * g.C;

  // the patch, zero outside the image and past the last channel
  if (ASYNC) {
    // chunk i: channels c0 + 4 (i % nq) .. + 3 of patch pixel i / nq
    const int n = t.pr * t.pc * nq;
    for (int i = tid; i < n; i += nt) {
      const int q = i & (nq - 1), pix = i >> t.lq;
      const int r = pix / t.pc;
      const int hi = h0 + r, wi = w0 + pix - r * t.pc;
      const bool ok = hi >= 0 && hi < g.H && wi >= 0 && wi < g.W &&
                      c0 + 4 * q < g.C;
      cp_async16(patch + 4 * i,
                 ok ? xb + (hi * g.W + wi) * g.C + c0 + 4 * q : x, ok);
    }
    cp_async_commit();
  } else {
    // value i: output channel c0 + i % ct of patch pixel i / ct, which
    // reads input channel o / cout_g
    const int n = t.pr * t.pc * t.ct;
    for (int i = tid; i < n; i += nt) {
      const int o = c0 + (i & (t.ct - 1)), pix = i >> lc;
      const int r = pix / t.pc;
      const int hi = h0 + r, wi = w0 + pix - r * t.pc;
      patch[i] = hi >= 0 && hi < g.H && wi >= 0 && wi < g.W && o < g.Cout
                     ? __ldg(xb + (hi * g.W + wi) * g.C + o / g.cout_g)
                     : 0.0f;
    }
  }
  // the block's K*K*ct codes, decoded once
  for (int i = tid; i < K * K * t.ct; i += nt) {
    const int o = c0 + (i & (t.ct - 1)), tap = i >> lc;
    wd[i] = o < g.Cout ? decode(__ldg(w + code_base(g, o) + tap * g.w_tap),
                                g.bits, g.frac_bits)
                       : 0.0f;
  }
  // this thread: channels o .. o + 3 of outputs (ho, wo .. wo + DW_PW - 1);
  // the eight threads of a quarter warp read 128 contiguous bytes of a row
  const int q = tid & (nq - 1);
  const int ncg = t.tw / DW_PW;
  const int rest = tid >> t.lq;
  const int r = rest / ncg, cg = rest - r * ncg;
  const int ho = ho0 + r, wo = wo0 + cg * DW_PW, o = c0 + 4 * q;
  float s[4];   // loaded under the patch's copies
#pragma unroll
  for (int k = 0; k < 4; ++k)
    s[k] = o + k < g.Cout ? __ldg(scale + o + k) : 0.0f;
  if (ASYNC) cp_async_wait<0>();
  __syncthreads();
  if (ho >= g.Ho || wo >= g.Wo || o >= g.Cout) return;
  float4 acc[DW_PW];
#pragma unroll
  for (int j = 0; j < DW_PW; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  // per output: fmaf over (kh, kw) in row-major order from 0; a halo tap
  // holds +0 and adds exactly 0, as a skipped tap would
  const float* p0 = patch + (r * S * t.pc + cg * DW_PW * S) * t.ct + 4 * q;
  const float* w0p = wd + 4 * q;
  if constexpr (KK > 0) {
    // one patch row in registers feeds every tap of the row: at stride 1,
    // DW_PW + K - 1 loads for DW_PW * K products
    constexpr int NX = (DW_PW - 1) * SS + KK;
#pragma unroll
    for (int kh = 0; kh < KK; ++kh) {
      const float* pr = p0 + kh * t.pc * t.ct;
      float4 xr[NX];
#pragma unroll
      for (int u = 0; u < NX; ++u)
        xr[u] = *reinterpret_cast<const float4*>(pr + u * t.ct);
#pragma unroll
      for (int kw = 0; kw < KK; ++kw) {
        const float4 wv =
            *reinterpret_cast<const float4*>(w0p + (kh * KK + kw) * t.ct);
#pragma unroll
        for (int j = 0; j < DW_PW; ++j)
          acc[j] = fma4(xr[j * SS + kw], wv, acc[j]);
      }
    }
  } else {
    for (int kh = 0; kh < K; ++kh) {
      const float* pr = p0 + kh * t.pc * t.ct;
      for (int kw = 0; kw < K; ++kw) {
        const float4 wv =
            *reinterpret_cast<const float4*>(w0p + (kh * K + kw) * t.ct);
#pragma unroll
        for (int j = 0; j < DW_PW; ++j)
          acc[j] = fma4(
              *reinterpret_cast<const float4*>(pr + (j * S + kw) * t.ct), wv,
              acc[j]);
      }
    }
  }

  float* yo = y + ((b * g.Ho + ho) * g.Wo + wo) * g.Cout + o;
#pragma unroll
  for (int j = 0; j < DW_PW; ++j) {
    if (wo + j >= g.Wo) break;
    const float v[4] = {acc[j].x * s[0], acc[j].y * s[1], acc[j].z * s[2],
                        acc[j].w * s[3]};
    if (t.vec_y) {
      *reinterpret_cast<float4*>(yo + j * g.Cout) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (o + k < g.Cout) yo[j * g.Cout + k] = v[k];
    }
  }
}

// Above 48 KB a kernel must ask for its shared memory, once a device;
// `asked` holds the caller's flag for each device.
template <typename F>
cudaError_t ask_smem(F* kern, int bytes, bool max_shared, bool (&asked)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && asked[dev])) return err;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && max_shared)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) asked[dev] = true;
  return err;
}

template <int KK, int SS, bool ASYNC>
cudaError_t launch_depthwise(const float* x, const int8_t* w, const float* s,
                             float* y, const Geom& g, const DwTile& t,
                             int smem, int blocks, cudaStream_t st) {
  auto kern = log_conv2d_depthwise_kernel<KK, SS, ASYNC>;
  if (smem > 48 * 1024) {
    static bool asked[64] = {};
    const cudaError_t err = ask_smem(kern, DW_SMEM_MAX, false, asked);
    if (err != cudaSuccess) return err;
  }
  const int threads = (t.ct / 4) * t.th * (t.tw / DW_PW);
  kern<<<blocks, threads, smem, st>>>(x, w, s, y, g, t);
  return cudaGetLastError();
}
using DwLaunch = cudaError_t (*)(const float*, const int8_t*, const float*,
                                 float*, const Geom&, const DwTile&, int, int,
                                 cudaStream_t);

template <bool VA, bool VB>
cudaError_t launch_dense(const float* x, const int8_t* w, const float* s,
                         const uint32_t* table, float* y, float* part,
                         int* tickets, const Geom& g, int groups, int sps,
                         int splits, cudaStream_t st) {
  auto kern = log_conv2d_dense_kernel<VA, VB>;
  static bool asked[64] = {};
  const cudaError_t err = ask_smem(kern, SMEM, true, asked);
  if (err != cudaSuccess) return err;
  const int M = g.B * g.Ho * g.Wo;
  const dim3 grid((g.cout_g + BN - 1) / BN, (M + BM - 1) / BM,
                  groups * splits);
  kern<<<grid, NT, SMEM, st>>>(x, w, s, table, y, part, tickets, g, sps,
                               splits);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// Pointers are device pointers; shapes were checked by the Python wrapper,
// and the geometry comes from `log_conv2d_geometry`.  table holds the
// 2^(bits+1) plane entries of `plane_table`.  The depthwise path
// (cin_g == 1) takes tiles of dw_th x dw_tw x dw_ct outputs (dw_tw a
// multiple of 4, dw_ct in {4, 8, 16, 32}, at most 256 threads and 227 KB
// of shared memory a block) and ignores sps, splits, part, tickets and
// table.  The dense path (cin_g > 1) walks R = K*K*cin_g in stages of 32;
// with splits > 1, each of the `splits` shares takes sps stages, part is
// fp32 [splits, B*Ho*Wo, Cout] scratch and tickets holds one zeroed int32
// per (group, row, column) tile, left zeroed by the launch; with
// splits == 1 neither is touched.
extern "C" int log_conv2d_launch(const void* x, const void* w,
                                 const void* scale, const void* table,
                                 void* y, void* part, void* tickets, int B,
                                 int H, int W, int C, int Ho, int Wo,
                                 int Cout, int K, int stride, int pad_h,
                                 int pad_w, int groups, int g_b, int w_sb,
                                 int w_gl, int w_tap, int w_in, int bits,
                                 int frac_bits, int sps, int splits,
                                 int dw_th, int dw_tw, int dw_ct,
                                 void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.C = C;
  g.Ho = Ho; g.Wo = Wo; g.Cout = Cout;
  g.K = K; g.stride = stride; g.pad_h = pad_h; g.pad_w = pad_w;
  g.cin_g = C / groups; g.cout_g = Cout / groups;
  g.g_b = g_b; g.w_sb = w_sb; g.w_gl = w_gl; g.w_tap = w_tap; g.w_in = w_in;
  g.bits = bits; g.frac_bits = frac_bits;
  if (bits < 1 || bits > 7 || (frac_bits != 0 && frac_bits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* yp = static_cast<float*>(y);
  if (g.cin_g == 1) {
    DwTile t;
    t.th = dw_th; t.tw = dw_tw; t.ct = dw_ct;
    t.lq = dw_ct == 4 ? 0 : dw_ct == 8 ? 1 : dw_ct == 16 ? 2 : 3;
    if (dw_th < 1 || dw_tw < DW_PW || dw_tw % DW_PW != 0 ||
        (dw_ct != 4 && dw_ct != 8 && dw_ct != 16 && dw_ct != 32) ||
        (long long)(dw_ct / 4) * dw_th * (dw_tw / DW_PW) > DW_NT)
      return static_cast<int>(cudaErrorInvalidValue);
    t.pr = (dw_th - 1) * stride + K;
    t.pc = (dw_tw - 1) * stride + K;
    const long long smem = 4LL * ((long long)t.pr * t.pc + K * K) * dw_ct;
    t.tiles_h = (Ho + dw_th - 1) / dw_th;
    t.tiles_w = (Wo + dw_tw - 1) / dw_tw;
    t.tiles_c = (Cout + dw_ct - 1) / dw_ct;
    const long long blocks = (long long)B * t.tiles_c * t.tiles_h * t.tiles_w;
    if (smem > DW_SMEM_MAX || blocks > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    t.vec_y = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
    // 16-byte copies of x: every chunk of 4 channels is 16 aligned bytes
    const bool async = C % 4 == 0 && g.cout_g == 1 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
    DwLaunch launch = async ? &launch_depthwise<0, 0, true>
                            : &launch_depthwise<0, 0, false>;
    if (K == 3 && stride == 1)
      launch = async ? &launch_depthwise<3, 1, true>
                     : &launch_depthwise<3, 1, false>;
    else if (K == 3 && stride == 2)
      launch = async ? &launch_depthwise<3, 2, true>
                     : &launch_depthwise<3, 2, false>;
    const cudaError_t err = launch(xp, wp, sp, yp, g, t, (int)smem,
                                   (int)blocks, s);
    return static_cast<int>(err);
  }
  const int stages = (K * K * g.cin_g + BK - 1) / BK;
  if (sps < 1 || splits < 1 || (long long)(splits - 1) * sps >= stages ||
      (long long)splits * sps < stages ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies of x: every chunk of 16 indices is 64 aligned bytes
  const bool va = g.cin_g % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // 16-byte copies of codes: every row of a tile is whole aligned chunks
  const bool vb = g.cout_g % 16 == 0 && w_sb % 16 == 0 && w_gl % 16 == 0 &&
                  w_tap % 16 == 0 && w_in % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const uint32_t* tp = static_cast<const uint32_t*>(table);
  float* pp = static_cast<float*>(part);
  int* kp = static_cast<int*>(tickets);
  cudaError_t err;
  if (va && vb)
    err = launch_dense<true, true>(xp, wp, sp, tp, yp, pp, kp, g, groups, sps,
                                   splits, s);
  else if (va)
    err = launch_dense<true, false>(xp, wp, sp, tp, yp, pp, kp, g, groups,
                                    sps, splits, s);
  else if (vb)
    err = launch_dense<false, true>(xp, wp, sp, tp, yp, pp, kp, g, groups,
                                    sps, splits, s);
  else
    err = launch_dense<false, false>(xp, wp, sp, tp, yp, pp, kp, g, groups,
                                     sps, splits, s);
  return static_cast<int>(err);
}
