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
// paper, sign * LUT[c & 1] * 2^(c >> 1) with the LUT {1, sqrt(2)}, exact
// bit for bit with `decode_codes`.  Ragged M, K and N are handled by
// bounds checks (codes outside the matrix, or outside a block's share of
// K, read as the zero code), never by padded copies.
//
// What bounds it on this card: the LM dense layers it serves run at small
// M (decode: one row per engine slot, M <= 16), where each code byte feeds
// M multiply-adds.  That is far below the H100's ridge point, so the limit
// is the bytes of codes read from device memory (3.35 TB/s).  To stream
// them at that rate the card needs many loads in flight on every SM, the
// decode next to the multiply-adds must cost little, and the fixed cost of
// a launch (126 to 192 of them a forward) must stay small.  The design, by
// what it buys:
//   * split-K in one launch: a block owns BM rows (4, or 8 when M > 4),
//     BN = 128 columns and one share of K; `log_matmul_geometry` in
//     `kernels/log_matmul.py` picks the shares so that a product launches
//     about two blocks per SM where K allows.  Each share writes fp32
//     partials to a scratch [splits, M, N]; the last block of a column tile
//     to finish (an int32 ticket per tile, counted with atomicAdd and reset
//     by that block) sums the shares in split order, applies the scale and
//     the cast and writes y.  No float atomics: the same inputs give the
//     same bits on every run, and a product is one launch;
//   * occupancy: 256 threads, at most 128 registers a thread
//     (__launch_bounds__(256, 2)), so two blocks share an SM;
//   * loads in flight while decoding: the codes stream through a ring of
//     RING = 3 stages in shared memory by cp.async (16 bytes a copy, no
//     registers held), two stages ahead of the decode: up to 32 KB a
//     block in flight.  A stage is 128 rows of the tile at BM = 4 (64 at
//     BM = 8); each thread decodes 8 columns of 8 (4) of its rows.  The
//     block's rows of x are staged in shared memory as fp32 once per 1024
//     rows of K at BM = 4 (512 at BM = 8), so once per block at the LM
//     decode shapes, the first chunk loaded before the first codes;
//   * a table decode: shared memory holds dec(c) for the 2^(bits+1) codes,
//     one copy per lane (entry c, lane l at float c * 64 + l: a warp's 32
//     lookups fall in 32 banks whatever the codes).  One byte_perm turns a
//     code byte and the lane into the byte offset of its entry, so a code
//     costs one integer operation, one shared-memory load and M
//     multiply-adds (plus one mask per four codes).  The table is built at
//     block start with exactly the IEEE bits of `decode` below, one
//     decode a lane, spread to the other lanes' copies by shuffles.
// Large M, the conv's explicit-im2col route (`log_conv2d_im2col`): M is
// B*Ho*Wo, up to 401,408 rows a product for VGG-16's first convs at batch
// 8 and 224 px.  Row tiles run on grid y, at most 65,535 of them (524,280
// rows at BM = 8), so the wrapper cuts a product of more rows into
// launches of whole row tiles (`log_matmul_row_chunks`), one launch each;
// the pointers it passes are the chunk's rows of x and y.  At such M
// `log_matmul_geometry` gives one share of K, so no partials are written.
// There each 8-row tile decodes its column tile's codes again, and a code
// feeds 8 multiply-adds on the fp32 CUDA cores: the kernel is bound by
// those operations (67 TFLOP/s), far from the tensor cores' rate; nothing
// in the design addresses that regime yet.
// Left for later: tensor cores (wgmma) for prefill- and conv-sized M, TMA
// loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int COLS = 8;          // columns per thread: one 8-byte code load
constexpr int BN = 128;          // columns per block
constexpr int TPR = BN / COLS;   // threads across a row (16)
constexpr int KL = NT / TPR;     // k-lanes (16)
constexpr int RING = 3;          // stages of codes in shared memory
constexpr int SLOTS = 64;        // floats per table entry (256 bytes)

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

// rows of K per stage: 8 rows a k-lane at BM = 4, 4 at BM = 8
__host__ __device__ constexpr int rows_per_lane(int bm) { return 32 / bm; }
__host__ __device__ constexpr int stage_rows(int bm) {
  return KL * rows_per_lane(bm);
}

// rows of K per staged chunk of x: 1024 at BM = 4, 512 at BM = 8 (16 KB)
__host__ __device__ constexpr int x_chunk(int bm) { return 4096 / bm; }

__host__ __device__ constexpr int table_floats(int bits, int bm) {
  // the decode table, reused after the main loop for the k-lane reduction
  return (2 << bits) * SLOTS > (NT / 32) * bm * BN ? (2 << bits) * SLOTS
                                                   : (NT / 32) * bm * BN;
}

// dynamic shared memory: [table | x chunk | ring of code stages]
__host__ __device__ constexpr int smem_bytes(int bits, int bm) {
  return (table_floats(bits, bm) + x_chunk(bm) * bm) * 4 +
         RING * stage_rows(bm) * BN;
}

// One stage of codes into a ring slot: SR rows of the tile's BN bytes from
// row k0, the zero code outside [.., kend) x [.., N).  VEC (N % 16 == 0, a
// 16-byte aligned base): 16-byte cp.async copies, zero-filled where out of
// bounds; otherwise byte loads stored by the thread.
template <int SR, bool VEC>
__device__ __forceinline__ void copy_stage(uint8_t* dst,
                                           const int8_t* __restrict__ w,
                                           int k0, int kend, int N, int nt0,
                                           int tid) {
  constexpr int CPR = BN / 16;             // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < SR * CPR / NT; ++i) {
    const int c = tid + i * NT;
    const int row = c / CPR;
    const int col = (c % CPR) * 16;
    const int k = k0 + row;
    const int n = nt0 + col;
    uint8_t* d = dst + row * BN + col;
    if (VEC) {
      const bool ok = k < kend && n < N;
      const uint32_t sa = (uint32_t)__cvta_generic_to_shared(d);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
                   "l"(ok ? w + (size_t)k * N + n : w), "r"(ok ? 16 : 0)
                   : "memory");
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (k < kend) {
#pragma unroll 1
        for (int j = 0; j < 16; ++j)
          if (n + j < N)
            v[j >> 2] |= (uint32_t)(uint8_t)__ldg(w + (size_t)k * N + n + j)
                         << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

template <typename TX, typename TY, int BM, bool VEC>
__global__ void __launch_bounds__(NT, 2)
log_matmul_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, TY* __restrict__ y,
                  float* __restrict__ part, int* __restrict__ tickets,
                  int M, int K, int N, int bits, int frac_bits, int kps) {
  constexpr int U = rows_per_lane(BM);
  constexpr int SR = stage_rows(BM);
  constexpr int XC = x_chunk(BM);
  constexpr int EPT = BM * BN / NT;        // outputs a thread in the epilogue
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  float* xs = tab + table_floats(bits, BM);   // [XC][BM]
  uint8_t* ring = reinterpret_cast<uint8_t*>(xs + XC * BM);  // [RING][SR][BN]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = tid % TPR;
  const int kl = tid / TPR;
  const int nt0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int kbeg = split * kps;
  const int kend = min(K, kbeg + kps);
  const int nst = (kend - kbeg + SR - 1) / SR;   // stages, >= 1

  // the first chunk of x, then the first RING - 1 stages of codes, go out
  // before the table is built; x waits in registers until it is written
  const int rows0 = min(XC, nst * SR);
  float xpre[XC / NT][BM];
#pragma unroll
  for (int i = 0; i < XC / NT; ++i) {
    const int r = tid + i * NT;
#pragma unroll
    for (int m = 0; m < BM; ++m)
      xpre[i][m] = (r < rows0 && kbeg + r < kend && m0 + m < M)
                       ? to_f(x[(size_t)(m0 + m) * K + kbeg + r])
                       : 0.0f;
  }
#pragma unroll
  for (int st = 0; st < RING - 1; ++st) {
    if (st < nst)
      copy_stage<SR, VEC>(ring + st * SR * BN, w, kbeg + st * SR, kend, N,
                          nt0, tid);
    cp_async_commit();
  }

  // warp w writes entries w, w + 8, ...; lane j computed entry 8 j + w
  const int entries = 2 << bits;
  {
    const float v = decode((uint32_t)(lane * 8 + warp) & (entries - 1), bits,
                           frac_bits);
    for (int e = warp, j = 0; e < entries; e += NT / 32, ++j)
      tab[e * SLOTS + lane] = __shfl_sync(0xFFFFFFFFu, v, j);
  }
#pragma unroll
  for (int i = 0; i < XC / NT; ++i) {
    const int r = tid + i * NT;
    if (r < rows0) {
#pragma unroll
      for (int q = 0; q < BM / 4; ++q)
        reinterpret_cast<float4*>(xs + r * BM)[q] = make_float4(
            xpre[i][4 * q], xpre[i][4 * q + 1], xpre[i][4 * q + 2],
            xpre[i][4 * q + 3]);
    }
  }
  const uint32_t cmask = 0x01010101u * (uint32_t)(entries - 1);
  const uint32_t lane_off = (uint32_t)lane * 4u;  // byte 0 of byte_perm's y
  const char* tabc = reinterpret_cast<const char*>(tab);

  float acc[BM][COLS];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[m][j] = 0.0f;

  for (int t = 0; t < nst; ++t) {
    cp_async_wait<RING - 2>();             // this thread's copies of stage t
    __syncthreads();  // everyone's; the table and x written; slot t-1 free
    if (t + RING - 1 < nst)
      copy_stage<SR, VEC>(ring + ((t + RING - 1) % RING) * SR * BN, w,
                          kbeg + (t + RING - 1) * SR, kend, N, nt0, tid);
    cp_async_commit();
    const int r0 = t * SR;                 // stage's first row, from kbeg
    if (r0 > 0 && (r0 & (XC - 1)) == 0) {  // a new chunk of x
      const int kc = kbeg + r0;
      const int rows = min(XC, nst * SR - r0);
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const bool row_in = m0 + m < M;
        const TX* xrow = x + (size_t)(m0 + m) * K;
        for (int r = tid; r < rows; r += NT)
          xs[r * BM + m] = (row_in && kc + r < kend) ? to_f(xrow[kc + r])
                                                     : 0.0f;
      }
      __syncthreads();
    }
    const uint8_t* slot = ring + (t % RING) * SR * BN + cg * COLS;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = u * KL + kl;           // row within the stage
      const uint2 c = *reinterpret_cast<const uint2*>(slot + r * BN);
      const float4* xr =
          reinterpret_cast<const float4*>(xs + ((r0 & (XC - 1)) + r) * BM);
      float xv[BM];
#pragma unroll
      for (int q = 0; q < BM / 4; ++q) {
        const float4 v = xr[q];
        xv[4 * q] = v.x;
        xv[4 * q + 1] = v.y;
        xv[4 * q + 2] = v.z;
        xv[4 * q + 3] = v.w;
      }
      const uint32_t words[2] = {c.x & cmask, c.y & cmask};
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        // byte 1 = code j, byte 0 = 4 * lane: the entry's byte offset
        const uint32_t off =
            __byte_perm(words[j >> 2], lane_off, 0x5504u | ((j & 3) << 4));
        const float d = *reinterpret_cast<const float*>(tabc + off);
#pragma unroll
        for (int m = 0; m < BM; ++m) acc[m][j] = fmaf(xv[m], d, acc[m][j]);
      }
    }
  }

  // reduce over the k-lanes: lanes l and l ^ 16 of a warp hold the same
  // columns, then the eight warps through shared memory (the table's space)
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      acc[m][j] += __shfl_xor_sync(0xFFFFFFFFu, acc[m][j], 16);
  __syncthreads();                         // every table lookup is done
  float* red = tab;                        // [NT / 32][BM][BN]
  if (lane < TPR) {
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      float4* dst = reinterpret_cast<float4*>(red + (warp * BM + m) * BN
                                              + cg * COLS);
      dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    }
  }
  // this thread's outputs: (m, n) of element i = tid + e * NT of the tile
  bool in[EPT];
  float sc[EPT];
  size_t at[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = tid + e * NT;
    const int m = m0 + i / BN;
    const int n = nt0 + i % BN;
    in[e] = m < M && n < N;
    sc[e] = in[e] ? scale[n] : 0.0f;
    at[e] = (size_t)m * N + n;
  }
  __syncthreads();
  const bool direct = gridDim.z == 1;
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int i = tid + e * NT;
    float s = red[(i / BN) * BN + i % BN];
#pragma unroll
    for (int wi = 1; wi < NT / 32; ++wi)
      s += red[(wi * BM + i / BN) * BN + i % BN];
    if (!in[e]) continue;
    if (direct)
      store(y + at[e], s * sc[e]);
    else
      part[(size_t)split * M * N + at[e]] = s;
  }
  if (direct) return;

  // the last share of this tile to finish sums all shares in split order
  __syncthreads();                         // partials stored; red is read
  int* is_last = reinterpret_cast<int*>(smem4);
  if (tid == 0) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    fence_acq_rel_gpu();                   // the block's partials, then
    *is_last = atomicAdd(tickets + tile, 1) == splits - 1;  // its ticket
    if (*is_last) {
      tickets[tile] = 0;                   // ready for the next launch
      fence_acq_rel_gpu();                 // the other shares' partials
    }
  }
  __syncthreads();
  if (!*is_last) return;
  const size_t plane = (size_t)M * N;
  float s[EPT];
  for (int q0 = 0; q0 < splits; q0 += 8) {
    float v[EPT][8];                       // all loads in flight, then sums
#pragma unroll
    for (int e = 0; e < EPT; ++e)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        v[e][q] = in[e] && q0 + q < splits
                      ? __ldcg(part + (size_t)(q0 + q) * plane + at[e])
                      : 0.0f;
#pragma unroll
    for (int e = 0; e < EPT; ++e)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q0 + q < splits) s[e] = q0 + q == 0 ? v[e][q] : s[e] + v[e][q];
  }
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    if (in[e]) store(y + at[e], s[e] * sc[e]);
}

template <typename TX, typename TY, int BM, bool VEC>
cudaError_t launch_kernel(const void* x, const void* w, const void* scale,
                          void* y, void* part, void* tickets, int M, int K,
                          int N, int bits, int frac_bits, int kps, int splits,
                          cudaStream_t s) {
  auto kern = log_matmul_kernel<TX, TY, BM, VEC>;
  const int smem = smem_bytes(bits, BM);
  // above 48 KB the kernel must ask for its shared memory, once a device
  static int asked[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || asked[dev] < smem) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) asked[dev] = smem;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kern<<<grid, NT, smem, s>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<TY*>(y),
      static_cast<float*>(part), static_cast<int*>(tickets), M, K, N, bits,
      frac_bits, kps);
  return cudaGetLastError();
}

template <typename TX, typename TY>
cudaError_t launch_types(const void* x, const void* w, const void* scale,
                         void* y, void* part, void* tickets, int M, int K,
                         int N, int bits, int frac_bits, int bm, int kps,
                         int splits, bool vec, cudaStream_t s) {
#define LM_LAUNCH(BM_, VEC_)                                               \
  return launch_kernel<TX, TY, BM_, VEC_>(x, w, scale, y, part, tickets, M, \
                                          K, N, bits, frac_bits, kps,      \
                                          splits, s)
  if (bm == 4) {
    if (vec) LM_LAUNCH(4, true);
    LM_LAUNCH(4, false);
  }
  if (vec) LM_LAUNCH(8, true);
  LM_LAUNCH(8, false);
#undef LM_LAUNCH
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); 0 means launched.
// x_type / y_type: 0 = fp32, 1 = bf16.  Pointers are device pointers and
// shapes were checked by the Python wrapper (contiguous row-major x, codes
// and y; M, K, N >= 1).  The geometry comes from `log_matmul_geometry`:
// bm rows per block, shares of kps rows of K (a multiple of the stage,
// 128 rows at bm = 4 and 64 at bm = 8) in
// `splits` blocks along z.  With splits > 1, part is fp32 [splits, M, N]
// scratch and tickets holds one zeroed int32 per (row, column) tile, left
// zeroed by the launch; with splits == 1 neither is touched.
extern "C" int log_matmul_launch(const void* x, const void* w,
                                 const void* scale, void* y, void* part,
                                 void* tickets, int M, int K, int N, int bits,
                                 int frac_bits, int x_type, int y_type, int bm,
                                 int kps, int splits, void* stream) {
  if ((bm != 4 && bm != 8) || kps < 1 || kps % stage_rows(bm) != 0 ||
      splits < 1 ||
      (long long)(splits - 1) * kps >= K || (long long)splits * kps < K ||
      bits < 1 || bits > 7 || (frac_bits != 0 && frac_bits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (N % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  cudaError_t err;
  if (x_type == 0 && y_type == 0)
    err = launch_types<float, float>(x, w, scale, y, part, tickets, M, K, N,
                                     bits, frac_bits, bm, kps, splits, vec, s);
  else if (x_type == 1 && y_type == 1)
    err = launch_types<__nv_bfloat16, __nv_bfloat16>(
        x, w, scale, y, part, tickets, M, K, N, bits, frac_bits, bm, kps,
        splits, vec, s);
  else if (x_type == 1 && y_type == 0)
    err = launch_types<__nv_bfloat16, float>(x, w, scale, y, part, tickets, M,
                                             K, N, bits, frac_bits, bm, kps,
                                             splits, vec, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
