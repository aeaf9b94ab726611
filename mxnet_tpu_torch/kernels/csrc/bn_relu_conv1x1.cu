// Fused BatchNorm-apply (+ReLU) + 1x1 convolution, NCHW, for Hopper (sm_90a).
//
//   out[b, o, s] = sum_c W[o, c] * z[b, c, s]
//   z[b, c, s]   = round_to_T(act(x[b, c, s] * scale[c] + shift[c]))
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_fused.py::_make_nchw_kernel
// (bn_relu_conv_nchw's tiled pallas_call). As there, the normalised
// activation z never reaches device memory: it is made while the x chunk
// is staged into shared memory, rounded to the input type, and fed
// straight to the matrix product. Sums are taken in fp32.
//
// Bound on an H100 (data-sheet peaks, 3.35 TB/s and 989 TFLOP/s bf16):
// the operations per byte moved are about C*O/(C+O) per spatial position
// (x read and out written once, bf16). That is 51-205 flop/byte at the
// 56x56, 28x28 and 14x14 ResNet-50 sites, under the ridge of ~295, so
// those are memory-bound; the 7x7 sites (2048<->512, ~410 flop/byte)
// are bound by the tensor cores. Over a whole forward the bytes
// dominate. So the design point is to read x once per output-channel
// tile, write out once, and never write the normalised activation; W and
// scale/shift are small and stay in L2.
//
// Design. bf16 has two routes, chosen on the host before the launch by
// ops/fused_bn_conv.py::_k1_plan from shapes and pointer alignment:
//   - wgmma (bn_gemm_wgmma.cuh, entry mxtt_bn_relu_conv1x1_wgmma): every
//     ResNet-50 site. The product is transposed per sample, out^T = z^T
//     W^T, so the normalised x is wgmma's register operand: BN-apply,
//     ReLU and the one rounding happen in registers between the shared
//     stage and the tensor cores. A producer warp keeps a 3-stage
//     mbarrier ring full by TMA (x through a 3-D tensor map where S % 8
//     == 0; one 1-D cp.async.bulk per sample where the 392- or 98-byte
//     channel stride of the 14x14 and 7x7 maps rules a tensor map out),
//     so loads overlap the math; the persistent grid keeps the output
//     tiles that share an x tile adjacent, and the output leaves through
//     a staged, S-contiguous TMA or bulk store that overlaps the next
//     tile. This is what was missing below: the WMMA kernel stages one
//     32-channel chunk ahead through registers with two block barriers a
//     chunk, normalises element by element into shared memory, and at
//     S = 49 falls to 2-byte accesses.
//   - wmma (bn_relu_conv1x1_bf16 below, entry mxtt_bn_relu_conv1x1):
//     what the wgmma route does not take: C not a multiple of 64, O not
//     a multiple of 8, a pointer not 16-byte aligned, S % 8 != 0 with S
//     above 256. One block of 256 threads per tile of 64 output channels
//     x 128 columns, where the columns run over the flattened (sample,
//     position) axis N = B*S; 8 warps each multiply a 32x32 sub-tile
//     with wmma 16x16x16 bf16 fragments into fp32 accumulators. A thread
//     loads, normalises and stores V adjacent columns at once (V = 8, 4,
//     2 or 1: the widest that S and the pointers' alignment allow).
//   - fp32: one block of 128 threads per (sample, 64 output channels,
//     64 positions) tile; each thread accumulates an 8x4 block with fp32
//     FMA (no TF32, so an fp32 Predictor computes in full fp32).
// The wmma and fp32 kernels walk C in chunks of 32, staging the W chunk
// and the normalised x chunk in shared memory; the next chunk's loads are
// issued before the current chunk's products. Every edge is masked: any
// B, C, O and S.
//
// C interface, loaded with ctypes; returns cudaGetLastError() after the
// launch (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "bn_gemm_wgmma.cuh"

namespace {

constexpr int BO = 64;   // output channels per block
constexpr int BS = 64;   // spatial positions per block
constexpr int BK = 32;   // input channels per shared-memory chunk
constexpr int NT = 128;  // threads per block
constexpr int NA = BO * BK / NT;  // W-chunk elements staged per thread
constexpr int NB = BK * BS / NT;  // x-chunk elements staged per thread
constexpr int RA = NT / BK;       // row step of a thread's W elements
constexpr int KB = NT / BS;       // row step of a thread's x elements

// padded leading dimensions: multiples of 8 (16-bit) / 4 (fp32) elements
// as wmma needs, and off the 32-bank stride
constexpr int LDA = BK + 8;
constexpr int LDB = BS + 8;
constexpr int LDC = BS + 4;

// Loads one chunk (channels k0..k0+BK-1) into registers: W elements at
// rows o_a + RW*j, channel k0+ka; x words (X: one element, or V adjacent
// bf16 columns) at channels k0+kb+RX*j of the column(s) xcol points at,
// when col_ok. Out-of-range elements load as zero.
template <int RW, int RX, typename T, typename X, int NW, int NX>
__device__ __forceinline__ void load_chunk(
    T (&wr)[NW], X (&xr)[NX], const T* __restrict__ w,
    const T* __restrict__ xcol, int k0, int ka, int kb, int o_a,
    bool col_ok, int C, int O, int S, T zero) {
  const int ca = k0 + ka;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int o = o_a + RW * j;
    wr[j] = (o < O && ca < C) ? w[(size_t)o * C + ca] : zero;
  }
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const int c = k0 + kb + RX * j;
    xr[j] = (c < C && col_ok)
                ? *reinterpret_cast<const X*>(xcol + (size_t)c * S)
                : X();
  }
}

// bf16 tile: 64 output channels x 128 columns, where a column is one
// (sample, position) pair of the flattened N = B*S axis, so the small
// 7x7 and 14x14 maps fill whole tiles and each staged W chunk serves 128
// columns. 8 warps (2 x 4), each a 32x32 sub-tile. A thread moves V
// adjacent columns of x and out with one V*2-byte access (V = 8, 4, 2
// when S and the pointers allow, else 1).
constexpr int TBO = 64;   // output channels per block
constexpr int TBN = 128;  // columns (b, s) per block
constexpr int TNT = 256;  // threads per block
constexpr int TNA = TBO * BK / TNT;  // W-chunk elements per thread (8)
constexpr int TRA = TNT / BK;        // row step of a thread's W elements
constexpr int TLDB = TBN + 8;
constexpr int TLDC = TBN + 4;
constexpr int A_BYTES = TBO * LDA * 2;
constexpr int B_BYTES = BK * TLDB * 2;
constexpr int C_BYTES = TBO * TLDC * 4;
constexpr int SMEM_BYTES = (A_BYTES + B_BYTES > C_BYTES) ? A_BYTES + B_BYTES
                                                         : C_BYTES;

// V adjacent bf16 values as one register-sized word and as 16-bit lanes
template <int V> struct Vec;
template <> struct Vec<1> { typedef unsigned short T; };
template <> struct Vec<2> { typedef unsigned int T; };
template <> struct Vec<4> { typedef uint2 T; };
template <> struct Vec<8> { typedef uint4 T; };
template <int V> union Pack {
  typename Vec<V>::T raw;
  unsigned short h[V];
};

template <int V>
__global__ void __launch_bounds__(TNT, 2)
bn_relu_conv1x1_bf16(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const __nv_bfloat16* __restrict__ scale,
                     const __nv_bfloat16* __restrict__ shift,
                     __nv_bfloat16* __restrict__ out,
                     int C, int O, int S, int N, int relu) {
  using namespace nvcuda;
  typedef typename Vec<V>::T word;
  constexpr int TCOLS = TBN / V;      // thread columns per x row
  constexpr int TKB = TNT / TCOLS;    // row step of a thread's x words
  constexpr int TNB = BK / TKB;       // x words per thread per chunk
  // when a warp's lanes share their x rows (V <= 4), lanes 0-15 fetch
  // the rows' scales and lanes 16-31 their shifts, handed out by shuffle
  constexpr bool SHFL = TCOLS >= 32;
  // the staged chunks and, after the main loop, the fp32 output tile
  // share one buffer
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const int o0 = blockIdx.x * TBO;   // O tiles adjacent: x tile reused
  const int n0 = blockIdx.y * TBN;   // from L2 by the blocks beside it
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wo = (warp / 4) * 32;    // warp's sub-tile origin (rows = o)
  const int wn = (warp % 4) * 32;    //                         (cols = n)
  const int ka = tid % BK, ra = tid / BK;       // W chunk: column, 1st row
  const int nb = tid % TCOLS, kb = tid / TCOLS; // x chunk: word, 1st row
  // this thread's V columns: one sample, positions sp..sp+V-1 (S % V == 0)
  const int n = n0 + nb * V;
  const bool n_ok = n < N;
  const int nbi = n_ok ? n / S : 0;
  const int sp = n_ok ? n - nbi * S : 0;
  const __nv_bfloat16* xcol = x + (size_t)nbi * C * S + sp;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  __nv_bfloat16 wr[TNA];
  word xr[TNB];
  __nv_bfloat16 sv = zero;  // SHFL: this lane's scale or shift
  // loads of one chunk into registers, and (SHFL) this lane's scale or
  // shift of it
  auto load = [&](int k0) {
    load_chunk<TRA, TKB>(wr, xr, w, xcol, k0, ka, kb, o0 + ra, n_ok, C, O,
                         S, zero);
    if (SHFL) {
      const int l = lane % 16, cs = k0 + kb + TKB * l;
      sv = (l < TNB && cs < C) ? (lane < 16 ? scale[cs] : shift[cs]) : zero;
    }
  };
  load(0);
  for (int k0 = 0; k0 < C; k0 += BK) {
    // stage the chunk held in registers, normalising x on the way
#pragma unroll
    for (int j = 0; j < TNA; ++j) As[(ra + TRA * j) * LDA + ka] = wr[j];
    const float svf = __bfloat162float(sv);
#pragma unroll
    for (int j = 0; j < TNB; ++j) {
      const int k = kb + TKB * j, c = k0 + k;
      float sc, sh;
      if (SHFL) {
        sc = __shfl_sync(0xffffffffu, svf, j);
        sh = __shfl_sync(0xffffffffu, svf, j + 16);
      } else {
        sc = c < C ? __bfloat162float(__ldg(scale + c)) : 0.0f;
        sh = c < C ? __bfloat162float(__ldg(shift + c)) : 0.0f;
      }
      Pack<V> in, z;
      in.raw = xr[j];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float v = fmaf(__bfloat162float(__ushort_as_bfloat16(in.h[i])), sc,
                       sh);
        if (relu) v = fmaxf(v, 0.0f);
        if (!(c < C && n_ok)) v = 0.0f;
        z.h[i] = __bfloat16_as_ushort(__float2bfloat16(v));
      }
      *reinterpret_cast<word*>(Bs + k * TLDB + nb * V) = z.raw;
    }
    __syncthreads();
    if (k0 + BK < C) load(k0 + BK);  // overlaps the products below
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wo + 16 * i) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], Bs + kk * TLDB + wn + 16 * j, TLDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wo + 16 * i) * TLDC + wn + 16 * j,
                              acc[i][j], TLDC, wmma::mem_row_major);
  __syncthreads();
  if (!n_ok) return;
  // each thread writes its own V columns: rows kb, kb+TKB, ... of the tile
  __nv_bfloat16* ocol = out + (size_t)nbi * O * S + sp;
  for (int r = kb; r < TBO; r += TKB) {
    const int o = o0 + r;
    if (o >= O) continue;
    Pack<V> z;
#pragma unroll
    for (int i = 0; i < V; ++i)
      z.h[i] = __bfloat16_as_ushort(
          __float2bfloat16(Cs[r * TLDC + nb * V + i]));
    *reinterpret_cast<word*>(ocol + (size_t)o * S) = z.raw;
  }
}

__global__ void __launch_bounds__(NT)
bn_relu_conv1x1_f32(const float* __restrict__ x,
                    const float* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift,
                    float* __restrict__ out,
                    int C, int O, int S, int relu) {
  // W chunk kept transposed (k-major, padded to dodge bank conflicts) so
  // a thread's 8 rows are one broadcast read; thread (ty, tx) owns rows
  // ty*8..ty*8+7 and columns tx, tx+16, tx+32, tx+48 of the 64x64 tile
  __shared__ float As[BK][BO + 1];
  __shared__ float Bs[BK][BS];
  const int s0 = blockIdx.x * BS;
  const int o0 = blockIdx.y * BO;
  const size_t b = blockIdx.z;
  const float* xb = x + b * (size_t)C * S;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ka = tid % BK, ra = tid / BK;
  const int sb = tid % BS, kb = tid / BS;
  const int sp = s0 + sb;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  float wr[NA], xr[NB];
  const float* xcol = xb + sp;
  load_chunk<RA, KB>(wr, xr, w, xcol, 0, ka, kb, o0 + ra, sp < S, C, O, S,
                     0.0f);
  for (int k0 = 0; k0 < C; k0 += BK) {
#pragma unroll
    for (int j = 0; j < NA; ++j) As[ka][ra + RA * j] = wr[j];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int k = kb + KB * j, c = k0 + k;
      float z = 0.0f;
      if (c < C && sp < S) {
        z = fmaf(xr[j], __ldg(scale + c), __ldg(shift + c));
        if (relu) z = fmaxf(z, 0.0f);
      }
      Bs[k][sb] = z;
    }
    __syncthreads();
    if (k0 + BK < C)
      load_chunk<RA, KB>(wr, xr, w, xcol, k0 + BK, ka, kb, o0 + ra, sp < S,
                         C, O, S, 0.0f);
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[k][ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* ob = out + b * (size_t)O * S;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int o = o0 + ty * 8 + i;
    if (o >= O) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = s0 + tx + 16 * j;
      if (p < S) ob[(size_t)o * S + p] = acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (B, C, S), w (O, C), scale/shift (C),
// out (B, O, S), all contiguous in that dtype on the current device.
extern "C" int mxtt_bn_relu_conv1x1(int dtype, const void* x, const void* w,
                                    const void* scale, const void* shift,
                                    void* out, int B, int C, int O, int S,
                                    int relu, void* stream) {
  if (B < 1 || C < 1 || O < 1 || S < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((S + BS - 1) / BS, (O + BO - 1) / BO, B);
    bn_relu_conv1x1_f32<<<grid, NT, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)scale,
        (const float*)shift, (float*)out, C, O, S, relu);
  } else if (dtype == 1) {
    const long long n = (long long)B * S;
    const long long n_tiles = (n + TBN - 1) / TBN;
    if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((O + TBO - 1) / TBO, (unsigned)n_tiles);
    // widest access that S and both pointers' alignment allow
    const uintptr_t al = (uintptr_t)x | (uintptr_t)out;
    const int v = (S % 8 == 0 && al % 16 == 0)  ? 8
                  : (S % 4 == 0 && al % 8 == 0) ? 4
                  : (S % 2 == 0 && al % 4 == 0) ? 2
                                                : 1;
    const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
    const __nv_bfloat16* wb = (const __nv_bfloat16*)w;
    const __nv_bfloat16* sc = (const __nv_bfloat16*)scale;
    const __nv_bfloat16* sh = (const __nv_bfloat16*)shift;
    __nv_bfloat16* ob = (__nv_bfloat16*)out;
    if (v == 8)
      bn_relu_conv1x1_bf16<8><<<grid, TNT, 0, st>>>(xb, wb, sc, sh, ob, C, O,
                                                    S, (int)n, relu);
    else if (v == 4)
      bn_relu_conv1x1_bf16<4><<<grid, TNT, 0, st>>>(xb, wb, sc, sh, ob, C, O,
                                                    S, (int)n, relu);
    else if (v == 2)
      bn_relu_conv1x1_bf16<2><<<grid, TNT, 0, st>>>(xb, wb, sc, sh, ob, C, O,
                                                    S, (int)n, relu);
    else
      bn_relu_conv1x1_bf16<1><<<grid, TNT, 0, st>>>(xb, wb, sc, sh, ob, C, O,
                                                    S, (int)n, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The wgmma route (bn_gemm_wgmma.cuh), bf16 only. route: 1 = x through a
// 3-D tensor map (S % 8 == 0), 2 = x by one 1-D bulk copy per sample
// (per_tile whole samples a tile). The tiles, stages, shared-memory bytes
// and grid are the host plan's (_k1_plan); a plan this kernel cannot run
// is refused with cudaErrorInvalidValue before any launch.
extern "C" int mxtt_bn_relu_conv1x1_wgmma(
    const void* x, const void* w, const void* scale, const void* shift,
    void* out, int B, int C, int O, int S, int relu, int route, int bm,
    int bn, int stages, int per_tile, int smem_bytes, int grid,
    void* stream) {
  if (B < 1 || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == wg::K1_TMA)
    return wg::launch<wg::K1_TMA>(x, w, scale, shift, out, B, C, O, S, 0,
                                  relu, bm, bn, stages, per_tile,
                                  smem_bytes, grid, st);
  if (route == wg::K1_BULK)
    return wg::launch<wg::K1_BULK>(x, w, scale, shift, out, B, C, O, S, 0,
                                   relu, bm, bn, stages, per_tile,
                                   smem_bytes, grid, st);
  return (int)cudaErrorInvalidValue;
}
