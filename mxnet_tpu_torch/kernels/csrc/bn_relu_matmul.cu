// Fused BatchNorm-apply (+ReLU) + matrix product, row-major, for Hopper
// (sm_90a).
//
//   out[m, n] = sum_k z[m, k] * W[k, n]
//   z[m, k]   = round_to_T(act(x[m, k] * scale[k] + shift[k]))
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_fused.py::_make_kernel
// (_fused_matmul's pallas_call, the public bn_relu_matmul). As there, the
// normalised activation z never reaches device memory: each (M, K) tile
// of x is normalised and rounded to the input type while it is staged
// into shared memory, then multiplied by the (K, N) tile of W with fp32
// sums.
//
// The layouts are the transpose of the NCHW kernel's (bn_relu_conv1x1.cu):
// x is K-contiguous, so a thread stages V adjacent channels of one row
// with one access and takes their V scales and shifts with one access
// each (they run along a row here, along a column there); W and the
// output are N-contiguous, so they move V adjacent columns at a time.
// V = 8, 4, 2 or 1: the widest that K, N and every pointer's alignment
// allow.
//
// Bound on an H100: the operations per byte moved are about
// M*N*K/(M*K + K*N + M*N) (bf16). At the bench tool's default shape
// (M = 401,408, K = 64, N = 256) that is ~51 flop/byte, under the
// ridge of ~295, so the kernel is bound by its bytes: read x once per
// 64-wide column tile, write out once.
//
// Design. bf16 has two routes, chosen on the host before the launch by
// ops/fused_bn_conv.py::_k3_plan from shapes and pointer alignment:
//   - wgmma (bn_gemm_wgmma.cuh, shared with K1; entry
//     mxtt_bn_relu_matmul_wgmma): K a multiple of 64, N of 8, every
//     pointer 16-byte aligned (the bench shape and ResNet-50's 1x1 shapes
//     in NHWC). x is wgmma's register operand (ldmatrix from a swizzled
//     TMA stage, BN-apply and ReLU in fp32, one rounding), W the shared
//     operand (N-major: wgmma's transpose bit); a producer warp keeps a
//     3-stage mbarrier ring full by TMA, a persistent grid walks 256 x
//     128 output tiles with the N tiles of one row tile adjacent (x
//     re-read from L2), and each tile leaves through a staged TMA store
//     that overlaps the next tile. The WMMA kernel below had, at K = 64,
//     two register-staged chunks a block and little else to overlap.
//   - wmma (bn_relu_matmul_bf16 below, entry mxtt_bn_relu_matmul): the
//     other shapes. One block of 256 threads per 128 x 64 output tile; 8
//     warps (4 x 2) each multiply a 32x32 sub-tile with wmma 16x16x16
//     bf16 fragments into fp32 accumulators; the output tile goes
//     through shared memory so its rows are written V columns at a time.
//   - fp32: one block of 128 threads per 64 x 64 tile; each thread
//     accumulates an 8x4 block with fp32 FMA (no TF32).
// The wmma and fp32 kernels walk K in chunks of 32; a thread's share of
// the next chunk is loaded into registers before the current chunk's
// products. Every edge is masked: any M, K and N. The M tiles run along
// grid x (up to 2^31 - 1), the N tiles along grid y.
//
// C interface, loaded with ctypes; returns cudaGetLastError() after the
// launch (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "bn_gemm_wgmma.cuh"

namespace {

constexpr int BK = 32;   // channels (K) per shared-memory chunk

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

// bf16 tile: 128 rows (m) x 64 columns (n), 256 threads, 8 warps (4 x 2)
constexpr int HBM = 128;
constexpr int HBN = 64;
constexpr int HNT = 256;
constexpr int HLDA = BK + 8;    // padded leading dimensions: multiples of
constexpr int HLDB = HBN + 8;   // 8 bf16 / 4 fp32 elements, as wmma needs
constexpr int HLDC = HBN + 4;
constexpr int HA_BYTES = HBM * HLDA * 2;
constexpr int HB_BYTES = BK * HLDB * 2;
constexpr int HC_BYTES = HBM * HLDC * 4;
constexpr int HSMEM = (HA_BYTES + HB_BYTES > HC_BYTES) ? HA_BYTES + HB_BYTES
                                                       : HC_BYTES;

template <int V>
__global__ void __launch_bounds__(HNT, 2)
bn_relu_matmul_bf16(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const __nv_bfloat16* __restrict__ scale,
                    const __nv_bfloat16* __restrict__ shift,
                    __nv_bfloat16* __restrict__ out,
                    int M, int K, int N, int relu) {
  using namespace nvcuda;
  typedef typename Vec<V>::T word;
  constexpr int XC = BK / V;        // x words per staged row
  constexpr int XR = HNT / XC;      // row step of a thread's x words
  constexpr int NX = HBM / XR;      // x words per thread per chunk
  constexpr int WC = HBN / V;       // W words per staged row
  constexpr int WR = HNT / WC;      // row step of a thread's W words
  constexpr int NW = BK / WR;       // W words per thread per chunk
  // the staged chunks and, after the main loop, the fp32 output tile
  // share one buffer
  __shared__ __align__(128) unsigned char smem[HSMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + HA_BYTES);
  float* Cs = reinterpret_cast<float*>(smem);

  const long long m0 = (long long)blockIdx.x * HBM;
  const int n0 = blockIdx.y * HBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;    // warp's sub-tile origin (rows = m)
  const int wn = (warp % 2) * 32;    //                         (cols = n)
  // x chunk: this thread's channels kx..kx+V-1 (fixed), rows rx + XR*j
  const int kx = (tid % XC) * V, rx = tid / XC;
  // W chunk: this thread's columns nw..nw+V-1 (fixed), rows kw + WR*j
  const int nw = (tid % WC) * V, kw = tid / WC;
  const bool nw_ok = n0 + nw < N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  word xr[NX], wr[NW], scr, shr;
  auto load = [&](int k0) {
    const int k = k0 + kx;            // K % V == 0: a word is in or out
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const long long m = m0 + rx + XR * j;
      xr[j] = (m < M && k < K)
                  ? *reinterpret_cast<const word*>(x + m * K + k)
                  : word();
    }
    scr = k < K ? *reinterpret_cast<const word*>(scale + k) : word();
    shr = k < K ? *reinterpret_cast<const word*>(shift + k) : word();
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int kk = k0 + kw + WR * j;
      wr[j] = (kk < K && nw_ok)
                  ? *reinterpret_cast<const word*>(w + (size_t)kk * N + n0 +
                                                   nw)
                  : word();
    }
  };
  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage the chunk held in registers, normalising x on the way
    Pack<V> sc, sh;
    sc.raw = scr;
    sh.raw = shr;
    float scf[V], shf[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      scf[i] = __bfloat162float(__ushort_as_bfloat16(sc.h[i]));
      shf[i] = __bfloat162float(__ushort_as_bfloat16(sh.h[i]));
    }
    const bool k_ok = k0 + kx < K;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const int r = rx + XR * j;
      const bool ok = k_ok && m0 + r < M;
      Pack<V> in, z;
      in.raw = xr[j];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float v = fmaf(__bfloat162float(__ushort_as_bfloat16(in.h[i])),
                       scf[i], shf[i]);
        if (relu) v = fmaxf(v, 0.0f);
        if (!ok) v = 0.0f;
        z.h[i] = __bfloat16_as_ushort(__float2bfloat16(v));
      }
      *reinterpret_cast<word*>(As + r * HLDA + kx) = z.raw;
    }
#pragma unroll
    for (int j = 0; j < NW; ++j)
      *reinterpret_cast<word*>(Bs + (kw + WR * j) * HLDB + nw) = wr[j];
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // overlaps the products below
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * HLDA + kk, HLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], Bs + kk * HLDB + wn + 16 * j, HLDB);
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
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * HLDC + wn + 16 * j,
                              acc[i][j], HLDC, wmma::mem_row_major);
  __syncthreads();
  if (!nw_ok) return;
  // each thread writes V adjacent columns of rows kw, kw + WR, ...
  for (int r = kw; r < HBM; r += WR) {
    const long long m = m0 + r;
    if (m >= M) break;
    Pack<V> z;
#pragma unroll
    for (int i = 0; i < V; ++i)
      z.h[i] = __bfloat16_as_ushort(__float2bfloat16(Cs[r * HLDC + nw + i]));
    *reinterpret_cast<word*>(out + m * N + n0 + nw) = z.raw;
  }
}

// fp32 tile: 64 x 64, 128 threads, thread (ty, tx) owns rows ty*8..ty*8+7
// and columns tx, tx+16, tx+32, tx+48
constexpr int FBM = 64;
constexpr int FBN = 64;
constexpr int FNT = 128;
constexpr int FNX = FBM * BK / FNT;   // x elements per thread per chunk
constexpr int FRX = FNT / BK;         // row step of a thread's x elements
constexpr int FNW = BK * FBN / FNT;   // W elements per thread per chunk
constexpr int FRW = FNT / FBN;        // row step of a thread's W elements

__global__ void __launch_bounds__(FNT)
bn_relu_matmul_f32(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, float* __restrict__ out,
                   int M, int K, int N, int relu) {
  // the x chunk kept transposed (k-major, padded off the bank stride) so
  // a thread's 8 rows are one broadcast read
  __shared__ float As[BK][FBM + 1];
  __shared__ float Bs[BK][FBN];
  const long long m0 = (long long)blockIdx.x * FBM;
  const int n0 = blockIdx.y * FBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int kx = tid % BK, rx = tid / BK;   // x: channel, first row
  const int nb = tid % FBN, kb = tid / FBN; // W: column, first row
  const bool n_ok = n0 + nb < N;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  float xr[FNX], wr[FNW], sc = 0.0f, sh = 0.0f;
  auto load = [&](int k0) {
    const int k = k0 + kx;
#pragma unroll
    for (int j = 0; j < FNX; ++j) {
      const long long m = m0 + rx + FRX * j;
      xr[j] = (m < M && k < K) ? x[m * K + k] : 0.0f;
    }
    sc = k < K ? __ldg(scale + k) : 0.0f;
    sh = k < K ? __ldg(shift + k) : 0.0f;
#pragma unroll
    for (int j = 0; j < FNW; ++j) {
      const int kk = k0 + kb + FRW * j;
      wr[j] = (kk < K && n_ok) ? w[(size_t)kk * N + n0 + nb] : 0.0f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool k_ok = k0 + kx < K;
#pragma unroll
    for (int j = 0; j < FNX; ++j) {
      const int r = rx + FRX * j;
      float z = 0.0f;
      if (k_ok && m0 + r < M) {
        z = fmaf(xr[j], sc, sh);
        if (relu) z = fmaxf(z, 0.0f);
      }
      As[kx][r] = z;
    }
#pragma unroll
    for (int j = 0; j < FNW; ++j) Bs[kb + FRW * j][nb] = wr[j];
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
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

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (M, K), w (K, N), scale/shift (K),
// out (M, N), all contiguous in that dtype on the current device.
extern "C" int mxtt_bn_relu_matmul(int dtype, const void* x, const void* w,
                                   const void* scale, const void* shift,
                                   void* out, long long M, int K, int N,
                                   int relu, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const long long mt = (M + FBM - 1) / FBM;
    const int nt = (N + FBN - 1) / FBN;
    if (mt > 2147483647LL || nt > 65535) return (int)cudaErrorInvalidValue;
    bn_relu_matmul_f32<<<dim3((unsigned)mt, nt), FNT, 0, st>>>(
        (const float*)x, (const float*)w, (const float*)scale,
        (const float*)shift, (float*)out, (int)M, K, N, relu);
  } else if (dtype == 1) {
    const long long mt = (M + HBM - 1) / HBM;
    const int nt = (N + HBN - 1) / HBN;
    if (mt > 2147483647LL || nt > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)mt, nt);
    // widest access that K, N and every pointer's alignment allow
    const uintptr_t al = (uintptr_t)x | (uintptr_t)w | (uintptr_t)scale |
                         (uintptr_t)shift | (uintptr_t)out;
    const int kn = K | N;
    const int v = (kn % 8 == 0 && al % 16 == 0)  ? 8
                  : (kn % 4 == 0 && al % 8 == 0) ? 4
                  : (kn % 2 == 0 && al % 4 == 0) ? 2
                                                 : 1;
    const __nv_bfloat16* xb = (const __nv_bfloat16*)x;
    const __nv_bfloat16* wb = (const __nv_bfloat16*)w;
    const __nv_bfloat16* sc = (const __nv_bfloat16*)scale;
    const __nv_bfloat16* sh = (const __nv_bfloat16*)shift;
    __nv_bfloat16* ob = (__nv_bfloat16*)out;
    const int m = (int)M;
    if (v == 8)
      bn_relu_matmul_bf16<8><<<grid, HNT, 0, st>>>(xb, wb, sc, sh, ob, m, K,
                                                   N, relu);
    else if (v == 4)
      bn_relu_matmul_bf16<4><<<grid, HNT, 0, st>>>(xb, wb, sc, sh, ob, m, K,
                                                   N, relu);
    else if (v == 2)
      bn_relu_matmul_bf16<2><<<grid, HNT, 0, st>>>(xb, wb, sc, sh, ob, m, K,
                                                   N, relu);
    else
      bn_relu_matmul_bf16<1><<<grid, HNT, 0, st>>>(xb, wb, sc, sh, ob, m, K,
                                                   N, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The wgmma route (bn_gemm_wgmma.cuh), bf16 only; tiles, stages,
// shared-memory bytes and grid are the host plan's (_k3_plan); a plan this
// kernel cannot run is refused with cudaErrorInvalidValue before any
// launch.
extern "C" int mxtt_bn_relu_matmul_wgmma(
    const void* x, const void* w, const void* scale, const void* shift,
    void* out, long long M, int K, int N, int relu, int bm, int bn,
    int stages, int smem_bytes, int grid, void* stream) {
  if (M < 1 || M > 2147483647LL) return (int)cudaErrorInvalidValue;
  return wg::launch<wg::K3_TMA>(x, w, scale, shift, out, 1, K, N, 1, M,
                                relu, bm, bn, stages, 1, smem_bytes,
                                grid, (cudaStream_t)stream);
}
