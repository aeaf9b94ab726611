// The Hopper core of K1 (bn_relu_conv1x1.cu) and K3 (bn_relu_matmul.cu),
// bf16: one warp-specialised, persistent wgmma kernel for
//
//   out (rows x N) = z (rows x K) . W (K x N),
//   z[r, k] = round_to_bf16(act(x[r, k] * scale[k] + shift[k])).
//
// K3 (row-major x (M, K), W (K, N), out (M, N)) is this product as it
// stands. K1 (NCHW x (B, C, S), W (O, C), out (B, O, S)) is its transpose
// per sample, out^T (S x O) = z^T (S x C) . W^T (C x O), so that in both
// the normalised activation z is wgmma's A operand and lives only in
// registers: each consumer thread reads its raw x fragment from a ring
// stage in shared memory, applies scale/shift (+ReLU) in fp32, rounds once
// to bf16 (the rounding of the plain version) and hands the registers to
// wgmma.mma_async. z never touches shared or device memory. Sums are fp32;
// the output is rounded once.
//
// Block: 384 threads. Warpgroup 0 is the producer (one thread issues every
// copy, the others exit); warpgroups 1 and 2 are consumers. A tile is
// 256 rows x 128 columns (each consumer two m64n128k16 wgmmas per 16
// channels) or, where there are at least 256 output channels, 128 x 256
// (one m64n256k16), which halves the BN-apply work per product and the
// re-reads of x. A ring of `stages` (2-4, 3 at every ResNet-50 site)
// stages of BK = 64 channels, each marked full and empty by an mbarrier,
// lets the loads of later chunks (and of the next tile) run under the
// products; a consumer prepares the A registers of a chunk's four k16
// steps in four buffers, so each step's BN-apply overlaps the products
// issued before it. The grid is persistent (about one block per SM) and
// walks the tiles with the N tiles of one row tile adjacent, so the
// blocks that share an x tile run together and re-read it from L2.
//
// Operands and copies (every copy a multiple of 16 bytes):
//   W, the tile's columns x 64 channels a stage, one 2-D TMA tensor map
//   with 128-byte swizzle: K1's W (O, C) is K-major (wgmma B as is),
//   K3's W (K, N) N-major (64-column boxes, wgmma's transpose bit).
//   x, mode K3_TMA: one 2-D tensor map box (64 channels x the tile's
//   rows), 128-byte swizzle; A fragments by ldmatrix on swizzled rows.
//   x, mode K1_TMA (S % 8 == 0, so the channel stride S*2 is a multiple
//   of 16): a 3-D tensor map over (S, C, B), boxes of 64 positions x 64
//   channels; TMA zero-fills the ragged position tile; A fragments by
//   ldmatrix.trans.
//   x, mode K1_BULK (S % 8 != 0, S <= 256: the 14x14 and 7x7 sites, whose
//   channel stride of 392 or 98 bytes no tensor map can describe): a
//   sample's 64-channel chunk is one contiguous run of 64*S elements, so
//   one 1-D cp.async.bulk per sample per stage; a tile holds
//   per_tile = rows / S whole samples (7x7: 2 of 128 rows' worth, 98
//   rows used; 14x14: 1 in 256 rows, 196 used). Its rows are 98 or 392
//   bytes long, which ldmatrix cannot address, so the A fragments are
//   built with 16-bit shared loads (two per register) from the stage as
//   the bytes arrive; S = 49 and 196 are compiled as constants, so the
//   channel steps of those loads are immediate offsets.
// Epilogue: the fp32 accumulators are rounded to bf16 into a 64 KB
// staging buffer (swizzled as the store maps expect), then written by TMA
// stores (K3 rows; K1 transposed to S-contiguous boxes) or, in K1_BULK,
// by one 1-D bulk store per sample of its (N-tile x S) block, which is
// contiguous in NCHW. The stores run on while the next tile's products
// start. The outputs and K3's x are streamed once, so their L2 lines are
// marked evict-first (measured 6% off K3 at its bench shape).
//
// The route is planned on the host (ops/fused_bn_conv.py: _k1_plan,
// _k3_plan) from shapes and alignment, before the launch; the entry
// points check the plan against these constants and refuse a mismatch.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

namespace wg {

// Tiles: MW m64 wgmmas per consumer warpgroup, so BM = 128 * MW rows
// (positions, M) by BN = 256 / MW columns (O, N): 256 x 128 (MW = 2) or
// 128 x 256 (MW = 1); either way 128 fp32 accumulators a thread, a 48 KB
// stage and a 64 KB output staging buffer.
constexpr int BK = 64;                   // channels per ring stage
constexpr int NT = 384;                  // 1 producer + 2 consumer WGs
constexpr int SMEM_MAX = 232448;         // per block on an H100
constexpr int SLACK = 1024;              // to align the ring to 1024 B
constexpr int MAX_STAGES = 4;

enum Mode { K1_TMA = 1, K1_BULK = 2, K3_TMA = 3 };

// Shared-memory layout (the host plan computes the same numbers):
// [ring: stages x (x part, W part)][staging][(scale, shift) fp32 x C]
// [full[stages], empty[stages] mbarriers], after SLACK for alignment.
__host__ __device__ inline int x_stage_bytes(int mode, int per_tile, int S,
                                             int bm) {
  return mode == K1_BULK ? (per_tile * BK * S * 2 + 1023) / 1024 * 1024
                         : bm * BK * 2;
}

__host__ __device__ inline int smem_bytes(int mode, int per_tile, int S,
                                          int C, int stages, int bm,
                                          int bn) {
  return SLACK +
         stages * (x_stage_bytes(mode, per_tile, S, bm) + bn * BK * 2) +
         bm * bn * 2 + 8 * C + 16 * stages;
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// an L2 policy that evicts these lines first: for data streamed once
// (K3's x, the outputs), so they do not push out what is read again
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void tma_load_2d_hint(uint32_t dst,
                                                 const void* map,
                                                 uint32_t bar, int c0,
                                                 int c1, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const void* map, uint32_t src,
                                             int c0, int c1, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], %4;" ::"l"((uint64_t)map),
      "r"(src), "r"(c0), "r"(c1), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const void* map, uint32_t src,
                                             int c0, int c1, int c2,
                                             uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3, %4}], [%1], %5;" ::"l"((uint64_t)map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "l"(pol)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the staging buffer may be written again: earlier stores have read it
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// threads' shared-memory writes become visible to the async (TMA) proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}


__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving register traffic across a wgmma
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d (64 rows x 128 columns, fp32) += A (64 x 16, bf16, registers) .
// B (16 x 128, bf16, shared memory at `desc`); TB: B is N-major
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TB));
}


// the same with B 16 x 256
template <int TB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TB));
}

template <int BN, int TB>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[BN / 2],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  if constexpr (BN == 256)
    wgmma_m64n256k16<TB>(d, a, desc);
  else
    wgmma_m64n128k16<TB>(d, a, desc);
}

// ---------------------------------------------------------------------------
// the BN-apply on the register operand
// ---------------------------------------------------------------------------
__device__ __forceinline__ float bf16_bits(uint32_t u16) {
  return __uint_as_float(u16 << 16);
}

// two adjacent channels (k, k+1) of one row; ss = (scale[k], shift[k],
// scale[k+1], shift[k+1]); returns them rounded to bf16, k in the low half
__device__ __forceinline__ uint32_t norm_pair(float lo, float hi, float4 ss,
                                              int relu) {
  __nv_bfloat162 v =
      __floats2bfloat162_rn(fmaf(lo, ss.x, ss.y), fmaf(hi, ss.z, ss.w));
  // ReLU after the rounding: rounding is monotonic and keeps 0, so this
  // is the rounding of the fp32 ReLU, one max for the pair
  if (relu) v = __hmax2(v, __floats2bfloat162_rn(0.0f, 0.0f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t norm_word(uint32_t w, float4 ss,
                                              int relu) {
  return norm_pair(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u),
                   ss, relu);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
// Shapes: K1 modes: B samples, C channels, O outputs, S positions (M
// unused); K3: M rows, C = K, O = N (B, S unused). Tiles: rows (positions
// of one sample, per_tile whole samples, or rows of M) x BN columns,
// numbered with the column tiles fastest. SC: S as a compile-time
// constant (K1_BULK at ResNet-50's 49 and 196), so the channel steps of
// the A loads and output stores are immediate offsets; 0: S at run time.
template <int MODE, int MW, int SC>
__global__ void __launch_bounds__(NT, 1)
bn_gemm_wgmma(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap w_map,
              const __grid_constant__ CUtensorMap out_map,
              const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ scale,
              const __nv_bfloat16* __restrict__ shift,
              __nv_bfloat16* __restrict__ out, int B, int C, int O, int S,
              long long M, int relu, int per_tile, int stages) {
  constexpr int BM = 128 * MW, BN = 256 / MW;
  constexpr int X_BYTES = BM * BK * 2;    // x part of a stage (TMA modes)
  constexpr int B_BYTES = BN * BK * 2;    // W part of a stage
  constexpr int SUB_BYTES = 64 * BN * 2;  // staging of one m64 sub-tile
  if (SC) S = SC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int x_bytes = x_stage_bytes(MODE, per_tile, S, BM);
  const int stage_bytes = x_bytes + B_BYTES;
  unsigned char* staging = base + stages * stage_bytes;
  float2* ss = reinterpret_cast<float2*>(staging + BM * BN * 2);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ss + C);
  const uint32_t ring_u32 = smem_u32(base);
  const uint32_t staging_u32 = smem_u32(staging);
  const uint32_t full_u32 = smem_u32(bars);
  const uint32_t empty_u32 = full_u32 + 8 * stages;

  const int ntn = (O + BN - 1) / BN;
  const int mts = (S + BM - 1) / BM;  // K1_TMA: row tiles per sample
  const int m_tiles = MODE == K1_TMA    ? B * mts
                      : MODE == K1_BULK ? (B + per_tile - 1) / per_tile
                                        : (int)((M + BM - 1) / BM);
  const int n_tiles = m_tiles * ntn;
  const int nk = C / BK;

  const int tid = threadIdx.x;
  for (int c = tid; c < C; c += NT)
    ss[c] = make_float2(__bfloat162float(scale[c]),
                        __bfloat162float(shift[c]));
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_u32 + 8 * s, 1);
      mbar_init(empty_u32 + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------- producer: one thread keeps the ring full -----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid != 0) return;
    const uint64_t stream = l2_evict_first();
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int o0 = (tile % ntn) * BN;
      const int mt = tile / ntn;
      for (int kc = 0; kc < nk; ++kc) {
        mbar_wait(empty_u32 + 8 * stage, phase ^ 1);
        const uint32_t a = ring_u32 + stage * stage_bytes;
        const uint32_t b = a + x_bytes;
        const uint32_t fb = full_u32 + 8 * stage;
        const int c0 = kc * BK;
        if (MODE == K1_TMA) {
          const int bi = mt / mts, s0 = (mt % mts) * BM;
          mbar_expect_tx(fb, X_BYTES + B_BYTES);
#pragma unroll
          for (int h = 0; h < BM / 64; ++h)
            tma_load_3d(a + h * 8192, &x_map, fb, s0 + 64 * h, c0, bi);
          tma_load_2d(b, &w_map, fb, c0, o0);
        } else if (MODE == K1_BULK) {
          const int b0 = mt * per_tile;
          const int np = min(per_tile, B - b0);
          const uint32_t chunk = BK * S * 2;
          mbar_expect_tx(fb, np * chunk + B_BYTES);
          for (int p = 0; p < np; ++p)
            bulk_load(a + p * chunk, x + ((size_t)(b0 + p) * C + c0) * S,
                      chunk, fb);
          tma_load_2d(b, &w_map, fb, c0, o0);
        } else {
          mbar_expect_tx(fb, X_BYTES + B_BYTES);
          tma_load_2d_hint(a, &x_map, fb, c0, mt * BM, stream);
#pragma unroll
          for (int i = 0; i < BN / 64; ++i)
            tma_load_2d(b + i * 8192, &w_map, fb, o0 + 64 * i, c0);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---------------- consumers: normalise, multiply, store ---------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int ct = tid - 128;
  const int wgi = ct >> 7;          // consumer warpgroup: rows wgi*BM/2..
  const int cw = (ct >> 5) & 3;     // warp in it: rows +cw*16.. per m64
  const int lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;     // accumulator / A layout
  const int lj = lane >> 3, l8 = lane & 7;   // ldmatrix: matrix, row
  const uint64_t stream = l2_evict_first();
  int stage = 0;
  uint32_t phase = 0;
  float acc[MW][BN / 2];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int o0 = (tile % ntn) * BN;
    const int mt = tile / ntn;
    // K1_BULK: element offset in a stage of row g / g+8 of each m64 at
    // channel 2t, and in the staging buffer (per-sample blocks) at output
    // column 2t, or -1 past the last sample of the tile
    int roff[2][2] = {{0, 0}, {0, 0}}, soff[2][2] = {{-1, -1}, {-1, -1}};
    int np = 1;
    if (MODE == K1_BULK) {
      np = min(per_tile, B - mt * per_tile);
#pragma unroll
      for (int mw = 0; mw < MW; ++mw)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wgi * 64 * MW + mw * 64 + cw * 16 + g + 8 * h;
          const int p = r / S, s = r - p * S;
          roff[mw][h] = (p < np ? p * BK * S + s : 0) + 2 * t * S;
          soff[mw][h] = p < np ? p * BN * S + s + 2 * t * S : -1;
        }
    }
#pragma unroll
    for (int mw = 0; mw < MW; ++mw)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mw][i] = 0.0f;

    for (int kc = 0; kc < nk; ++kc) {
      mbar_wait(full_u32 + 8 * stage, phase);
      const uint32_t a_u32 = ring_u32 + stage * stage_bytes;
      const uint32_t b_u32 = a_u32 + x_bytes;
      const unsigned short* xs =
          reinterpret_cast<const unsigned short*>(base + stage * stage_bytes);
      const float4* ssk = reinterpret_cast<const float4*>(ss + kc * BK);
      uint32_t afr[BK / 16][MW][4];
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        // channels ks*16 + 2t, +1 (s_lo) and + 8, + 9 (s_hi) of the chunk
        const float4 s_lo = ssk[ks * 8 + t];
        const float4 s_hi = ssk[ks * 8 + t + 4];
#pragma unroll
        for (int mw = 0; mw < MW; ++mw) {
          uint32_t* f = afr[ks][mw];
          if (MODE == K1_BULK) {
            const unsigned short* r0 = xs + roff[mw][0] + ks * 16 * S;
            const unsigned short* r1 = xs + roff[mw][1] + ks * 16 * S;
            f[0] = norm_pair(bf16_bits(r0[0]), bf16_bits(r0[S]), s_lo, relu);
            f[1] = norm_pair(bf16_bits(r1[0]), bf16_bits(r1[S]), s_lo, relu);
            f[2] = norm_pair(bf16_bits(r0[8 * S]), bf16_bits(r0[9 * S]),
                             s_hi, relu);
            f[3] = norm_pair(bf16_bits(r1[8 * S]), bf16_bits(r1[9 * S]),
                             s_hi, relu);
          } else {
            uint32_t raw[4];
            const int r0 = wgi * 64 * MW + mw * 64 + cw * 16;  // warp rows
            if (MODE == K3_TMA) {
              // rows r0 + (lj&1)*8 + l8, channels 16ks + (lj>>1)*8: the
              // 16-byte chunk 2ks + (lj>>1) of a 128-byte row, swizzled
              // by the row's index mod 8 (= l8)
              const int row = r0 + (lj & 1) * 8 + l8;
              ldsm_x4(a_u32 + row * 128 + (((2 * ks + (lj >> 1)) ^ l8) << 4),
                      raw);
            } else {
              // x stage: boxes of (64 channel rows x 64 positions);
              // channel row c, chunk of 8 positions swizzled by c mod 8
              const int c = ks * 16 + (lj >> 1) * 8 + l8;
              const int chunk = ((r0 & 63) >> 3) + (lj & 1);
              ldsm_x4_trans(a_u32 + (r0 >> 6) * 8192 + c * 128 +
                                ((chunk ^ l8) << 4),
                            raw);
            }
            f[0] = norm_word(raw[0], s_lo, relu);
            f[1] = norm_word(raw[1], s_lo, relu);
            f[2] = norm_word(raw[2], s_hi, relu);
            f[3] = norm_word(raw[3], s_hi, relu);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) reg_fence(f[i]);
        }
        // B: K1's W tile is K-major (rows of 64 channels, 1024 B per 8
        // rows; a k16 step is 32 B along the row); K3's is N-major
        // (64-column boxes 8 KB apart; a k16 step is 16 rows, 2 KB)
        const uint64_t desc =
            MODE == K3_TMA ? sw128_desc(b_u32 + ks * 2048, 8192, 1024)
                           : sw128_desc(b_u32 + ks * 32, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int mw = 0; mw < MW; ++mw)
          wgmma_m64k16<BN, MODE == K3_TMA ? 1 : 0>(acc[mw], afr[ks][mw],
                                                   desc);
        wgmma_commit();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mw = 0; mw < MW; ++mw)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) reg_fence(acc[mw][i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_u32 + 8 * stage);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---------------- epilogue ----------------
    if (ct == 0) bulk_wait_read();  // the last tile's stores left staging
    consumers_sync();
#pragma unroll
    for (int mw = 0; mw < MW; ++mw) {
      unsigned char* sb = staging + (wgi * MW + mw) * SUB_BYTES;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float* v = acc[mw] + 4 * j;
        if (MODE == K3_TMA) {
          // rows m (g, g+8 of warp cw), 64-column box j/8, swizzled
          // 16-byte chunk (j%8) ^ (m%8) of the 128-byte row
          unsigned char* p = sb + (j >> 3) * 8192 + (cw * 16 + g) * 128 +
                             (((j & 7) ^ g) << 4) + t * 4;
          *reinterpret_cast<uint32_t*>(p) = pack_bf16(v[0], v[1]);
          *reinterpret_cast<uint32_t*>(p + 8 * 128) = pack_bf16(v[2], v[3]);
        } else if (MODE == K1_TMA) {
          // transposed: box j/8 of 64 output rows x 64 positions; row o,
          // 16-byte chunk (m/8) ^ (o%8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int o = (j & 7) * 8 + 2 * t + (e & 1);
            const int m8 = cw * 2 + (e >> 1);
            __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(
                sb + (j >> 3) * 8192 + o * 128 + ((m8 ^ (o & 7)) << 4) +
                g * 2);
            *p = __float2bfloat16(v[e]);
          }
        } else {
          // per sample p, an (N tile x S) block, S-contiguous rows
          __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(staging);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int off = soff[mw][e >> 1];
            if (off >= 0)
              st[off + (j * 8 + (e & 1)) * S] = __float2bfloat16(v[e]);
          }
        }
      }
    }
    fence_proxy_async();
    consumers_sync();
    if (ct == 0) {
      if (MODE == K3_TMA) {
        const long long m0 = (long long)mt * BM;
        for (int sub = 0; sub < BM / 64; ++sub)
          for (int bx = 0; bx < BN / 64; ++bx)
            if (m0 + sub * 64 < M && o0 + bx * 64 < O)
              tma_store_2d(&out_map,
                           staging_u32 + sub * SUB_BYTES + bx * 8192,
                           o0 + bx * 64, (int)(m0 + sub * 64), stream);
      } else if (MODE == K1_TMA) {
        const int bi = mt / mts, s0 = (mt % mts) * BM;
        for (int sub = 0; sub < BM / 64; ++sub)
          for (int bx = 0; bx < BN / 64; ++bx)
            if (s0 + sub * 64 < S && o0 + bx * 64 < O)
              tma_store_3d(&out_map,
                           staging_u32 + sub * SUB_BYTES + bx * 8192,
                           s0 + sub * 64, o0 + bx * 64, bi, stream);
      } else {
        const int b0 = mt * per_tile;
        const uint32_t bytes = min(BN, O - o0) * S * 2;
        for (int p = 0; p < np; ++p)
          bulk_store(out + ((size_t)(b0 + p) * O + o0) * S,
                     staging_u32 + p * BN * S * 2, bytes);
      }
      bulk_commit();
    }
  }
  if (ct == 0) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// host side: tensor maps and the launch
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process has loaded (no
// link against it, so the library builds with nvcc alone)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h) fn = (EncodeTiledFn)dlsym(h, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// a bf16 tensor map with 128-byte swizzle; dims innermost first, strides
// in bytes of dims 1.. (rank - 1 of them); 0 on success
inline int make_map(CUtensorMap* map, const void* ptr, int rank,
                    const cuuint64_t* dims, const cuuint64_t* strides,
                    const cuuint32_t* box) {
  const EncodeTiledFn f = encode_tiled();
  if (!f) return (int)cudaErrorSharedObjectInitFailed;
  const cuuint32_t es[3] = {1, 1, 1};
  const CUresult r = f(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                       const_cast<void*>(ptr), dims, strides, box, es,
                       CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_128B,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Checks the host plan (tiles, stages, shared memory, grid) against this
// kernel, builds the tensor maps of `mode` and launches. 0 = launched.
template <int MODE, int MW, int SC>
int launch_sc(const void* x, const void* w, const void* scale,
           const void* shift, void* out, int B, int C, int O, int S,
           long long M, int relu, int bm, int bn, int stages,
           int per_tile, int plan_smem, int grid, cudaStream_t st) {
  constexpr int BM = 128 * MW, BN = 256 / MW;
  if (bm != BM || bn != BN || stages < 2 ||
      stages > MAX_STAGES || grid < 1 || C < BK || C % BK || O < 1 ||
      O % 8 || !aligned16(x) || !aligned16(w) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if (MODE == K1_BULK && (per_tile < 1 || per_tile * S > BM))
    return (int)cudaErrorInvalidValue;
  if (MODE != K1_BULK && per_tile != 1) return (int)cudaErrorInvalidValue;
  if (MODE == K1_TMA && S % 8) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(MODE, per_tile, S, C, stages, BM, BN);
  if (smem != plan_smem || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap xm, wm, om;
  memset(&xm, 0, sizeof(xm));
  memset(&wm, 0, sizeof(wm));
  memset(&om, 0, sizeof(om));
  int rc = 0;
  if (MODE == K3_TMA) {
    // x (M, K), W (K, N), out (M, N), all row-major
    const cuuint64_t xd[2] = {(cuuint64_t)C, (cuuint64_t)M};
    const cuuint64_t xs[1] = {(cuuint64_t)C * 2};
    const cuuint32_t xb[2] = {BK, BM};
    const cuuint64_t wd[2] = {(cuuint64_t)O, (cuuint64_t)C};
    const cuuint64_t ws[1] = {(cuuint64_t)O * 2};
    const cuuint32_t wb[2] = {64, BK};
    const cuuint64_t od[2] = {(cuuint64_t)O, (cuuint64_t)M};
    const cuuint32_t ob[2] = {64, 64};
    rc = make_map(&xm, x, 2, xd, xs, xb);
    if (!rc) rc = make_map(&wm, w, 2, wd, ws, wb);
    if (!rc) rc = make_map(&om, out, 2, od, ws, ob);
  } else {
    // x (B, C, S), W (O, C), out (B, O, S)
    const cuuint64_t wd[2] = {(cuuint64_t)C, (cuuint64_t)O};
    const cuuint64_t ws[1] = {(cuuint64_t)C * 2};
    const cuuint32_t wb[2] = {BK, BN};
    rc = make_map(&wm, w, 2, wd, ws, wb);
    if (MODE == K1_TMA && !rc) {
      const cuuint64_t xd[3] = {(cuuint64_t)S, (cuuint64_t)C, (cuuint64_t)B};
      const cuuint64_t xs[2] = {(cuuint64_t)S * 2, (cuuint64_t)C * S * 2};
      const cuuint32_t xb[3] = {64, BK, 1};
      const cuuint64_t od[3] = {(cuuint64_t)S, (cuuint64_t)O, (cuuint64_t)B};
      const cuuint64_t os[2] = {(cuuint64_t)S * 2, (cuuint64_t)O * S * 2};
      const cuuint32_t ob[3] = {64, 64, 1};
      rc = make_map(&xm, x, 3, xd, xs, xb);
      if (!rc) rc = make_map(&om, out, 3, od, os, ob);
    }
  }
  if (rc) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      bn_gemm_wgmma<MODE, MW, SC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  bn_gemm_wgmma<MODE, MW, SC><<<grid, NT, smem, st>>>(
      xm, wm, om, (const __nv_bfloat16*)x, (const __nv_bfloat16*)scale,
      (const __nv_bfloat16*)shift, (__nv_bfloat16*)out, B, C, O, S, M, relu,
      per_tile, stages);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch(const void* x, const void* w, const void* scale,
           const void* shift, void* out, int B, int C, int O, int S,
           long long M, int relu, int bm, int bn, int stages,
           int per_tile, int plan_smem, int grid, cudaStream_t st) {
#define WG_LAUNCH(MW, SC)                                                   \
  launch_sc<MODE, MW, SC>(x, w, scale, shift, out, B, C, O, S, M, relu, bm, \
                          bn, stages, per_tile, plan_smem, grid, st)
  if (bm == 128) {
    if (MODE == K1_BULK && S == 49) return WG_LAUNCH(1, 49);
    return WG_LAUNCH(1, 0);
  }
  if (MODE == K1_BULK && S == 49) return WG_LAUNCH(2, 49);
  if (MODE == K1_BULK && S == 196) return WG_LAUNCH(2, 196);
  return WG_LAUNCH(2, 0);
#undef WG_LAUNCH
}

}  // namespace wg
