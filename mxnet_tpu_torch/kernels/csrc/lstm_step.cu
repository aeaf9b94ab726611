// L1 on Hopper, bf16: one LSTM step as one kernel each way, the cell
// fused into the recurrent product (sm_90a, wgmma; the TMA, mbarrier and
// descriptor helpers of bn_gemm_wgmma.cuh).
//
// Replaces no pallas_call: the JAX package computes the cell as jnp
// (mxnet_tpu/ops/nn.py:486-495, _lstm_cell_step) inside lax.scan
// (_run_layer, :518), and XLA fuses it behind its dot. In the PyTorch
// port before this kernel a step ran the recurrent product on cuBLAS and
// the cell (kernels/lstm_cell_triton.py) as a second launch that read the
// product back; the backward ran the cell, then two products a step.
//
// lstm_step_fwd, one step t:
//   z = xg_t + h_prev . Wh^T + b       (fp32 sums of bf16 products)
//   i, f, o = sigmoid(z_i, z_f, z_o); g = tanh(z_g)
//   c = f * c_prev + i * g;  h = o * tanh(c)
// The cell is the product's epilogue: the (N, 4H) product is never
// written. A block computes a BM x BN tile of the product with the h_prev
// tile as wgmma's A operand (ldmatrix from a 128-byte-swizzled TMA box)
// and Wh as B, from a ring of 64-column K chunks filled by one producer
// thread. Wh is staged once per layer call (ops/lstm_cell.py,
// stage_recurrent_weight) with its gate rows interleaved: staged row
// 64 * p + 16 * q + j is gate q's row of unit 16 * p + j (zeros past H),
// so wgmma's accumulator layout gives each thread all four gates of the
// units it holds (n8 blocks 2q and 2q + 1 of every 64 columns). h is
// written to ys[t] and to a recurrent buffer whose row stride is a
// multiple of 16 bytes, the next step's TMA source (H = 650 gives rows of
// 1300 bytes, which no tensor map can describe); c to the cell buffer;
// with grad, z rounded to bf16 in the reference gate order: the backward
// reads it in place of the product it would otherwise recompute. K runs
// in k16 steps up to H; TMA fills the columns past H with zeros.
//
// lstm_step_bwd, one step back, t:
//   dh = dy_t + dh_rec                 (the gradient of ys[t] and the
//                                       previous backward step's dh_prev)
//   i, f, g, o from z_t; c = f * c_prev + i * g; tc = tanh(c)
//   dct = dc + dh * o * (1 - tc^2)
//   dz = (dct*g*i*(1-i), dct*c_prev*f*(1-f), dct*i*(1-g^2),
//         dh*tc*o*(1-o))              -> dz, bf16, the gradient of xg_t
//   dc_prev = dct * f                  (fp32)
//   dh_prev = dz . Wh                  (fp32 sums, dz rounded to bf16)
// dz is wgmma's A operand in registers (wgmma.mma_async with A from
// registers, B from shared memory), never a product of its own: the
// product is split along K by ranges of units, all four gates of a unit
// in one slice, so each dz element is computed and stored by exactly one
// block. The staged copy's K order puts a unit's four gates in one
// thread's A fragment (k16 step 4p + k holds units 16p + 4t' + k, t' =
// 0..3: i and f of unit 16p + 4t + k in columns 2t, 2t+1, g and o in
// 2t+8, 2t+9). A block holds 64 rows and every output column (three
// warpgroups of m64n224). Its threads compute the slice's dz in
// registers from coalesced loads (unit pairs along rows), store it, and
// place each value into a shared-memory stash in fragment order; each
// warpgroup then loads its fragments from the stash into the registers
// wgmma reads. The K slices of a row tile form a thread-block cluster:
// each block leaves its fp32 partial product in its shared memory, and
// rank r sums rows [r * 64 / S, (r + 1) * 64 / S) of every block's
// partial through distributed shared memory, rank by rank in a fixed
// order. No atomics: a replay gives the same bits as an eager call.
//
// Bounds on an H100 at (N, H) = (512, 650): 1.73 GFLOP each way (1.7 us
// at 989 TFLOP/s) against ~11-13 MB (3.4-4.0 us at 3.35 TB/s): bytes. The
// kernels are thin products (M = 512) whose time goes to the launch, the
// re-reads of Wh from L2 per row tile and, backward, the cluster's sum.
//
// The host plans tiles, slices, stages, shared memory and grid
// (ops/lstm_cell.py, _l1_plan) before the launch; the entry points refuse
// a plan that disagrees with these constants.

#include "bn_gemm_wgmma.cuh"

namespace ls {

using namespace wg;

constexpr int KC = 64;                 // K columns a ring stage
constexpr int FWD_NT = 384;            // producer WG + 2 consumer WGs
constexpr int BWD_NT = 384;            // 3 consumer WGs (thread 0 loads)
constexpr int BWD_NW = 224;            // output columns a consumer WG
constexpr int BWD_COLS = 3 * BWD_NW;   // 672: H <= 672
constexpr int BWD_RS = BWD_COLS + 8;   // fp32 row stride of the partial
constexpr int BWD_STAGE = BWD_COLS * 128;   // B bytes a stage (86016)
constexpr int STASH_STEP = 128 * 16;   // one k16 step's A fragments

// the forward's epilogue tile, bf16: xg (4 gates x BM rows x PU), c and
// h (BM x PU each), b (4 x BU); BU = BN / 4 units, PU = BU + 8 (rows 8
// elements apart in banks: a warp's reads of g, g + 8 rows and 2t
// columns hit 32 distinct banks)
__host__ __device__ inline int fwd_epi_bytes(int bm, int bn) {
  const int bu = bn / 4, pu = bu + 8;
  return (2 * (6 * bm * pu + 4 * bu) + 15) / 16 * 16;
}

// [ring][epilogue tile][full[stages], empty[stages], epi]
__host__ __device__ inline int fwd_smem(int bm, int bn, int stages) {
  return SLACK + stages * (bm + bn) * 128 + fwd_epi_bytes(bm, bn) +
         16 * stages + 16;
}

// [ring][A stash][bars]; the partial (64 x BWD_RS fp32) reuses ring+stash
__host__ __device__ inline int bwd_smem(int max_steps, int stages) {
  int body = stages * BWD_STAGE + max_steps * STASH_STEP;
  if (body < 64 * BWD_RS * 4) body = 64 * BWD_RS * 4;
  return SLACK + body + 16 * stages;
}

// d (64 rows x 64 columns, fp32) += A (64 x 16, bf16, registers) .
// B (16 x 64, bf16, shared memory at `desc`, K-major)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 rows x 224 columns, fp32) += A (64 x 16, bf16, registers) .
// B (16 x 224, bf16, shared memory at `desc`, K-major)
__device__ __forceinline__ void wgmma_m64n224k16(float (&d)[112],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
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
      "%104, %105, %106, %107, %108, %109, %110, %111"
      "}, "
      "{%112, %113, %114, %115}, %116, p, 1, 1, 0;\n}\n"
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
        "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; orders shared memory
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the shared::cluster address of `local` in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local,
                                                 uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 bf2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 4 bytes from global to shared memory, asynchronously; zeros if !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The activations take one MUFU operation each (tanh.approx.f32, relative
// error below 2^-10.9; sigmoid(x) = (1 + tanh(x / 2)) / 2): the cell is
// computed by the 8 or 12 warps of a block, where exp and IEEE division
// made it the larger part of either kernel's time.
__device__ __forceinline__ float tanhf_(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return fmaf(0.5f, tanhf_(0.5f * x), 0.5f);
}

__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// the first unit of column tile x (tiles of bn staged columns, 16 units a
// 64 columns)
__device__ __forceinline__ int n0_units(int x, int bn) { return x * bn / 4; }

template <int BNW>
__device__ __forceinline__ void wgmma_fwd(float (&d)[BNW / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  if constexpr (BNW == 128)
    wgmma_m64n128k16<0>(d, a, desc);
  else
    wgmma_m64n64k16(d, a, desc);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
// Tile BM = 64 * WM rows x BN = BNW * (2 / WM) staged columns; consumer
// warpgroup w takes rows (WM == 2 ? w : 0) * 64 and columns
// (WM == 2 ? 0 : w) * BNW. Blocks: x = column tiles, y = row tiles.
template <int WM, int BNW>
__global__ void __launch_bounds__(FWD_NT, 1)
lstm_fwd_kernel(const __grid_constant__ CUtensorMap h_map,
                const __grid_constant__ CUtensorMap w_map,
                const __nv_bfloat16* __restrict__ xg,
                const __nv_bfloat16* __restrict__ bias,
                const __nv_bfloat16* __restrict__ cprev,
                __nv_bfloat16* __restrict__ h_out,
                __nv_bfloat16* __restrict__ h_rec, int ldr,
                __nv_bfloat16* __restrict__ c_out,
                __nv_bfloat16* __restrict__ z_out, int N, int H,
                int stages) {
  constexpr int BM = 64 * WM, BN = BNW * (2 / WM);
  constexpr int A_BYTES = BM * 128, STAGE = (BM + BN) * 128;
  constexpr int BU = BN / 4, PU = BU + 8;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring_u32 = smem_u32(base);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base + stages * STAGE);
  __nv_bfloat16* cs = xs + 4 * BM * PU;  // c_prev, then c
  __nv_bfloat16* hs = cs + BM * PU;
  __nv_bfloat16* bs = hs + BM * PU;
  const uint32_t full_u32 =
      smem_u32(base + stages * STAGE + fwd_epi_bytes(BM, BN));
  const uint32_t empty_u32 = full_u32 + 8 * stages;
  const uint32_t epi_u32 = empty_u32 + 8 * stages;
  const int u0 = n0_units(blockIdx.x, BN);
  const int nk16 = (H + 15) / 16;
  const int nkc = (H + KC - 1) / KC;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_u32 + 8 * s, 1);
      mbar_init(empty_u32 + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(epi_u32, 96);             // the epilogue tile's loaders
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---------------- producer ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid >= 32) {
      // warps 1-3 bring the epilogue's inputs into shared memory while
      // the products run: coalesced runs of BU units a row and gate,
      // zeros past N and H; 4-byte cp.async (many in flight): H is even,
      // so every unit pair is 4-byte aligned
      const int lt = tid - 32;
      const int H4 = 4 * H;
      constexpr int BU2 = BU / 2;
      for (int i = lt; i < 4 * BM * BU2; i += 96) {
        const int ul = 2 * (i % BU2), r = (i / BU2) % BM, q = i / (BU2 * BM);
        const int row = m0 + r, u = u0 + ul;
        const bool v = row < N && u < H;
        cp_async4(smem_u32(xs + (q * BM + r) * PU + ul),
                  v ? xg + (size_t)row * H4 + q * H + u : xg, v);
      }
      for (int i = lt; i < BM * BU2; i += 96) {
        const int ul = 2 * (i % BU2), r = i / BU2;
        const int row = m0 + r, u = u0 + ul;
        const bool v = row < N && u < H;
        cp_async4(smem_u32(cs + r * PU + ul),
                  v ? cprev + (size_t)row * H + u : cprev, v);
      }
      for (int i = lt; i < 4 * BU2; i += 96) {
        const int ul = 2 * (i % BU2), q = i / BU2;
        const bool v = u0 + ul < H;
        cp_async4(smem_u32(bs + q * BU + ul), v ? bias + q * H + u0 + ul : bias,
                  v);
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      mbar_arrive(epi_u32);
    } else if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kc = 0; kc < nkc; ++kc) {
        mbar_wait(empty_u32 + 8 * stage, phase ^ 1);
        const uint32_t a = ring_u32 + stage * STAGE;
        const uint32_t fb = full_u32 + 8 * stage;
        mbar_expect_tx(fb, STAGE);
        tma_load_2d(a, &h_map, fb, kc * KC, m0);
        tma_load_2d(a + A_BYTES, &w_map, fb, kc * KC, n0);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int ct = tid - 128;
  const int wgi = ct >> 7;
  const int wm = WM == 2 ? wgi : 0, wn = WM == 2 ? 0 : wgi;
  const int cw = (ct >> 5) & 3;
  const int lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lj = lane >> 3, l8 = lane & 7;
  float acc[BNW / 2];
#pragma unroll
  for (int i = 0; i < BNW / 2; ++i) acc[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int kc = 0; kc < nkc; ++kc) {
    mbar_wait(full_u32 + 8 * stage, phase);
    const uint32_t a_u32 = ring_u32 + stage * STAGE;
    const uint32_t b_u32 = a_u32 + A_BYTES + wn * BNW * 128;
    const int nks = min(4, nk16 - 4 * kc);
    uint32_t afr[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks < nks) {
        // rows of this warp, 16-byte chunk 2ks + (lj >> 1) of each
        // 128-byte row, swizzled by the row's index mod 8 (= l8)
        const int row = wm * 64 + cw * 16 + (lj & 1) * 8 + l8;
        ldsm_x4(a_u32 + row * 128 + (((2 * ks + (lj >> 1)) ^ l8) << 4),
                afr[ks]);
#pragma unroll
        for (int i = 0; i < 4; ++i) reg_fence(afr[ks][i]);
        wgmma_fence();
        wgmma_fwd<BNW>(acc, afr[ks], sw128_desc(b_u32 + ks * 32, 16, 1024));
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BNW / 2; ++i) reg_fence(acc[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_u32 + 8 * stage);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // ---------------- epilogue: the cell ----------------
  // n8 block j = 8 * p + 2 * q + hb of the warpgroup's columns holds gate
  // q of the tile's units ul = 16 * (wn * BNW / 64 + p) + 8 * hb + 2t, +1;
  // d[4j + 2 * rh + e] is row g + 8 * rh, unit ul + e. Each (row, unit)
  // is read and written by one thread, so z and c overwrite xg and c_prev
  // in place; past N and H the tile holds zeros and the results are not
  // stored.
  mbar_wait(epi_u32, 0);
#pragma unroll
  for (int p = 0; p < BNW / 64; ++p)
#pragma unroll
    for (int hb = 0; hb < 2; ++hb)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int r = wm * 64 + cw * 16 + g + 8 * rh;
        const int ul = 16 * (wn * BNW / 64 + p) + 8 * hb + 2 * t;
        float zq[4][2];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + (q * BM + r) * PU + ul));
          const float2 bv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(bs + q * BU + ul));
          const float* a = acc + 4 * (8 * p + 2 * q + hb) + 2 * rh;
          zq[q][0] = (xv.x + a[0]) + bv.x;
          zq[q][1] = (xv.y + a[1]) + bv.y;
          *reinterpret_cast<__nv_bfloat162*>(xs + (q * BM + r) * PU + ul) =
              __floats2bfloat162_rn(zq[q][0], zq[q][1]);
        }
        const float2 cv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(cs + r * PU + ul));
        float c2[2], h2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float i_ = sigmoidf_(zq[0][e]), f_ = sigmoidf_(zq[1][e]);
          const float g_ = tanhf_(zq[2][e]), o_ = sigmoidf_(zq[3][e]);
          c2[e] = f_ * (e ? cv.y : cv.x) + i_ * g_;
          h2[e] = o_ * tanhf_(c2[e]);
        }
        *reinterpret_cast<__nv_bfloat162*>(cs + r * PU + ul) =
            __floats2bfloat162_rn(c2[0], c2[1]);
        *reinterpret_cast<__nv_bfloat162*>(hs + r * PU + ul) =
            __floats2bfloat162_rn(h2[0], h2[1]);
      }
  consumers_sync();
  // coalesced stores: runs of BU units a row (and gate), a unit pair a
  // thread (H is even: every pair is 4-byte aligned), 4 pairs in flight
  constexpr int BU2 = BU / 2;
  const int H4 = 4 * H;
#pragma unroll 4
  for (int i = ct; i < BM * BU2; i += 256) {
    const int ul = 2 * (i % BU2), r = i / BU2;
    const int row = m0 + r, u = u0 + ul;
    if (row < N && u < H) {
      const size_t cell = (size_t)row * H + u;
      const __nv_bfloat162 hv =
          *reinterpret_cast<const __nv_bfloat162*>(hs + r * PU + ul);
      *reinterpret_cast<__nv_bfloat162*>(h_out + cell) = hv;
      *reinterpret_cast<__nv_bfloat162*>(c_out + cell) =
          *reinterpret_cast<const __nv_bfloat162*>(cs + r * PU + ul);
      if (h_rec)
        *reinterpret_cast<__nv_bfloat162*>(h_rec + (size_t)row * ldr + u) =
            hv;
    }
  }
  if (z_out) {
#pragma unroll 4
    for (int i = ct; i < 4 * BM * BU2; i += 256) {
      const int ul = 2 * (i % BU2), r = (i / BU2) % BM, q = i / (BU2 * BM);
      const int row = m0 + r, u = u0 + ul;
      if (row < N && u < H)
        *reinterpret_cast<__nv_bfloat162*>(z_out + (size_t)row * H4 +
                                           q * H + u) =
            *reinterpret_cast<const __nv_bfloat162*>(xs + (q * BM + r) * PU +
                                                     ul);
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
// chunk c of a slice starting at k16 step st0 into ring stage s: k columns
// 16 * (st0 + 4c) .. + 63 of every output column, one box a warpgroup
__device__ __forceinline__ void bwd_issue(const CUtensorMap* map,
                                          uint32_t ring, uint32_t full,
                                          int st0, int c, int s) {
  const uint32_t fb = full + 8 * s;
  mbar_expect_tx(fb, BWD_STAGE);
#pragma unroll
  for (int w = 0; w < 3; ++w)
    tma_load_2d(ring + s * BWD_STAGE + w * BWD_NW * 128, map, fb,
                16 * (st0 + 4 * c), w * BWD_NW);
}

// Grid (S, row tiles), clusters of S along x: rank r takes the groups of
// four k16 steps [r * G / S, (r + 1) * G / S) of the staged copy's
// G = Hp / 16.
template <int S>
__global__ void __launch_bounds__(BWD_NT, 1)
lstm_bwd_kernel(const __grid_constant__ CUtensorMap w_map,
                const __nv_bfloat16* __restrict__ dy,
                const float* __restrict__ dh_rec,
                const float* __restrict__ dc,
                const __nv_bfloat16* __restrict__ z,
                const __nv_bfloat16* __restrict__ cprev,
                __nv_bfloat16* __restrict__ dz, float* __restrict__ dc_prev,
                float* __restrict__ dh_prev, int N, int H, int T16,
                int stages) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring_u32 = smem_u32(base);
  const int rank = (int)cluster_rank();
  const int G = T16 / 4;
  const int gr0 = rank * G / S, ngr = (rank + 1) * G / S - gr0;
  const int st0 = 4 * gr0, nst = 4 * ngr;
  const int max_steps = 4 * ((G + S - 1) / S);
  uint4* stash = reinterpret_cast<uint4*>(base + stages * BWD_STAGE);
  int body = stages * BWD_STAGE + max_steps * STASH_STEP;
  if (body < 64 * BWD_RS * 4) body = 64 * BWD_RS * 4;
  const uint32_t full_u32 = smem_u32(base + body);
  const uint32_t empty_u32 = full_u32 + 8 * stages;
  const int nkc = (nst + 3) / 4;
  const int m0 = blockIdx.y * 64;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_u32 + 8 * s, 1);
      mbar_init(empty_u32 + 8 * s, 12);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < min(stages, nkc); ++c)
      bwd_issue(&w_map, ring_u32, full_u32, st0, c, c);
  __syncwarp();

  const int wgi = tid >> 7;
  const int lt = tid & 127;
  const int cw = lt >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int H4 = 4 * H;

  // ---------------- prologue: dz, the A operand ----------------
  // The block's cells (64 rows x the slice's U units) are walked as unit
  // pairs along rows, so a warp's loads and stores are runs of 64 units
  // a row and gate; PB pairs a thread have every load in flight before
  // the arithmetic. Each cell's dz, rounded to bf16, goes to device
  // memory and into the stash at its place in the A fragments: k16 step
  // 4p + k of unit 16p + 4t' + k, lane 4 (row % 8) + t', register rh
  // (i, f) or 2 + rh (g, o) of warp row / 16. Cells past N or H are zero
  // in the stash, so no padded column of the staged weight meets garbage.
  constexpr int PB = 4;
  const int U = 16 * ngr, U2 = U / 2, us0 = 16 * gr0;
  uint32_t* stash32 = reinterpret_cast<uint32_t*>(stash);
  for (int base = tid; base < 64 * U2; base += PB * BWD_NT) {
    float zv[PB][4][2], cpv[PB][2], dhv[PB][2], dcv[PB][2];
    bool ok[PB];
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int i = base + k * BWD_NT;
      const int rl = i / max(U2, 1), ul = 2 * (i - rl * U2);
      const int row = m0 + rl, u = us0 + ul;
      ok[k] = i < 64 * U2 && row < N && u < H;
      if (ok[k]) {
        const size_t cell = (size_t)row * H + u;
        const __nv_bfloat16* zr = z + (size_t)row * H4 + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = bf2(zr + q * H);
          zv[k][q][0] = v.x;
          zv[k][q][1] = v.y;
        }
        const float2 c2 = bf2(cprev + cell), y2 = bf2(dy + cell);
        const float2 r2 = *reinterpret_cast<const float2*>(dh_rec + cell);
        const float2 d2 = *reinterpret_cast<const float2*>(dc + cell);
        cpv[k][0] = c2.x;
        cpv[k][1] = c2.y;
        dhv[k][0] = y2.x + r2.x;
        dhv[k][1] = y2.y + r2.y;
        dcv[k][0] = d2.x;
        dcv[k][1] = d2.y;
      }
    }
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int i = base + k * BWD_NT;
      if (i >= 64 * U2) break;
      const int rl = i / U2, ul = 2 * (i - rl * U2);
      float d[4][2], e[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        d[0][j] = d[1][j] = d[2][j] = d[3][j] = e[j] = 0.0f;
        if (ok[k]) {
          const float i_ = sigmoidf_(zv[k][0][j]);
          const float f_ = sigmoidf_(zv[k][1][j]);
          const float g_ = tanhf_(zv[k][2][j]);
          const float o_ = sigmoidf_(zv[k][3][j]);
          const float cp = cpv[k][j], dh = dhv[k][j];
          const float tc = tanhf_(f_ * cp + i_ * g_);
          const float dct = dcv[k][j] + dh * o_ * (1.0f - tc * tc);
          d[0][j] = dct * g_ * i_ * (1.0f - i_);
          d[1][j] = dct * cp * f_ * (1.0f - f_);
          d[2][j] = dct * i_ * (1.0f - g_ * g_);
          d[3][j] = dh * tc * o_ * (1.0f - o_);
          e[j] = dct * f_;
        }
        const int uj = ul + j;
        const int entry = (4 * (uj >> 4) + (uj & 3)) * 128 + (rl >> 4) * 32 +
                          (rl & 7) * 4 + ((uj & 15) >> 2);
        const int rh = (rl >> 3) & 1;
        stash32[4 * entry + rh] = pack_bf16(d[0][j], d[1][j]);
        stash32[4 * entry + 2 + rh] = pack_bf16(d[2][j], d[3][j]);
      }
      if (ok[k]) {
        const int row = m0 + rl, u = us0 + ul;
        __nv_bfloat16* dr = dz + (size_t)row * H4 + u;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<__nv_bfloat162*>(dr + q * H) =
              __floats2bfloat162_rn(d[q][0], d[q][1]);
        *reinterpret_cast<float2*>(dc_prev + (size_t)row * H + u) =
            make_float2(e[0], e[1]);
      }
    }
  }
  __syncthreads();

  // ---------------- the product over the slice ----------------
  float acc[BWD_NW / 2];
#pragma unroll
  for (int i = 0; i < BWD_NW / 2; ++i) acc[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int c = 0; c < nkc; ++c) {
    mbar_wait(full_u32 + 8 * stage, phase);
    const uint32_t b_u32 = ring_u32 + stage * BWD_STAGE + wgi * BWD_NW * 128;
    const int nks = min(4, nst - 4 * c);
    uint32_t afr[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks < nks) {
        const uint4 a = stash[(4 * c + ks) * 128 + lt];
        afr[ks][0] = a.x;
        afr[ks][1] = a.y;
        afr[ks][2] = a.z;
        afr[ks][3] = a.w;
#pragma unroll
        for (int i = 0; i < 4; ++i) reg_fence(afr[ks][i]);
        wgmma_fence();
        wgmma_m64n224k16(acc, afr[ks], sw128_desc(b_u32 + ks * 32, 16, 1024));
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BWD_NW / 2; ++i) reg_fence(acc[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_u32 + 8 * stage);
    if (tid == 0 && c + stages < nkc) {
      mbar_wait(empty_u32 + 8 * stage, phase);  // every warp is done
      bwd_issue(&w_map, ring_u32, full_u32, st0, c + stages, stage);
    }
    __syncwarp();
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // ---------------- the cluster's sum ----------------
  // each block's partial into its own shared memory (the ring and the
  // stash are free); then rank r sums rows [r * ROWS, (r + 1) * ROWS) of
  // every block's partial, rank by rank in a fixed order, the S remote
  // loads of an element issued together
  __syncthreads();
  float* red = reinterpret_cast<float*>(base);   // [64][BWD_RS]
#pragma unroll
  for (int j = 0; j < BWD_NW / 8; ++j)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
      *reinterpret_cast<float2*>(
          red + (cw * 16 + g + 8 * rh) * BWD_RS + wgi * BWD_NW + 8 * j +
          2 * t) = make_float2(acc[4 * j + 2 * rh], acc[4 * j + 2 * rh + 1]);
  cluster_sync();
  constexpr int ROWS = 64 / S;
  constexpr int PER = S >= 16 ? 2 : 32 / S;   // elements a thread, in flight
  const int q4 = (H + 3) / 4;
  for (int base = tid; base < ROWS * q4; base += PER * BWD_NT) {
    float4 v[PER][S];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = base + k * BWD_NT;
      if (idx < ROWS * q4) {
        const int r = rank * ROWS + idx / q4, c4 = 4 * (idx % q4);
        const uint32_t off = smem_u32(red + r * BWD_RS + c4);
#pragma unroll
        for (int q = 0; q < S; ++q)
          v[k][q] = ld_cluster_f4(cluster_addr(off, q));
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = base + k * BWD_NT;
      if (idx >= ROWS * q4) break;
      const int r = rank * ROWS + idx / q4, c4 = 4 * (idx % q4);
      float4 sum = v[k][0];
#pragma unroll
      for (int q = 1; q < S; ++q) {
        sum.x += v[k][q].x;
        sum.y += v[k][q].y;
        sum.z += v[k][q].z;
        sum.w += v[k][q].w;
      }
      const int row = m0 + r;
      if (row < N) {
        float* o = dh_prev + (size_t)row * H + c4;
        if (c4 + 4 <= H) {
          *reinterpret_cast<float2*>(o) = make_float2(sum.x, sum.y);
          *reinterpret_cast<float2*>(o + 2) = make_float2(sum.z, sum.w);
        } else {
          const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c4 + e < H) o[e] = sv[e];
        }
      }
    }
  }
  cluster_sync();  // peers may still read this block's partial
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <int WM, int BNW>
int fwd_launch(const void* xg, const void* h_prev, int ldh, const void* wf,
               const void* b, const void* cp, void* h, void* h_rec, int ldr,
               void* c, void* z, int N, int H, int hp, int stages, int smem,
               cudaStream_t st) {
  constexpr int BM = 64 * WM, BN = BNW * (2 / WM);
  CUtensorMap hm, wm;
  memset(&hm, 0, sizeof(hm));
  memset(&wm, 0, sizeof(wm));
  const cuuint64_t hd[2] = {(cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t hs[1] = {(cuuint64_t)ldh * 2};
  const cuuint32_t hb[2] = {KC, BM};
  const cuuint64_t wd[2] = {(cuuint64_t)H, (cuuint64_t)4 * hp};
  const cuuint64_t ws[1] = {(cuuint64_t)hp * 2};
  const cuuint32_t wb[2] = {KC, BN};
  int rc = make_map(&hm, h_prev, 2, hd, hs, hb);
  if (!rc) rc = make_map(&wm, wf, 2, wd, ws, wb);
  if (rc) return rc;
  const dim3 grid((4 * hp + BN - 1) / BN, (N + BM - 1) / BM);
  lstm_fwd_kernel<WM, BNW><<<grid, FWD_NT, smem, st>>>(
      hm, wm, (const __nv_bfloat16*)xg, (const __nv_bfloat16*)b,
      (const __nv_bfloat16*)cp, (__nv_bfloat16*)h, (__nv_bfloat16*)h_rec,
      ldr, (__nv_bfloat16*)c, (__nv_bfloat16*)z, N, H, stages);
  return (int)cudaGetLastError();
}

template <int S>
int bwd_launch(const void* dy, const void* dh_rec, const void* dc,
               const void* z, const void* cp, const void* wb, void* dz,
               void* dc_prev, void* dh_prev, int N, int H, int hp,
               int stages, int smem, cudaStream_t st) {
  CUtensorMap wm;
  memset(&wm, 0, sizeof(wm));
  const cuuint64_t wd[2] = {(cuuint64_t)4 * hp, (cuuint64_t)BWD_COLS};
  const cuuint64_t ws[1] = {(cuuint64_t)4 * hp * 2};
  const cuuint32_t box[2] = {KC, BWD_NW};
  const int rc = make_map(&wm, wb, 2, wd, ws, box);
  if (rc) return rc;
  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDim = dim3(S, (N + 63) / 64);
  cfg.blockDim = dim3(BWD_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, lstm_bwd_kernel<S>, wm, (const __nv_bfloat16*)dy,
      (const float*)dh_rec, (const float*)dc, (const __nv_bfloat16*)z,
      (const __nv_bfloat16*)cp, (__nv_bfloat16*)dz, (float*)dc_prev,
      (float*)dh_prev, N, H, hp / 4, stages);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace ls

extern "C" {

// Sets every instantiation's dynamic shared memory limit (and lets the
// 16-block cluster run): once, when the library loads, outside any
// capture. 0 = done.
int mxtt_lstm_step_init() {
  const void* fns[] = {
      (const void*)ls::lstm_fwd_kernel<2, 64>,
      (const void*)ls::lstm_fwd_kernel<2, 128>,
      (const void*)ls::lstm_fwd_kernel<1, 64>,
      (const void*)ls::lstm_fwd_kernel<1, 128>,
      (const void*)ls::lstm_bwd_kernel<4>,
      (const void*)ls::lstm_bwd_kernel<8>,
      (const void*)ls::lstm_bwd_kernel<16>};
  for (const void* f : fns) {
    const cudaError_t e = cudaFuncSetAttribute(
        f, cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaFuncSetAttribute(
      (const void*)ls::lstm_bwd_kernel<16>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// One forward step (see the top of this file). h_prev (N, H) with row
// stride ldh (a multiple of 8), 16-byte aligned; wf the staged copy
// (4 hp, hp); xg (N, 4H), b (4H,), cp / h / c (N, H) contiguous; h_rec
// (row stride ldr) and z (N, 4H) may be null. (bm, bn): 128 x 64,
// 128 x 128, 64 x 128 or 64 x 256. 0 = launched.
int mxtt_lstm_step_fwd(const void* xg, const void* h_prev, int ldh,
                       const void* wf, const void* b, const void* cp,
                       void* h, void* h_rec, int ldr, void* c, void* z,
                       int N, int H, int hp, int bm, int bn, int stages,
                       int plan_smem, cudaStream_t st) {
  if (N < 1 || H < 2 || H % 2 || hp != 16 * ((H + 15) / 16) || ldh < H ||
      ldh % 8 ||
      (h_rec && ldr < H) || stages < 2 || stages > wg::MAX_STAGES ||
      !wg::aligned16(h_prev) || !wg::aligned16(wf))
    return (int)cudaErrorInvalidValue;
  const int smem = ls::fwd_smem(bm, bn, stages);
  if (smem != plan_smem || smem > wg::SMEM_MAX)
    return (int)cudaErrorInvalidValue;
#define LS_FWD(WM, BNW)                                                     \
  ls::fwd_launch<WM, BNW>(xg, h_prev, ldh, wf, b, cp, h, h_rec, ldr, c, z, \
                          N, H, hp, stages, smem, st)
  if (bm == 128 && bn == 64) return LS_FWD(2, 64);
  if (bm == 128 && bn == 128) return LS_FWD(2, 128);
  if (bm == 64 && bn == 128) return LS_FWD(1, 64);
  if (bm == 64 && bn == 256) return LS_FWD(1, 128);
#undef LS_FWD
  return (int)cudaErrorInvalidValue;
}

// One backward step. dy (N, H) bf16, dh_rec / dc (N, H) fp32, z (N, 4H)
// and cp (N, H) bf16, wb the staged copy (672, 4 hp), all contiguous;
// writes dz (N, 4H) bf16, dc_prev and dh_prev (N, H) fp32. slices: 4, 8
// or 16 (the cluster). 0 = launched.
int mxtt_lstm_step_bwd(const void* dy, const void* dh_rec, const void* dc,
                       const void* z, const void* cp, const void* wb,
                       void* dz, void* dc_prev, void* dh_prev, int N, int H,
                       int hp, int slices, int stages, int plan_smem,
                       cudaStream_t st) {
  if (N < 1 || H < 2 || H % 2 || H > ls::BWD_COLS ||
      hp != 16 * ((H + 15) / 16) ||
      stages < 1 || stages > 2 || !wg::aligned16(wb))
    return (int)cudaErrorInvalidValue;
  if (slices != 4 && slices != 8 && slices != 16)
    return (int)cudaErrorInvalidValue;
  const int groups = hp / 16;
  const int smem =
      ls::bwd_smem(4 * ((groups + slices - 1) / slices), stages);
  if (smem != plan_smem || smem > wg::SMEM_MAX)
    return (int)cudaErrorInvalidValue;
#define LS_BWD(S)                                                          \
  ls::bwd_launch<S>(dy, dh_rec, dc, z, cp, wb, dz, dc_prev, dh_prev, N, H, \
                    hp, stages, smem, st)
  if (slices == 4) return LS_BWD(4);
  if (slices == 8) return LS_BWD(8);
  return LS_BWD(16);
#undef LS_BWD
}

// How many clusters of `slices` blocks with `smem` bytes each the card
// can hold at once (cudaOccupancyMaxActiveClusters); < 0: a CUDA error.
int mxtt_lstm_bwd_max_clusters(int slices, int smem) {
  cudaLaunchConfig_t cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDim = dim3(slices, 8);
  cfg.blockDim = dim3(ls::BWD_NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const void* f = slices == 4    ? (const void*)ls::lstm_bwd_kernel<4>
                  : slices == 8  ? (const void*)ls::lstm_bwd_kernel<8>
                                 : (const void*)ls::lstm_bwd_kernel<16>;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, f, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

}  // extern "C"
