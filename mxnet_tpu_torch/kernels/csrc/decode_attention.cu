// D1: masked decode / verify attention over the KV-cache, f32 or int8 with
// per-row f32 scales, for Hopper (sm_90a).
//
// Replaces the jnp attention of mxnet_tpu/serving/decode/model.py
// (decode_step :375-381, verify_step :448-455), which XLA fuses with the
// int8 cache's convert-and-scale into one read of the cache. For lane n,
// head h and fed token j < W (W = 1 for decode, k + 1 for verify):
//
//   o[n,j,h,:] = sum_m softmax_m(mask(q[n,j,h,:] . K[n,m,h,:] * scale))
//                * V[n,m,h,:],
//
// row m visible when m <= positions[n] + j; the others take the
// reference's -1e30 (not -inf), whose weight underflows to an exact 0.0.
//
// What bounds it on an H100: bytes. At W <= 16 each cache byte feeds at
// most W multiply-adds, far below the ~20 flops a byte where the CUDA
// cores' f32 rate would take over, so the kernel computes in f32 on the
// CUDA cores (the reference is f32; no tensor core) and its only aim is
// to read each needed cache row once with the whole card. A form with one
// program per (lane, head) walks a long lane's rows through one SM, at
// 1/132 of the card's bandwidth, and that lane sets the launch's time.
//
// The design (flash-decoding): each lane's rows are split into fixed
// chunks of R rows, [c*R, (c+1)*R), R a template (32, 64 or 128; 64 from a
// sweep on the card). The grid is (ceil(M/R), H, N), fixed by the cache's
// shape, so one CUDA graph captures it once; a block whose chunk starts at
// or past hi = min(positions[n] + W, M) exits at once.
// - One thread puts the chunk's K and V rows in flight together: 3-D TMA
//   boxes (head_dim columns x 16 rows of one lane) over the cache viewed
//   as (N, M, H*D), K's on one mbarrier and V's on another, so the scores
//   start while V arrives; the rows past M are zero-filled by the copy and
//   never used. The W tokens' q rows and the int8 scales (4-byte rows, not
//   a TMA box) come by plain loads under the copies.
// - 128 threads; a row's D values are spread over TPR = min(D/4, 16)
//   neighbouring threads, four at a time, so a score is a 4-wide dot per
//   thread and a butterfly of shuffles; a thread's R / G rows (G = 128 /
//   TPR groups) are independent, so their loads and shuffles overlap.
//   Scores go to shared memory; a warp takes a token's max m, weights
//   p = exp(s - m) and sum l over the chunk by fixed butterflies and keeps
//   p in its own buffer. int8 rows are dequantized on load, q * scale in
//   f32, as kv_dequant does.
// - Decode (W = 1): every warp takes the same softmax (the same bits);
//   each row group accumulates p * V over its rows in row order and the
//   groups are summed in group order. Verify (W > 1): the block takes all
//   W tokens' scores, then warp w takes tokens w, w + 4, ...: its softmax
//   and p * V over the chunk's rows in row order, one column a lane (and
//   every 32nd after it), with no block barrier between tokens.
// - A lane with one chunk writes its output directly (the combine of one
//   chunk gives the same bits). Otherwise each block writes its partial
//   (acc[D], m, l) per token to a workspace (N, H, W, ceil(M/R), D + 4)
//   f32 and takes a ticket on a per-(lane, head) counter (zeroed by a
//   memset node before the launch). The last block to finish loads every
//   chunk's partial at once into shared memory and combines chunks 0..C-1
//   in index order: o = sum_c exp(m_c - M) acc_c / sum_c exp(m_c - M) l_c,
//   the denominator by a fixed butterfly. A chunk that no row of token j
//   sees (W > 1) has m_c = -1e30 and weight exp(-1e30 - M) = 0.0 exactly.
// Every reduction has a fixed order and the chunk boundaries depend only
// on the row index, so a lane's output does not depend on the other lanes
// (batched == solo) and is the same from run to run, whichever block
// comes last.
//
// The plan (R, grid, workspace, shared memory) is the host's
// (ops/decode_attention.py: _d1_plan); the entry checks it against this
// file and refuses a mismatch before any launch.

#include "bn_gemm_wgmma.cuh"

namespace d1 {

constexpr int NT = 128;                  // threads a block
constexpr float NEG = -1e30f;            // the reference's mask value
constexpr int SUB = 16;                  // rows a TMA box
constexpr int SMEM_MAX = 231424;         // an H100 block's 227 KB less 1 KB
constexpr int SLACK = 128;               // to align the tiles to 128 B

__host__ __device__ constexpr int tpr(int D) { return D / 4 < 16 ? D / 4 : 16; }
__host__ __device__ constexpr int groups(int D) { return NT / tpr(D); }
__host__ __device__ inline int up(int x, int a) { return (x + a - 1) / a * a; }

// Shared-memory layout, after SLACK: [chunk m, l: 2 W C][denominators W]
// [the combine's running sums W x D][two mbarriers], then from a 128-byte
// boundary the compute region [K tile][V tile][scores W x R][each warp's
// weights 4 x R][k, v scales 2R (int8)][group partials G x D][q rows
// W x D]. The combining block loads the chunks' partials over the compute
// region, which is made large enough for all of them up to SLAB_MAX bytes
// (in rounds beyond). The host plan computes the same total.
constexpr int SLAB_MAX = 49152;

struct Layout {
  int off_dn, off_sums, off_bar, base, tile, off_v, off_s, off_p, off_sc,
      off_red, off_q, region, total;
};

__host__ __device__ inline Layout layout(int D, int int8, int rows, int W,
                                         int chunks) {
  Layout L;
  L.off_dn = up(2 * W * chunks * 4, 16);
  L.off_sums = L.off_dn + up(W * 4, 16);
  L.off_bar = L.off_sums + W * D * 4;
  L.base = up(L.off_bar + 16, 128);
  L.tile = up(rows * D * (int8 ? 1 : 4), 128);
  L.off_v = L.base + L.tile;
  L.off_s = L.base + 2 * L.tile;
  L.off_p = L.off_s + up(W * rows * 4, 16);
  L.off_sc = L.off_p + (NT / 32) * rows * 4;
  L.off_red = L.off_sc + (int8 ? up(2 * rows * 4, 16) : 0);
  L.off_q = L.off_red + groups(D) * D * 4;
  const int compute = L.off_q + W * D * 4 - L.base;
  const int slab = W * chunks * (D + 4) * 4;
  L.region = max(compute, min(slab, SLAB_MAX));
  L.total = SLACK + L.base + L.region;
  return L;
}

#ifdef D1_TRACE
// Per-block clocks (%globaltimer, ns) for profile_decode_attention.py,
// in a build of its own: 0 start, 1 K arrived, 2 V arrived, 3 the block's
// tokens done, 4 its ticket taken, 5 the combine done.
constexpr unsigned TRACE_BLOCKS = 1u << 14;
__device__ unsigned long long trace_clock[TRACE_BLOCKS * 8];

__device__ __forceinline__ void mark(int k) {
  const unsigned b =
      (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0 && b < TRACE_BLOCKS) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    trace_clock[b * 8 + k] = t;
  }
}
#else
__device__ __forceinline__ void mark(int) {}
#endif

// four values of row r of a tile from column col, dequantized in f32
template <int D, bool INT8>
__device__ __forceinline__ float4 row4(const unsigned char* tile, int r,
                                       int col, float scale) {
  if (INT8) {
    const char4 c = *reinterpret_cast<const char4*>(tile + r * D + col);
    return make_float4((float)c.x * scale, (float)c.y * scale,
                       (float)c.z * scale, (float)c.w * scale);
  }
  return *reinterpret_cast<const float4*>(tile + (r * D + col) * 4);
}

// a 16-byte copy from device (through L2) to shared memory that holds no
// register while in flight
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   wg::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ float4 fma4(float p, float4 v, float4 a) {
  return make_float4(fmaf(p, v.x, a.x), fmaf(p, v.y, a.y),
                     fmaf(p, v.z, a.z), fmaf(p, v.w, a.w));
}

template <int D, int R, bool INT8>
__global__ void __launch_bounds__(NT)
decode_attention(const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const float* __restrict__ q, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ pos,
                 float* __restrict__ out, float* __restrict__ ws,
                 int* __restrict__ cnt, int W, int M, int H, float scale) {
  constexpr int TPR = tpr(D), G = groups(D), NV = D / (4 * TPR);
  constexpr int RPG = R / G;             // rows a group
  constexpr int SPL = (R + 31) / 32;     // scores a lane in the softmax
  constexpr int DP = D + 4;              // workspace row: acc[D], m, l, pad
  static_assert(R % G == 0, "a chunk's rows split evenly over the groups");
  const int c = blockIdx.x, h = blockIdx.y, n = blockIdx.z;
  const int C = gridDim.x;
  const int tid = threadIdx.x;
  mark(0);
  const int p0 = pos[n];
  const int hi = (int)min((long long)p0 + W, (long long)M);
  const int r0 = c * R;
  if (hi <= 0 && c == 0) {               // a negative position sees no row
    for (int i = tid; i < W * D; i += NT)
      out[((size_t)(n * W + i / D) * H + h) * D + i % D] =
          __int_as_float(0x7fc00000);
    return;
  }
  if (r0 >= hi) return;
  const int nrows = min(R, hi - r0);
  const int nchunks = (hi + R - 1) / R;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SLACK - 1) &
      ~(uintptr_t)(SLACK - 1));
  const Layout L = layout(D, INT8, R, W, C);
  float* ml = reinterpret_cast<float*>(sm);
  float* dn = reinterpret_cast<float*>(sm + L.off_dn);
  const uint32_t kbar = wg::smem_u32(sm + L.off_bar), vbar = kbar + 8;
  const unsigned char* kt = sm + L.base;
  const unsigned char* vt = sm + L.off_v;
  float* s_sm = reinterpret_cast<float*>(sm + L.off_s);
  float* p_sm = reinterpret_cast<float*>(sm + L.off_p) + tid / 32 * R;
  float* ks_sm = reinterpret_cast<float*>(sm + L.off_sc);
  float* vs_sm = ks_sm + R;
  float* red = reinterpret_cast<float*>(sm + L.off_red);
  float* q_sm = reinterpret_cast<float*>(sm + L.off_q);
  __shared__ int last;

  // K's boxes, then V's, each set completing on its own mbarrier, so the
  // scores start while V is still in flight
  const int sub = R < SUB ? R : SUB;
  const int nsub = (nrows + sub - 1) / sub;
  if (tid == 0) {
    wg::mbar_init(kbar, 1);
    wg::mbar_init(vbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint32_t box = sub * D * (INT8 ? 1 : 4);
    wg::mbar_expect_tx(kbar, nsub * box);
    for (int i = 0; i < nsub; ++i)
      wg::tma_load_3d(wg::smem_u32(kt) + i * box, &k_map, kbar, h * D,
                      r0 + i * sub, n);
    wg::mbar_expect_tx(vbar, nsub * box);
    for (int i = 0; i < nsub; ++i)
      wg::tma_load_3d(wg::smem_u32(vt) + i * box, &v_map, vbar, h * D,
                      r0 + i * sub, n);
  }
  // under the copies: the q rows of the W tokens and the int8 scales
  for (int i = tid; i < W * D / 4; i += NT)
    reinterpret_cast<float4*>(q_sm)[i] = reinterpret_cast<const float4*>(
        q + ((size_t)(n * W + i / (D / 4)) * H + h) * D)[i % (D / 4)];
  if (INT8) {
    for (int r = tid; r < nrows; r += NT) {
      const size_t o = ((size_t)n * M + r0 + r) * H + h;
      ks_sm[r] = ks[o];
      vs_sm[r] = vs[o];
    }
  }
  __syncthreads();                       // the barriers' init, q, scales
  wg::mbar_wait(kbar, 0);
  mark(1);

  // row group g takes rows g, g + G, ...; its TPR threads hold four
  // columns each per 4-vector, neighbours on neighbouring columns
  const int g = tid / TPR, lr = tid % TPR, lane = tid % 32, warp = tid / 32;
  float* ws_lane = ws + (size_t)(n * H + h) * W * C * DP;
  // scores of token j: RPG independent dot products a thread, then
  // butterflies over the row's TPR threads
  auto scores = [&](int j) {
    float4 qv[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k)
      qv[k] = reinterpret_cast<const float4*>(q_sm + j * D)[lr + k * TPR];
    float dot[RPG];
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const int r = g + i * G;
      dot[i] = 0.f;
      if (r < nrows) {
        const float sc = INT8 ? ks_sm[r] : 1.f;
#pragma unroll
        for (int k = 0; k < NV; ++k) {
          const float4 kv = row4<D, INT8>(kt, r, 4 * (lr + k * TPR), sc);
          dot[i] = fmaf(qv[k].x, kv.x, dot[i]);
          dot[i] = fmaf(qv[k].y, kv.y, dot[i]);
          dot[i] = fmaf(qv[k].z, kv.z, dot[i]);
          dot[i] = fmaf(qv[k].w, kv.w, dot[i]);
        }
      }
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < RPG; ++i)
        dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], o);
    if (lr == 0) {
#pragma unroll
      for (int i = 0; i < RPG; ++i) {
        const int r = g + i * G;         // token j sees rows <= p0 + j
        if (r < nrows)
          s_sm[j * R + r] = r0 + r <= p0 + j ? dot[i] * scale : NEG;
      }
    }
  };
  // token j's max m, weights p = exp(s - m) into this warp's buffer and
  // sum l over the chunk, by fixed butterflies: every warp that takes a
  // token gets the same bits
  auto softmax = [&](int j, float& mx, float& l) {
    mx = NEG;
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int r = lane + 32 * k;
      if (r < nrows) mx = fmaxf(mx, s_sm[j * R + r]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    l = 0.f;
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const int r = lane + 32 * k;
      if (r < nrows) {
        const float p = expf(s_sm[j * R + r] - mx);
        p_sm[r] = p;
        l += p;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, o);
    __syncwarp();
  };
  if (W == 1) {
    // decode: the whole block on the one token
    scores(0);
    __syncthreads();
    float mx, l;
    softmax(0, mx, l);
    wg::mbar_wait(vbar, 0);
    mark(2);
    // p . V: each group over its rows in row order, then the groups in
    // group order
    float4 a[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < RPG; ++i) {
      const int r = g + i * G;
      if (r < nrows) {
        const float p = p_sm[r];
        const float sc = INT8 ? vs_sm[r] : 1.f;
#pragma unroll
        for (int k = 0; k < NV; ++k)
          a[k] = fma4(p, row4<D, INT8>(vt, r, 4 * (lr + k * TPR), sc), a[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < NV; ++k)
      *reinterpret_cast<float4*>(red + g * D + 4 * (lr + k * TPR)) = a[k];
    __syncthreads();
    // a lane with one chunk writes its output here: the combine of one
    // chunk (weight exp(0) = 1) gives the same bits
    for (int d = tid; d < D; d += NT) {
      float sum = red[d];
#pragma unroll
      for (int k = 1; k < G; ++k) sum += red[k * D + d];
      if (nchunks == 1)
        out[((size_t)n * H + h) * D + d] = sum / l;
      else
        ws_lane[(size_t)c * DP + d] = sum;
    }
    if (tid == 0 && nchunks > 1) {
      ws_lane[(size_t)c * DP + D] = mx;
      ws_lane[(size_t)c * DP + D + 1] = l;
    }
  } else {
    // verify: every token's scores by the whole block, then a warp a
    // token: its softmax and its p . V over the chunk's rows in row order,
    // lane i on columns i, i + 32, ...
    for (int j = 0; j < W; ++j) scores(j);
    __syncthreads();
    wg::mbar_wait(vbar, 0);
    mark(2);
    constexpr int CPL = D < 32 ? 1 : D / 32;   // columns a lane
    for (int j = warp; j < W; j += NT / 32) {
      float mx, l;
      softmax(j, mx, l);
      float a[CPL];
#pragma unroll
      for (int e = 0; e < CPL; ++e) a[e] = 0.f;
      if (lane < D) {
        for (int r = 0; r < nrows; ++r) {
          const float p = p_sm[r];
          const float sc = INT8 ? vs_sm[r] : 1.f;
#pragma unroll
          for (int e = 0; e < CPL; ++e) {
            const int col = lane + 32 * e;
            const float v =
                INT8 ? (float)reinterpret_cast<const signed char*>(
                           vt)[r * D + col] * sc
                     : reinterpret_cast<const float*>(vt)[r * D + col];
            a[e] = fmaf(p, v, a[e]);
          }
        }
#pragma unroll
        for (int e = 0; e < CPL; ++e) {
          const int col = lane + 32 * e;
          if (nchunks == 1)
            out[((size_t)(n * W + j) * H + h) * D + col] = a[e] / l;
          else
            ws_lane[((size_t)j * C + c) * DP + col] = a[e];
        }
      }
      if (lane == 0 && nchunks > 1) {
        ws_lane[((size_t)j * C + c) * DP + D] = mx;
        ws_lane[((size_t)j * C + c) * DP + D + 1] = l;
      }
      __syncwarp();                      // p_sm is the next token's
    }
  }
  mark(3);
  if (nchunks == 1) return;

  // the last block of this (lane, head) to finish combines the chunks in
  // order
  __syncthreads();                       // the block's partial is written
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(cnt + n * H + h, 1) == nchunks - 1;
  }
  __syncthreads();
  mark(4);
  if (!last) return;
  __threadfence();                       // the others' partials are seen
  // every chunk's (m, l), and the partials' rows in rounds of cb chunks
  // over the compute region (one round at the decode path's shapes): the
  // rows by cp.async, all of a round in flight together, no register
  // held for them
  const int nm = W * nchunks;
  const int cb = min(nchunks, max(1, L.region / (W * DP * 4)));
  float4* slab = reinterpret_cast<float4*>(sm + L.base);
  const float4* ws4 = reinterpret_cast<const float4*>(ws_lane);
  float* sums = reinterpret_cast<float*>(sm + L.off_sums);  // rounds > 1
  for (int c0 = 0; c0 < nchunks; c0 += cb) {
    const int nc = min(cb, nchunks - c0);
    const int n4 = W * nc * (DP / 4);
    for (int i = tid; i < n4; i += NT) {
      const int jk = i / (DP / 4), e = i % (DP / 4);
      const int jj = jk / nc, k = jk % nc;
      cp_async16(slab + (jj * cb + k) * (DP / 4) + e,
                 ws4 + ((size_t)jj * C + c0 + k) * (DP / 4) + e);
    }
    if (c0 == 0) {
      for (int i = tid; i < nm; i += NT) {
        const float* r =
            ws_lane + ((size_t)(i / nchunks) * C + i % nchunks) * DP;
        ml[i] = __ldcg(r + D);
        ml[nm + i] = __ldcg(r + D + 1);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (c0 == 0) {
      // a warp a token: M = max_c m_c (exact in any order), the weights
      // exp(m_c - M) over m_c, and the denominator sum_c w_c l_c by a
      // fixed butterfly
      for (int jj = warp; jj < W; jj += NT / 32) {
        float* m = ml + jj * nchunks;
        float mx = NEG;
        for (int k = lane; k < nchunks; k += 32) mx = fmaxf(mx, m[k]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float den = 0.f;
        for (int k = lane; k < nchunks; k += 32) {
          m[k] = expf(m[k] - mx);
          den += m[k] * m[nm + k];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          den += __shfl_xor_sync(0xffffffffu, den, o);
        if (lane == 0) dn[jj] = den;
      }
      __syncthreads();
    }
    // the numerators, a (token, column) a thread, in chunk order
    const float* sl = reinterpret_cast<const float*>(slab);
    for (int i = tid; i < W * D; i += NT) {
      const int jj = i / D, d = i % D;
      const float* w = ml + jj * nchunks + c0;
      float o = c0 ? sums[i] : 0.f;
#pragma unroll 4
      for (int k = 0; k < nc; ++k) o += w[k] * sl[(jj * cb + k) * DP + d];
      if (c0 + nc < nchunks)
        sums[i] = o;
      else
        out[((size_t)(n * W + jj) * H + h) * D + d] = o / dn[jj];
    }
    __syncthreads();
  }
  mark(5);
}

// a 3-D tensor map over a cache buffer (N, M, H*D) of f32 or int8 (as
// bytes), boxes of D columns x `sub` rows of one lane, no swizzle
inline int cache_map(CUtensorMap* map, const void* ptr, int int8, int N,
                     int M, int H, int D, int sub) {
  const wg::EncodeTiledFn f = wg::encode_tiled();
  if (!f) return (int)cudaErrorSharedObjectInitFailed;
  const int es = int8 ? 1 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)H * D, (cuuint64_t)M,
                              (cuuint64_t)N};
  const cuuint64_t strides[2] = {(cuuint64_t)H * D * es,
                                 (cuuint64_t)M * H * D * es};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)sub, 1};
  const cuuint32_t es3[3] = {1, 1, 1};
  memset(map, 0, sizeof(*map));
  const CUtensorMapDataType type = int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUresult r = f(
      map, type, 3, const_cast<void*>(ptr), dims, strides, box, es3,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, int R, bool INT8>
int launch(const CUtensorMap& km, const CUtensorMap& vm, const void* q,
           const void* ks, const void* vs, const void* pos, void* out,
           void* ws, void* cnt, int N, int W, int M, int H, int chunks,
           int smem, float scale, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      decode_attention<D, R, INT8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(cnt, 0, sizeof(int) * N * H, st);
  if (e != cudaSuccess) return (int)e;
  decode_attention<D, R, INT8><<<dim3(chunks, H, N), NT, smem, st>>>(
      km, vm, (const float*)q, (const float*)ks, (const float*)vs,
      (const int*)pos, (float*)out, (float*)ws, (int*)cnt, W, M, H, scale);
  return (int)cudaGetLastError();
}

template <int D, int R>
int launch_dr(int int8, const CUtensorMap& km, const CUtensorMap& vm,
              const void* q, const void* ks, const void* vs, const void* pos,
              void* out, void* ws, void* cnt, int N, int W, int M, int H,
              int chunks, int smem, float scale, cudaStream_t st) {
  return int8 ? launch<D, R, true>(km, vm, q, ks, vs, pos, out, ws, cnt, N,
                                   W, M, H, chunks, smem, scale, st)
              : launch<D, R, false>(km, vm, q, ks, vs, pos, out, ws, cnt,
                                    N, W, M, H, chunks, smem, scale, st);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace d1

// q, out (N, W, H, D) f32; k, v (N, M, H, D) f32, or int8 with f32 scales
// ks, vs (N, M, H) (int8 = 1; else ks, vs are ignored); positions (N,)
// int32, >= 0; ws (N, H, W, chunks, D + 4) f32; cnt (N * H,) int32,
// zeroed here (a memset node) before the launch; scale the f32
// 1 / sqrt(D) the plain version multiplies by. rows (32, 64 or 128),
// chunks and smem are the host plan's; a plan this file cannot run is
// refused with cudaErrorInvalidValue before any launch.
extern "C" int mxtt_decode_attention(const void* q, const void* k,
                                     const void* v, const void* ks,
                                     const void* vs, const void* pos,
                                     void* out, void* ws, void* cnt, int N,
                                     int W, int M, int H, int D, int int8,
                                     int rows, int chunks, int smem,
                                     float scale, void* stream) {
  if (N < 1 || M < 1 || H < 1 || W < 1 || W > 16 ||
      chunks != (M + rows - 1) / rows || N > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (!d1::aligned16(q) || !d1::aligned16(k) || !d1::aligned16(v) ||
      !d1::aligned16(out) || !d1::aligned16(ws))
    return (int)cudaErrorInvalidValue;
  const d1::Layout L = d1::layout(D, int8, rows, W, chunks);
  if (L.total != smem || smem > d1::SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const int sub = rows < d1::SUB ? rows : d1::SUB;
  CUtensorMap km, vm;
  int rc = d1::cache_map(&km, k, int8, N, M, H, D, sub);
  if (!rc) rc = d1::cache_map(&vm, v, int8, N, M, H, D, sub);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
#define D1_LAUNCH(DD, RR)                                                 \
  if (D == DD && rows == RR)                                              \
    return d1::launch_dr<DD, RR>(int8, km, vm, q, ks, vs, pos, out, ws,   \
                                 cnt, N, W, M, H, chunks, smem, scale,    \
                                 st);
#define D1_LAUNCH_R(DD) D1_LAUNCH(DD, 32) D1_LAUNCH(DD, 64) D1_LAUNCH(DD, 128)
  D1_LAUNCH_R(16)
  D1_LAUNCH_R(32)
  D1_LAUNCH_R(64)
  D1_LAUNCH_R(128)
  D1_LAUNCH_R(256)
#undef D1_LAUNCH_R
#undef D1_LAUNCH
  return (int)cudaErrorInvalidValue;
}

#ifdef D1_TRACE
// copies the per-block clocks to dst (8 x TRACE_BLOCKS u64), then zeroes
// them
extern "C" int mxtt_decode_attention_trace(void* dst) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, d1::trace_clock,
                                       sizeof(d1::trace_clock));
  if (e != cudaSuccess) return (int)e;
  void* p = nullptr;
  e = cudaGetSymbolAddress(&p, d1::trace_clock);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(p, 0, sizeof(d1::trace_clock));
}
#endif
