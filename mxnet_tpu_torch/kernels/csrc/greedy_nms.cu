// N1: the greedy NMS keep mask, and M1: greedy bipartite matching, for
// Hopper (sm_90a).
//
// Neither replaces a pl.pallas_call. They replace the two sequential
// device loops of the JAX package's box ops, each one on-device XLA
// `while` there:
// - N1: mxnet_tpu/ops/contrib.py:314-329 (_greedy_nms_keep), a
//   lax.fori_loop over N score-sorted boxes on a precomputed N x N
//   suppression matrix, under MultiBoxDetection, box_nms and Proposal;
// - M1: mxnet_tpu/ops/surface.py:455-468 (bipartite_matching), a
//   lax.fori_loop over the sorted entries of an N x M score matrix.
// In plain PyTorch each step of either loop is a launch or more (8,732
// steps an image for SSD300's anchors, 6,000 for Proposal's pre-NMS
// boxes, up to N * M for a matching), which no user can run on the card.
//
// N1 (two launches on the caller's stream):
// (a) nms_mask: a grid of (column block, row block, image) blocks of 64
//     threads writes the suppression bits, one 64-bit word per (row,
//     column block): bit j of row i is set where j > i, the boxes' IoU is
//     >= thresh and the class ids are equal (any ids under force). Words
//     below the diagonal block are never read by (b), so their blocks
//     exit at once and the words stay unwritten. The IoU is _box_iou's
//     (contrib.py:128-138) operation for operation, each rounded on its
//     own (__f*_rn: nvcc contracts a * b + c into an FMA by default, and
//     one rounding less flips keep bits at the threshold), with jnp's
//     NaN-propagating max / min.
// (b) nms_sweep: one block per image walks the 64-box chunks in order.
//     A "removed" bitset of ceil(N / 64) words lives in shared memory.
//     Warp 0 resolves a chunk's boxes one by one from the chunk's
//     diagonal words (a box is kept when valid and not removed; a kept
//     box removes the later boxes of its chunk), broadcasting each row's
//     word by shuffle; then the whole block ORs the kept rows' words of
//     the later chunks into the bitset (shared atomics, one (row, word)
//     pair a thread, four loads in flight). keep[i] is the reference
//     loop's keep after step i, which step i's update fixes.
// What bounds N1: operations. The mask costs N(N-1)/2 IoUs an image at
// ~12 fp32 operations each, against a few bytes an input box; the sweep
// reads only the kept rows' words.
//
// M1 (one launch): one warp per batch item walks the first k entries of
// the order (the sorted score indices) 32 at a time. Each lane tests its
// entry against the matches so far (row and column unmatched, the score
// past the threshold); the first lane that passes is the next match of
// the sequential loop (a failed entry never passes later: matches only
// grow), so it writes the match and the lanes after it test again. The
// walk ends after min(N, M) matches, when no entry can pass. What bounds
// it: bytes (each entry's index and score read once), in practice the
// latency of the dependent re-tests.
//
// The plans (grids, threads, shared memory) are the host's
// (ops/nms.py: _n1_plan, _m1_plan); the entries check them and refuse a
// mismatch before any launch. Each kernel launches on the given stream,
// synchronises nothing and allocates nothing: the wrapper allocates the
// suppression words with torch.empty.

#include <cuda_runtime.h>
#include <stdint.h>

namespace n1 {

constexpr int TB = 64;                  // boxes a word, rows a mask block
constexpr int SWEEP_THREADS = 512;
constexpr int UNR = 4;                  // sweep loads a thread keeps in flight
constexpr int SMEM_MAX = 231424;        // an H100 block's 227 KB less 1 KB
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// _box_iou of boxes a and b (corner format), in its order of operations
__device__ __forceinline__ float box_iou(const float* a, const float* b) {
  const float w = nmax(__fsub_rn(nmin(a[2], b[2]), nmax(a[0], b[0])), 0.f);
  const float h = nmax(__fsub_rn(nmin(a[3], b[3]), nmax(a[1], b[1])), 0.f);
  const float inter = __fmul_rn(w, h);
  const float area_a = __fmul_rn(nmax(__fsub_rn(a[2], a[0]), 0.f),
                                 nmax(__fsub_rn(a[3], a[1]), 0.f));
  const float area_b = __fmul_rn(nmax(__fsub_rn(b[2], b[0]), 0.f),
                                 nmax(__fsub_rn(b[3], b[1]), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

__global__ void __launch_bounds__(TB)
nms_mask(const float* __restrict__ boxes, const float* __restrict__ ids,
         u64* __restrict__ mask, int N, int W, float thresh, int force) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  if (cb < rb) return;                  // below the diagonal: never read
  __shared__ float cbox[TB][4];
  __shared__ float cid[TB];
  const int t = threadIdx.x;
  const int ncols = min(TB, N - cb * TB);
  const float* bx = boxes + (size_t)b * N * 4;
  const float* id = ids + (size_t)b * N;
  if (t < ncols) {
    const int j = cb * TB + t;
#pragma unroll
    for (int k = 0; k < 4; ++k) cbox[t][k] = bx[(size_t)j * 4 + k];
    cid[t] = id[j];
  }
  __syncthreads();
  const int i = rb * TB + t;
  if (i >= N) return;
  float a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = bx[(size_t)i * 4 + k];
  const float ai = id[i];
  u64 bits = 0;
  for (int j = (cb == rb) ? t + 1 : 0; j < ncols; ++j) {
    if ((force || cid[j] == ai) && box_iou(a, cbox[j]) >= thresh)
      bits |= 1ull << j;
  }
  mask[((size_t)b * N + i) * W + cb] = bits;
}

__global__ void __launch_bounds__(SWEEP_THREADS)
nms_sweep(const u64* __restrict__ mask, const uint8_t* __restrict__ valid,
          uint8_t* __restrict__ keep, int N, int W) {
  extern __shared__ u64 removed[];      // W words
  __shared__ int kept_rows[TB];         // the chunk's kept rows, in order
  __shared__ int n_kept;
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31;
  for (int w = t; w < W; w += blockDim.x) removed[w] = 0;
  __syncthreads();
  const u64* rows = mask + (size_t)b * N * W;
  const uint8_t* vb = valid + (size_t)b * N;
  uint8_t* kb_out = keep + (size_t)b * N;
  for (int c = 0; c < W; ++c) {
    const int n0 = c * TB;
    const int nrows = min(TB, N - n0);
    if (t < 32) {
      // warp 0: the chunk's boxes one by one, from its diagonal words
      const bool has_lo = lane < nrows, has_hi = lane + 32 < nrows;
      const u64 w_lo = has_lo ? rows[(size_t)(n0 + lane) * W + c] : 0ull;
      const u64 w_hi = has_hi ? rows[(size_t)(n0 + lane + 32) * W + c]
                              : 0ull;
      const int v_lo = has_lo ? (vb[n0 + lane] != 0) : 0;
      const int v_hi = has_hi ? (vb[n0 + lane + 32] != 0) : 0;
      u64 cur = removed[c];
      u64 kept = 0;
      for (int r = 0; r < nrows; ++r) {
        const u64 w = __shfl_sync(FULL, r < 32 ? w_lo : w_hi, r & 31);
        const int v = __shfl_sync(FULL, r < 32 ? v_lo : v_hi, r & 31);
        if (v && !((cur >> r) & 1ull)) {
          kept |= 1ull << r;
          cur |= w;
        }
      }
      const bool k_lo = has_lo && ((kept >> lane) & 1ull);
      const bool k_hi = has_hi && ((kept >> (lane + 32)) & 1ull);
      if (has_lo) kb_out[n0 + lane] = (uint8_t)k_lo;
      if (has_hi) kb_out[n0 + lane + 32] = (uint8_t)k_hi;
      if (k_lo) kept_rows[__popcll(kept & ((1ull << lane) - 1))] = lane;
      if (k_hi)
        kept_rows[__popcll(kept & ((1ull << (lane + 32)) - 1))] = lane + 32;
      if (lane == 0) {
        removed[c] = cur;
        n_kept = __popcll(kept);
      }
    }
    __syncthreads();
    // the block: each kept row's words of the later chunks into the
    // bitset, one (row, word) pair a thread, UNR loads in flight at once
    const int nw = W - c - 1;
    const int total = n_kept * nw;
    for (int p0 = t; p0 < total; p0 += UNR * SWEEP_THREADS) {
      u64 v[UNR];
      int at[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int p = p0 + u * SWEEP_THREADS;
        v[u] = 0ull;
        at[u] = 0;
        if (p < total) {
          at[u] = c + 1 + p % nw;
          v[u] = rows[(size_t)(n0 + kept_rows[p / nw]) * W + at[u]];
        }
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u)
        if (v[u]) atomicOr(&removed[at[u]], v[u]);
    }
    __syncthreads();
  }
}

}  // namespace n1

namespace m1 {

constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(32)
bipartite_match(const float* __restrict__ scores,
                const int64_t* __restrict__ order, float* row_match,
                float* col_match, int N, int M, long long stride,
                long long k, float thresh, int ascend) {
  const int b = blockIdx.x, lane = threadIdx.x;
  volatile float* rm = row_match + (size_t)b * N;
  volatile float* cm = col_match + (size_t)b * M;
  for (int i = lane; i < N; i += 32) rm[i] = -1.f;
  for (int i = lane; i < M; i += 32) cm[i] = -1.f;
  __syncwarp();
  const float* s = scores + (size_t)b * N * M;
  const int64_t* o = order + (size_t)b * stride;
  const int most = min(N, M);
  int matched = 0;
  for (long long base = 0; base < k && matched < most; base += 32) {
    const long long i = base + lane;
    int r = 0, c = 0;
    bool cand = false;
    if (i < k) {
      const long long idx = o[i];
      r = (int)(idx / M);
      c = (int)(idx % M);
      const float v = s[idx];
      cand = ascend ? (v < thresh) : (v > thresh);
    }
    int after = -1;                     // lanes up to here are settled
    while (matched < most) {
      const bool ok = cand && lane > after && rm[r] < 0.f && cm[c] < 0.f;
      const unsigned bal = __ballot_sync(FULL, ok);
      if (!bal) break;
      const int first = __ffs(bal) - 1;
      if (lane == first) {
        rm[r] = (float)c;
        cm[c] = (float)r;
      }
      __syncwarp();
      after = first;
      ++matched;
    }
  }
}

}  // namespace m1

extern "C" int mxtt_nms_keep(const void* boxes, const void* ids,
                             const void* valid, void* mask, void* keep,
                             int B, int N, int W, float thresh, int force,
                             int threads, int smem, void* stream) {
  if (B < 1 || N < 1 || W != (N + n1::TB - 1) / n1::TB || B > 65535 ||
      W > 65535 || threads != n1::SWEEP_THREADS ||
      smem != W * (int)sizeof(unsigned long long) || smem > n1::SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  n1::nms_mask<<<dim3(W, W, B), n1::TB, 0, st>>>(
      (const float*)boxes, (const float*)ids, (n1::u64*)mask, N, W, thresh,
      force);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(n1::nms_sweep,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  n1::nms_sweep<<<B, threads, smem, st>>>(
      (const n1::u64*)mask, (const uint8_t*)valid, (uint8_t*)keep, N, W);
  return (int)cudaGetLastError();
}

extern "C" int mxtt_bipartite_match(const void* scores, const void* order,
                                    void* row_match, void* col_match, int B,
                                    int N, int M, long long stride,
                                    long long k, float thresh, int ascend,
                                    void* stream) {
  if (B < 1 || N < 1 || M < 1 || k < 0 || k > stride ||
      stride > (long long)N * M)
    return (int)cudaErrorInvalidValue;
  m1::bipartite_match<<<B, 32, 0, (cudaStream_t)stream>>>(
      (const float*)scores, (const int64_t*)order, (float*)row_match,
      (float*)col_match, N, M, stride, k, thresh, ascend);
  return (int)cudaGetLastError();
}
