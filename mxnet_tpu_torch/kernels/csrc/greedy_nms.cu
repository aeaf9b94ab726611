// N1: greedy NMS keep bits, and M1: greedy bipartite matching, for
// Hopper (sm_90a).
//
// Neither replaces a pl.pallas_call. They replace the sequential device
// loops of the JAX package's box ops, each one on-device XLA `while`
// there:
// - N1: mxnet_tpu/ops/contrib.py:314-329 (_greedy_nms_keep), a
//   lax.fori_loop over N score-sorted boxes on a precomputed N x N
//   suppression matrix, under MultiBoxDetection, box_nms and Proposal;
// - M1: mxnet_tpu/ops/surface.py:455-468 (bipartite_matching), a
//   lax.fori_loop over the sorted entries of an N x M score matrix, and
//   mxnet_tpu/ops/contrib.py:210-225 (MultiBoxTarget's bipartite_round),
//   a lax.scan of L argmax rounds over an A x L IoU matrix.
// In plain PyTorch each step of any of them is a launch or more.
//
// N1 (two or three launches a group of images, after the wrapper's
// stable sort of a class key when an image holds more than 512 boxes):
// - What the reference's loop allows. A box that is not valid is never
//   kept and so suppresses nothing; boxes of two classes (ids unequal
//   under the kernel's `==`: NaN equals nothing, -0.0 equals 0.0) never
//   meet. So the valid boxes split into per-(image, class) segments, in
//   score order within each, and each segment is an NMS of its own.
// - n1_prep (a block an image) orders an image's boxes (the valid ones
//   first, grouped by class, each group in score order: the wrapper's
//   sort, or up to 512 boxes a rank of each key in the block), gathers
//   them, marks where a segment starts (a new class, or every NaN id),
//   numbers the segments with a block scan and zeroes the keep bits.
// - A segment goes in chunks of 64 boxes. Resolving a chunk: its 64 x 64
//   IoU bits, then rounds on one warp (a box is kept once no undecided
//   earlier box of the chunk suppresses it; its later suppressed boxes
//   drop out: the sequential loop's bits, a chain of k dependent boxes
//   in k rounds, usually 1-3). Two routes, which the plan picks:
// - "segments" (class-aware): n1_segments, a block of 256 threads a
//   segment, the image's segments dealt to enough blocks to fill the
//   card; each chunk in turn, its kept boxes then tested against the
//   segment's later boxes not yet removed: only the IoUs that can decide
//   a bit.
// - "mask" (force_suppress: one segment an image, e.g. Proposal's 6,000
//   boxes, 94 chunks in a chain): n1_mask computes the upper triangle of
//   64 x 64 blocks of IoU bits over the valid boxes on the whole card,
//   then n1_sweep (a block an image) resolves the chunks on warp 0 from
//   the words, looking 4 chunks back (their rows' word of this chunk,
//   with their kept masks; the next chunk's words load while this one
//   resolves), while warps 1-15 OR each resolved chunk's kept rows'
//   later words into the removed bitset, off the chain. The wrapper
//   calls it for groups of images whose bits take up to 64 MB (or for
//   one image, whatever its bits take).
// - The IoU test is _box_iou's (contrib.py:128-138) bit for bit. Where
//   an image holds a box with a coordinate that is not finite, it is
//   computed operation for operation, each rounded on its own (__f*_rn:
//   nvcc contracts a * b + c into an FMA by default, and one rounding
//   less flips bits at the threshold), with jnp's NaN-propagating max /
//   min; a pair whose overlap width or height is exactly 0 has IoU
//   exactly 0 (inter is 0, or NaN where the other side is; the
//   reference's `where(union > 0, inter / union, 0)` gives 0 either
//   way), so its bit is `0 >= thresh` without the division. With every
//   coordinate finite no intermediate is NaN, so fminf / fmaxf give the
//   same values, and RN(inter / union) >= thresh is decided without the
//   division: it holds exactly when inter > m * union, or = m * union
//   with thresh's last bit even (a tie rounds to even), m the midpoint
//   of thresh and the float below it (25 bits: m * union is exact in
//   double). A threshold <= 0 holds for every pair (the IoU is never
//   below 0), a NaN one for none. The IoU is symmetric bit for bit
//   (max, min, + and * commute; a zero's sign never reaches the bit), so
//   a chunk's rows give each box's earlier suppressors too.
// What bounds N1 at its users' sizes: the IoUs each route computes
// (operations), and for one long segment the chain of its chunks; the
// bound from the card's peak is operations (~12 a needed IoU).
//
// M1, two modes, one block a matrix, the match state in shared memory:
// - bipartite_walk visits the first k entries of a given order (flat
//   indices, the sort is the caller's). Warp 0 walks a window of 256
//   entries 32 at a time: each lane tests its entry (row and column
//   free, score past the threshold) against the bitsets; the first lane
//   that passes is the sequential loop's next match (an entry that fails
//   never passes later: matches only grow), so it records the match and
//   the lanes whose row or column it took drop out. Meanwhile warps 1-15
//   stage the next window of 512 (row, column, pass) into the other
//   buffer. The score's address depends on the index just read, so the
//   staging is plain loads, not a bulk copy. The walk ends after
//   min(N, M) matches; the block writes them out.
// - bipartite_rounds is MultiBoxTarget's stage 1 without a sort: the
//   first largest IoU of the free anchors and ground truths, matched when
//   > 1e-6, L times. Each ground-truth column keeps its best free anchor
//   (largest IoU, NaN above all as torch.argmax takes it, the lower
//   anchor among ties) in shared memory, from one pass over the matrix
//   (column_tiles: a block a tile of 128 anchors, over the whole card).
//   A round takes the best column (value, then the lower anchor, then
//   the lower column: the row-major first maximum) and matches it, on
//   one warp; the block rescans only the free columns whose best anchor
//   it took (not one whose best is at or below 1e-6: it cannot match
//   again, and padded label slots share one best anchor). Up to 64
//   columns a warp sorts their keys and takes the sorted columns as
//   successive rounds until one whose anchor this batch took (a column
//   that needs a rescan can only fall). It stops at the first pick not
//   above 1e-6 (the reference's later rounds change nothing) or after
//   min(A, L) matches.
// What bounds M1: bytes (the IoU matrix read once; the walk's entries up
// to its last match), in practice latency: dependent re-tests and rounds.
//
// The plans (routes, groups, grids, shared memory) are the host's
// (ops/nms.py: _n1_plan, _m1_plan); the entries check them and refuse a
// mismatch before any launch. Each kernel launches on the given stream,
// synchronises nothing and allocates nothing: the wrapper allocates the
// sort, the gathered boxes and the segment table with torch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace n1 {

constexpr int TB = 64;                  // boxes a chunk
constexpr int PREP_THREADS = 1024;
constexpr int SEG_THREADS = 256;        // n1_segments' block
constexpr int SWEEP_THREADS = 512;      // n1_sweep's block
constexpr int SWEEP_BATCH = 8;          // chunks its appliers take at once
constexpr int SMEM_MAX = 231424;        // an H100 block's 227 KB less 1 KB
constexpr int STATIC_SMEM = 16384;      // the kernels' own arrays, rounded up
constexpr unsigned FULL = 0xffffffffu;
constexpr int RANK_MAX = 512;           // boxes n1_prep orders itself
constexpr int NAN_KEY = 0x7ffffffe, INVALID_KEY = 0x7fffffff;
constexpr int LOOK = 4;                 // chunks n1_sweep looks back

typedef unsigned long long u64;

__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// _box_iou(a, b) >= thresh, a the earlier box (corner format). A pair
// whose overlap width or height is exactly 0 has IoU exactly 0 (inter is
// 0, or NaN where the other side is; the reference's `where(union > 0,
// inter / union, 0)` gives 0 either way), so its bit is `0 >= thresh`
// without the areas or the division
__device__ __forceinline__ bool iou_ge(float4 a, float4 b, float thresh) {
  const float w = nmax(__fsub_rn(nmin(a.z, b.z), nmax(a.x, b.x)), 0.f);
  const float h = nmax(__fsub_rn(nmin(a.w, b.w), nmax(a.y, b.y)), 0.f);
  if (w == 0.f || h == 0.f) return 0.f >= thresh;
  const float inter = __fmul_rn(w, h);
  const float area_a = __fmul_rn(nmax(__fsub_rn(a.z, a.x), 0.f),
                                 nmax(__fsub_rn(a.w, a.y), 0.f));
  const float area_b = __fmul_rn(nmax(__fsub_rn(b.z, b.x), 0.f),
                                 nmax(__fsub_rn(b.w, b.y), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return (uni > 0.f ? __fdiv_rn(inter, uni) : 0.f) >= thresh;
}

// The threshold as the kernels test it. For thresh > 0, RN(q) >= thresh
// exactly when q is above the midpoint m of thresh and the float below
// it, or at m when thresh's last bit is even (a tie rounds to even); m
// has 25 significant bits, so m * uni is exact in double
struct Thr {
  float t;
  double m;
  int mode;                             // 0: never (NaN), 1: always (<= 0), 2
  bool tie_up;
};
__device__ __forceinline__ Thr make_thr(float t) {
  Thr r;
  r.t = t;
  r.mode = t != t ? 0 : (t <= 0.f ? 1 : 2);
  r.m = ((double)nextafterf(t, 0.f) + (double)t) * 0.5;
  r.tie_up = (__float_as_uint(t) & 1u) == 0;
  return r;
}

// iou_ge for boxes whose coordinates are all finite: no intermediate is
// then NaN, so fminf / fmaxf give jnp's max / min, and the division's
// rounded quotient is compared through the midpoint. The IoU is never
// NaN and never below 0, so a threshold <= 0 holds for every pair and a
// NaN one for none
__device__ __forceinline__ bool iou_ge_fast(float4 a, float4 b,
                                            const Thr& th) {
  if (th.mode != 2) return th.mode == 1;
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  if (w == 0.f || h == 0.f) return false;
  const float inter = __fmul_rn(w, h);
  const float area_a = __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.f),
                                 fmaxf(__fsub_rn(a.w, a.y), 0.f));
  const float area_b = __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                                 fmaxf(__fsub_rn(b.w, b.y), 0.f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (!(uni > 0.f)) return false;
  const double lhs = (double)inter, rhs = th.m * (double)uni;
  return lhs > rhs || (lhs == rhs && th.tie_up);
}

// the pair's bit: the fast test unless the image holds a box with a
// coordinate that is not finite (slow: a flag n1_prep sets an image)
__device__ __forceinline__ bool iou_hit(float4 a, float4 b, const Thr& th,
                                        bool slow) {
  return slow ? iou_ge(a, b, th.t) : iou_ge_fast(a, b, th);
}

// n1_order's key: the valid boxes by class id (-0.0 as 0.0, every NaN one
// key), the invalid ones last; under force_suppress 0 and 1
__device__ __forceinline__ int order_key(float id, bool v, int force) {
  if (!v) return INVALID_KEY;
  if (force) return 0;
  if (id != id) return NAN_KEY;
  return __float_as_int(__fadd_rn(id, 0.f));
}

// a segment starts at sorted position p: the first valid box, or a valid
// box whose id differs from the one before it (NaN differs from all)
__device__ __forceinline__ bool seg_start(const float* id, const uint8_t* v,
                                          const int64_t* perm, int p,
                                          int force) {
  const int64_t o = perm[p];
  if (!v[o]) return false;
  if (p == 0) return true;
  const int64_t q = perm[p - 1];
  return !v[q] || (!force && !(id[o] == id[q]));
}

__global__ void __launch_bounds__(PREP_THREADS)
n1_prep(const float4* __restrict__ boxes, const float* __restrict__ ids,
        const uint8_t* __restrict__ valid, int64_t* __restrict__ perm,
        float4* __restrict__ sbox, int* __restrict__ segoff,
        int* __restrict__ nseg, int* __restrict__ slow, uint8_t* __restrict__ keep,
        int N, int force, int rank_order) {
  __shared__ int warp_tot[PREP_THREADS / 32];
  __shared__ int n_valid, n_slow;
  __shared__ int skey[RANK_MAX];
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const size_t off = (size_t)b * N;
  const float* id = ids + off;
  const uint8_t* v = valid + off;
  int64_t* pm = perm + off;
  int* so = segoff + (size_t)b * (N + 1);
  if (t == 0) n_valid = n_slow = 0;
  if (rank_order) {
    // n1_order's stable sort, for a few boxes: each box's rank among
    // the keys, ties by index
    for (int p = t; p < N; p += PREP_THREADS)
      skey[p] = order_key(id[p], v[p] != 0, force);
    __syncthreads();
    for (int p = t; p < N; p += PREP_THREADS) {
      const int k = skey[p];
      int r = 0;
      for (int q = 0; q < N; ++q) {
        const int kq = skey[q];
        r += kq < k || (kq == k && q < p);
      }
      pm[r] = p;
    }
  }
  __syncthreads();
  const int per = (N + PREP_THREADS - 1) / PREP_THREADS;
  const int p0 = min(N, t * per), p1 = min(N, p0 + per);
  int starts = 0, nv = 0, ns = 0;
  unsigned flags = 0;                   // the first 32 positions' starts
#pragma unroll 4
  for (int p = p0; p < p1; ++p) {
    const int64_t o = pm[p];
    const float4 bx = boxes[off + o];
    sbox[off + p] = bx;
    ns += !(isfinite(bx.x) && isfinite(bx.y) && isfinite(bx.z)
            && isfinite(bx.w));
    keep[off + p] = 0;
    nv += v[o] != 0;
    const bool st = seg_start(id, v, pm, p, force);
    starts += st;
    if (st && p - p0 < 32) flags |= 1u << (p - p0);
  }
  if (nv) atomicAdd(&n_valid, nv);
  if (ns) atomicAdd(&n_slow, ns);
  // exclusive scan of the starts over the block
  int incl = starts;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_tot[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int w = warp_tot[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += up;
    }
    warp_tot[lane] = w;                 // inclusive over the warps
  }
  __syncthreads();
  int s = incl - starts + (wid ? warp_tot[wid - 1] : 0);
  for (int p = p0; p < p1; ++p)
    if (p - p0 < 32 ? (flags >> (p - p0)) & 1u
                    : seg_start(id, v, pm, p, force))
      so[s++] = p;
  if (t == PREP_THREADS - 1) {
    nseg[b] = s;                        // the last thread's end: the total
    so[s] = n_valid;
    slow[b] = n_slow > 0;
  }
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// the kept boxes kl[0..n) against the segment's boxes sb[u_begin..len),
// by nt threads (t the caller's index among them): a box not yet removed
// is removed by the first kept box that suppresses it; up to 16 threads
// share a box when there are few
__device__ __forceinline__ void apply(const float4* kl, int n,
                                      const float4* __restrict__ sb,
                                      uint8_t* removed, int u_begin, int len,
                                      const Thr& th, bool slow, int t,
                                      int nt) {
  const int ncols = len - u_begin;
  if (n == 0 || ncols <= 0) return;
  int lg = 0;
  while (lg < 4 && (ncols << (lg + 1)) <= nt) ++lg;
  const int L = 1 << lg;
  for (int u = u_begin + (t >> lg); u < len; u += nt >> lg) {
    if (removed[u]) continue;
    const float4 bx = sb[u];
    for (int k = t & (L - 1); k < n; k += L)
      if (iou_hit(kl[k], bx, th, slow)) {
        removed[u] = 1;
        break;
      }
  }
}

// one chunk's resolve on a warp, lane l holding rows l and l + 32: the
// boxes in cand that are kept, given each row's IoU bits (sym: the
// chunk's symmetric bits, the diagonal clear)
__device__ __forceinline__ u64 resolve_rounds(u64 cand, u64 s0, u64 s1,
                                              int l) {
  const u64 pred0 = s0 & ((1ull << l) - 1);
  const u64 pred1 = s1 & ((1ull << (l + 32)) - 1);
  const u64 succ0 = s0 & ~((2ull << l) - 1);
  const u64 succ1 = s1 & ~((2ull << (l + 32)) - 1);
  u64 undec = cand, kept = 0;
  while (undec) {
    const bool k0 = ((undec >> l) & 1ull) && !(pred0 & undec);
    const bool k1 = ((undec >> (l + 32)) & 1ull) && !(pred1 & undec);
    const u64 nk = (u64)__ballot_sync(FULL, k0)
                   | ((u64)__ballot_sync(FULL, k1) << 32);
    const u64 rm = (k0 ? succ0 : 0ull) | (k1 ? succ1 : 0ull);
    const u64 lo = __reduce_or_sync(FULL, (unsigned)rm);
    const u64 hi = __reduce_or_sync(FULL, (unsigned)(rm >> 32));
    kept |= nk;
    undec &= ~(nk | lo | (hi << 32));
  }
  return kept;
}

// the route "segments": a block a segment, each chunk in turn
__global__ void __launch_bounds__(SEG_THREADS, 4)
n1_segments(const float4* __restrict__ sbox,
            const int64_t* __restrict__ perm, const int* __restrict__ segoff,
            const int* __restrict__ nseg, const int* __restrict__ slow_img,
            uint8_t* __restrict__ keep, int N, int Q, float thresh) {
  extern __shared__ uint8_t removed[];  // the segment's columns' flags
  __shared__ float4 pub[2][TB];         // a resolved chunk's kept boxes
  __shared__ int pub_n[2];
  __shared__ float4 cbox[TB];           // the chunk being resolved
  __shared__ u64 srow[TB];              // its rows' IoU bits
  __shared__ u64 kept_s;
  const int t = threadIdx.x, q = blockIdx.x, b = blockIdx.y;
  const Thr th = make_thr(thresh);
  const bool slow = slow_img[b] != 0;
  const size_t off = (size_t)b * N;
  const int* so = segoff + (size_t)b * (N + 1);
  const int ns = nseg[b];
  for (int s = q; s < ns; s += Q) {
    const int start = so[s], len = so[s + 1] - start;
    const int nch = (len + TB - 1) / TB;
    const float4* sb = sbox + off + start;
    const int64_t* pm = perm + off + start;
    for (int u = t; u < nch * TB; u += SEG_THREADS) removed[u] = 0;
    for (int c = 0; c < nch; ++c) {
      const int base = c * TB, nr = min(TB, len - base);
      if (t < nr) cbox[t] = sb[base + t];
      __syncthreads();
      // (i) the chunk's IoU bits: 4 threads a row, 16 columns each
      {
        const int r = t >> 2, j0 = (t & 3) * 16;
        u64 part = 0;
        if (r < nr) {
          const float4 a = cbox[r];
#pragma unroll 4
          for (int j = j0; j < j0 + 16; ++j)
            if (j != r && j < nr && iou_hit(a, cbox[j], th, slow))
              part |= 1ull << j;
        }
        part |= __shfl_xor_sync(FULL, part, 1);
        part |= __shfl_xor_sync(FULL, part, 2);
        if ((t & 3) == 0) srow[r] = part;
      }
      // (ii) chunk c - 1's kept boxes against the columns from c on
      if (c > 0)
        apply(pub[(c - 1) & 1], pub_n[(c - 1) & 1], sb, removed, base, len,
              th, slow, t, SEG_THREADS);
      __syncthreads();
      // (iii) resolve on warp 0 and publish the kept boxes in order
      if (t < 32) {
        const int l = t;
        const u64 cand =
            (u64)__ballot_sync(FULL, l < nr && !removed[base + l])
            | ((u64)__ballot_sync(FULL, l + 32 < nr && !removed[base + l + 32])
               << 32);
        const u64 kept = resolve_rounds(cand, srow[l], srow[l + 32], l);
        const int pb = c & 1;
        if ((kept >> l) & 1ull)
          pub[pb][__popcll(kept & ((1ull << l) - 1))] = cbox[l];
        if ((kept >> (l + 32)) & 1ull)
          pub[pb][__popcll(kept & ((1ull << (l + 32)) - 1))] = cbox[l + 32];
        if (l == 0) {
          pub_n[pb] = __popcll(kept);
          kept_s = kept;
        }
      }
      __syncthreads();
      if (t < nr && ((kept_s >> t) & 1ull)) keep[off + pm[base + t]] = 1;
    }
  }
}

// the route "mask" (force_suppress, a few images): the upper triangle
// of 64 x 64 blocks of IoU bits over an image's valid boxes, the whole
// card at once (the diagonal blocks symmetric, for the rounds); blocks
// below the diagonal or past the valid boxes exit at once
__global__ void __launch_bounds__(TB)
n1_mask(const float4* __restrict__ sbox, const int* __restrict__ segoff,
        const int* __restrict__ nseg, const int* __restrict__ slow_img,
        u64* __restrict__ mask, int N, int W, float thresh) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  const Thr th = make_thr(thresh);
  const bool slow = slow_img[b] != 0;
  const int nv = segoff[(size_t)b * (N + 1) + nseg[b]];
  if (cb < rb || cb * TB >= nv) return;
  __shared__ float4 cbx[TB];
  const int t = threadIdx.x, ncols = min(TB, nv - cb * TB);
  const float4* sb = sbox + (size_t)b * N;
  if (t < ncols) cbx[t] = sb[cb * TB + t];
  __syncthreads();
  const int i = rb * TB + t;
  if (i >= nv) return;
  const float4 a = sb[i];
  u64 bits = 0;
  for (int j = 0; j < ncols; ++j)
    if ((cb != rb || j != t) && iou_hit(a, cbx[j], th, slow))
      bits |= 1ull << j;
  mask[((size_t)b * N + i) * W + cb] = bits;
}

// the sweep of the mask, a block an image: warp 0 resolves the chunks in
// order from the mask's words (the chunk's own block, and for the LOOK
// chunks before it their rows' word of this chunk, with their kept
// masks; the next chunk's words load while this one resolves); warps
// 1-15 take the chunks resolved since their last batch, OR their kept
// rows' later words into the removed bitset and write their keep bits,
// up to LOOK chunks behind, off the chain
__global__ void __launch_bounds__(SWEEP_THREADS)
n1_sweep(const u64* __restrict__ mask, const int64_t* __restrict__ perm,
         const int* __restrict__ segoff, const int* __restrict__ nseg,
         uint8_t* __restrict__ keep, int N, int W) {
  extern __shared__ u64 sw[];
  u64* removed = sw;                    // W words over the valid boxes
  u64* kmask = sw + W;                  // each chunk's kept mask
  __shared__ int resolved, applied;     // chunks done by each side
  __shared__ int batch_end;
  __shared__ int krow[SWEEP_BATCH][TB]; // appliers: a batch's kept rows
  const int b = blockIdx.x, t = threadIdx.x;
  const int nv = segoff[(size_t)b * (N + 1) + nseg[b]];
  const int wv = (nv + TB - 1) / TB;
  const u64* mb = mask + (size_t)b * N * W;
  const int64_t* pm = perm + (size_t)b * N;
  for (int w = t; w < wv; w += SWEEP_THREADS) removed[w] = 0;
  if (t == 0) resolved = applied = 0;
  __syncthreads();
  if (t < 32) {
    const int l = t;
    // the words chunk c resolves from: its own block's rows l, l + 32,
    // and the rows of the LOOK chunks before it, all at word c
    auto load = [&](int c, u64* dd, u64 (*xx)[2]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = c * TB + l + 32 * h;
        dd[h] = r < nv ? mb[(size_t)r * W + c] : 0ull;
#pragma unroll
        for (int e = 0; e < LOOK; ++e)
          xx[e][h] = e < c ? mb[(size_t)((c - 1 - e) * TB + l + 32 * h) * W + c]
                           : 0ull;
      }
    };
    auto resolve = [&](int c, u64* dd, u64 (*xx)[2]) {
      if (c > LOOK)
        for (int i = 0;; ++i) {
          if (*(volatile int*)&applied >= c - LOOK) break;
          if (i == (1 << 24)) __trap();
        }
      __threadfence_block();
      u64 xs = 0;
#pragma unroll
      for (int e = 0; e < LOOK; ++e) {
        const u64 m = e < c ? kmask[c - 1 - e] : 0ull;
        const u64 v = (((m >> l) & 1ull) ? xx[e][0] : 0ull)
                      | (((m >> (l + 32)) & 1ull) ? xx[e][1] : 0ull);
        xs |= (u64)__reduce_or_sync(FULL, (unsigned)v)
              | ((u64)__reduce_or_sync(FULL, (unsigned)(v >> 32)) << 32);
      }
      const int nr = min(TB, nv - c * TB);
      const u64 in = nr == TB ? ~0ull : (1ull << nr) - 1;
      const u64 cand = in & ~*(volatile u64*)&removed[c] & ~xs;
      const u64 kept = resolve_rounds(cand, dd[0], dd[1], l);
      if (l == 0) kmask[c] = kept;
      __syncwarp();
      __threadfence_block();
      if (l == 0) *(volatile int*)&resolved = c + 1;
    };
    // two buffers: the next chunk's words load while this one resolves
    u64 d0[2], x0[LOOK][2], d1[2], x1[LOOK][2];
    load(0, d0, x0);
    for (int c = 0; c < wv; c += 2) {
      if (c + 1 < wv) load(c + 1, d1, x1);
      resolve(c, d0, x0);
      if (c + 1 >= wv) break;
      if (c + 2 < wv) load(c + 2, d0, x0);
      resolve(c + 1, d1, x1);
    }
  } else {
    // the chunks resolved since the last batch (up to SWEEP_BATCH): their
    // kept rows' later words into the removed bitset, four loads a
    // thread in flight, then their keep bits
    const int at = t - 32, nt = SWEEP_THREADS - 32;
    for (int c0 = 0; c0 < wv;) {
      if (at == 0) {
        int r;
        for (int i = 0;; ++i) {
          r = *(volatile int*)&resolved;
          if (r > c0) break;
          if (i == (1 << 22)) __trap();
          __nanosleep(32);
        }
        __threadfence_block();
        batch_end = min(r, c0 + SWEEP_BATCH);
      }
      bar_sync(1, nt);
      const int c1 = batch_end;
      for (int i = at; i < (c1 - c0) * TB; i += nt) {
        const int c = c0 + i / TB, r = i % TB;
        const u64 km = *(volatile u64*)&kmask[c];
        if ((km >> r) & 1ull)
          krow[i / TB][__popcll(km & ((1ull << r) - 1))] = c * TB + r;
      }
      bar_sync(1, nt);
      for (int c = c0; c < c1; ++c) {
        const int nk = __popcll(kmask[c]), nw = wv - c - 1;
        const int* kr = krow[c - c0];
        for (int p0 = at; p0 < nk * nw; p0 += 4 * nt) {
          u64 v[4];
          int w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int p = p0 + u * nt;
            w[u] = c + 1 + p % max(nw, 1);
            v[u] = p < nk * nw ? mb[(size_t)kr[p / nw] * W + w[u]] : 0ull;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (v[u]) atomicOr(&removed[w[u]], v[u]);
        }
      }
      for (int i = at; i < (c1 - c0) * TB; i += nt) {
        const int c = c0 + i / TB, r = i % TB;
        if ((kmask[c] >> r) & 1ull) keep[(size_t)b * N + pm[c * TB + r]] = 1;
      }
      bar_sync(1, nt);
      if (at == 0) {
        __threadfence_block();
        *(volatile int*)&applied = c1;
      }
      c0 = c1;
    }
  }
}

}  // namespace n1

namespace m1 {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WALK_THREADS = 512;
constexpr int WIN = 512;                // entries a window
constexpr int ROUND_THREADS = 1024;
constexpr int TILE_A = 128;             // anchors a column_tiles block
constexpr int TILE_THREADS = 256;
constexpr int SMEM_MAX = 231424;
constexpr int STATIC_SMEM = 12288;      // the kernels' own arrays, rounded up
constexpr float NEG_INF = -__builtin_huge_valf();
typedef unsigned long long u64;

// the walk's window: row, column and whether the score passes
__device__ __forceinline__ void stage(const float* __restrict__ s,
                                      const int64_t* __restrict__ o,
                                      long long base, long long k, int M,
                                      int* er, int* ec, uint8_t* ep, int t0,
                                      int nt, float thresh, int ascend) {
  for (int i = t0; i < WIN; i += nt) {
    const long long e = base + i;
    int r = 0, c = 0;
    uint8_t p = 0;
    if (e < k) {
      const long long idx = o[e];
      r = (int)(idx / M);
      c = (int)(idx - (long long)r * M);
      const float v = s[idx];
      p = ascend ? (v < thresh) : (v > thresh);
    }
    er[i] = r;
    ec[i] = c;
    ep[i] = p;
  }
}

__global__ void __launch_bounds__(WALK_THREADS)
bipartite_walk(const float* __restrict__ scores,
               const int64_t* __restrict__ order, float* row_match,
               float* col_match, int N, int M, long long stride, long long k,
               float thresh, int ascend) {
  extern __shared__ int2 mlist[];       // the matches (row, column),
  __shared__ int er[2][WIN], ec[2][WIN];
  __shared__ uint8_t ep[2][WIN];
  __shared__ int done, n_match;
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31;
  const int rw = (N + 31) / 32, cw = (M + 31) / 32;
  const int most = min(N, M);
  unsigned* bits = (unsigned*)(mlist + most);  // then rows' and columns'
  unsigned* rb = bits;                  // matched bits
  unsigned* cb = bits + rw;
  float* rm = row_match + (size_t)b * N;
  float* cm = col_match + (size_t)b * M;
  for (int i = t; i < rw + cw; i += WALK_THREADS) bits[i] = 0;
  for (int i = t; i < N; i += WALK_THREADS) rm[i] = -1.f;
  for (int i = t; i < M; i += WALK_THREADS) cm[i] = -1.f;
  const float* s = scores + (size_t)b * N * M;
  const int64_t* o = order + (size_t)b * stride;
  stage(s, o, 0, k, M, er[0], ec[0], ep[0], t, WALK_THREADS, thresh,
        ascend);
  if (t == 0) done = n_match = 0;
  __syncthreads();
  int matched = 0;                      // warp 0's count
  for (long long base = 0; base < k; base += WIN) {
    const int w = (int)((base / WIN) & 1);
    if (t < 32) {
      for (int sub = 0; sub < WIN && matched < most; sub += 32) {
        const int e = sub + lane;
        const int r = er[w][e], c = ec[w][e];
        // a lane's entry stays open until a match takes its row or column
        bool open = ep[w][e] && base + e < k
                    && !((rb[r >> 5] >> (r & 31)) & 1u)
                    && !((cb[c >> 5] >> (c & 31)) & 1u);
        int after = -1;                 // lanes up to here are settled
        while (matched < most) {
          const unsigned bal = __ballot_sync(FULL, open && lane > after);
          if (!bal) break;
          const int first = __ffs(bal) - 1;
          const int mr = __shfl_sync(FULL, r, first);
          const int mc = __shfl_sync(FULL, c, first);
          if (lane == first) {
            rb[r >> 5] |= 1u << (r & 31);
            cb[c >> 5] |= 1u << (c & 31);
            mlist[matched] = make_int2(r, c);
          }
          open = open && r != mr && c != mc;
          after = first;
          ++matched;
        }
        __syncwarp();
      }
      if (lane == 0) {
        n_match = matched;
        if (matched >= most) done = 1;
      }
    } else if (base + WIN < k) {
      stage(s, o, base + WIN, k, M, er[w ^ 1], ec[w ^ 1], ep[w ^ 1], t - 32,
            WALK_THREADS - 32, thresh, ascend);
    }
    __syncthreads();
    if (done) break;
  }
  // the matches, written by the block once the walk is done
  for (int i = t; i < n_match; i += WALK_THREADS) {
    const int2 m = mlist[i];
    rm[m.x] = (float)m.y;
    cm[m.y] = (float)m.x;
  }
}

// (va, aa, la) before (vb, ab, lb) in torch.argmax's row-major order of
// an (A, L) matrix: NaN first, then the larger value, then the lower
// anchor, then the lower column
__device__ __forceinline__ bool before(float va, int aa, int la, float vb,
                                       int ab, int lb) {
  const bool na = va != va, nb = vb != vb;
  const bool tie = aa < ab || (aa == ab && la < lb);
  const bool same = na || va == vb;     // with na == nb
  return na != nb ? na : (same ? tie : va > vb);
}

// a float's bits as an unsigned in `before`'s order of values: -0.0 as
// 0.0, NaN above all; and back (a NaN comes back as a NaN)
__device__ __forceinline__ unsigned ordered(float v) {
  if (v != v) return 0xffffffffu;
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// a column that can still match: a best value above 1e-6, or NaN. One at
// or below 1e-6 only falls as its anchors are taken, so it is never
// rescanned: no round can pick it before the rounds stop
__device__ __forceinline__ bool live(float v) { return !(v <= 1e-6f); }

// a column's best free anchor as one key in `before`'s order, largest
// first: the value, then the lower anchor (below 2^24), then the lower
// column (below 64); 0 sorts below every column
__device__ __forceinline__ u64 round_key(float v, int a, int l) {
  return ((u64)ordered(v) << 32) | ((u64)(0xffffffu - (unsigned)a) << 8)
         | (u64)(0xffu - (unsigned)l);
}

// 64 keys sorted descending across a warp, lane l holding elements l and
// l + 32: a bitonic network, the partners 32 apart in the same lane
__device__ __forceinline__ void sort_desc64(u64 (&key)[2], int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      u64 nk[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = lane + 32 * h;
        const u64 p = stride == 32 ? key[h ^ 1]
                                   : __shfl_xor_sync(FULL, key[h], stride);
        const bool lower = (i & stride) == 0, desc = (i & size) == 0;
        nk[h] = lower == desc ? (key[h] > p ? key[h] : p)
                              : (key[h] < p ? key[h] : p);
      }
      key[0] = nk[0];
      key[1] = nk[1];
    }
  }
}

// the best free anchor of column l (value, anchor; -inf and A when none),
// over the whole block; every thread gets it
__device__ void column_best(const float* __restrict__ iou,
                            const unsigned* abits, int A, int L, int l,
                            float* wv, int* wa, float* bv_out, int* ba_out) {
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  float bv = NEG_INF;
  int ba = A;
  // four anchors a thread at a time, their loads independent
  for (int a0 = t; a0 < A; a0 += 4 * ROUND_THREADS) {
    float v[4];
    int aa[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int a = a0 + u * ROUND_THREADS;
      const bool free = a < A && !((abits[a >> 5] >> (a & 31)) & 1u);
      v[u] = free ? iou[(size_t)a * L + l] : NEG_INF;
      aa[u] = free ? a : A;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (before(v[u], aa[u], 0, bv, ba, 0)) {
        bv = v[u];
        ba = aa[u];
      }
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    const float v = __shfl_xor_sync(FULL, bv, d);
    const int a = __shfl_xor_sync(FULL, ba, d);
    if (before(v, a, 0, bv, ba, 0)) {
      bv = v;
      ba = a;
    }
  }
  if (lane == 0) {
    wv[wid] = bv;
    wa[wid] = ba;
  }
  __syncthreads();
  if (wid == 0) {
    bv = wv[lane];
    ba = wa[lane];
#pragma unroll
    for (int d = 16; d; d >>= 1) {
      const float v = __shfl_xor_sync(FULL, bv, d);
      const int a = __shfl_xor_sync(FULL, ba, d);
      if (before(v, a, 0, bv, ba, 0)) {
        bv = v;
        ba = a;
      }
    }
    if (lane == 0) {
      wv[0] = bv;
      wa[0] = ba;
    }
  }
  __syncthreads();
  *bv_out = wv[0];
  *ba_out = wa[0];
  __syncthreads();
}

// the best (value, anchor) of each column over the G groups of threads
// (thread t = g * cols + its column): a tree over the groups in shared
// memory, pv[t] / pa[t] holding the column's best for t < cols after it
__device__ __forceinline__ void group_best(float* pv, int* pa, float bv,
                                           int ba, int t, int g, int cols,
                                           int G) {
  pv[t] = bv;
  pa[t] = ba;
  __syncthreads();
  for (int h = 1; h < G; h *= 2) {
    if (g < G && g % (2 * h) == 0 && g + h < G) {
      const int o = t + h * cols;
      if (before(pv[o], pa[o], 0, pv[t], pa[t], 0)) {
        pv[t] = pv[o];
        pa[t] = pa[o];
      }
    }
    __syncthreads();
  }
}

// each column's best anchor within a tile of TILE_A anchors (a block a
// (tile, matrix)): threads in groups over the columns, the tile's anchors
// dealt round-robin to the groups, the groups' bests reduced in order
__global__ void __launch_bounds__(TILE_THREADS)
column_tiles(const float* __restrict__ ious, float* __restrict__ part_v,
             int* __restrict__ part_a, int A, int L) {
  __shared__ float pv[TILE_THREADS];
  __shared__ int pa[TILE_THREADS];
  const int tile = blockIdx.x, tiles = gridDim.x, b = blockIdx.y;
  const int t = threadIdx.x;
  const float* iou = ious + (size_t)b * A * L;
  const int a0 = tile * TILE_A, a1 = min(A, a0 + TILE_A);
  const int cols = min(L, TILE_THREADS), G = TILE_THREADS / cols;
  for (int l0 = 0; l0 < L; l0 += cols) {
    const int g = t / cols, l = l0 + t % cols;
    float bv = NEG_INF;
    int ba = A;
    if (g < G && l < L) {
#pragma unroll 4
      for (int a = a0 + g; a < a1; a += G) {
        const float v = iou[(size_t)a * L + l];
        if (before(v, a, 0, bv, ba, 0)) {
          bv = v;
          ba = a;
        }
      }
    }
    group_best(pv, pa, bv, ba, t, g, cols, G);
    if (t < cols && l < L) {
      const size_t at = ((size_t)b * tiles + tile) * L + l;
      part_v[at] = pv[t];
      part_a[at] = pa[t];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(ROUND_THREADS)
bipartite_rounds(const float* __restrict__ ious,
                 const float* __restrict__ part_v,
                 const int* __restrict__ part_a, int tiles, uint8_t* matched,
                 int64_t* match_gt, float* match_iou, int A, int L) {
  extern __shared__ unsigned char dyn[];
  int2* mlist = (int2*)dyn;             // the matches (anchor, column)
  float* colv = (float*)(mlist + L);    // each column's best free anchor
  int* cola = (int*)(colv + L);
  int* resc = cola + L;                 // the columns a round rescans
  float* mval = (float*)(resc + L);     // the matches' IoUs
  unsigned* abits = (unsigned*)(mval + L);   // anchors matched
  uint8_t* cused = (uint8_t*)(abits + (A + 31) / 32);  // columns matched
  __shared__ float pv[ROUND_THREADS];
  __shared__ int pa[ROUND_THREADS];
  __shared__ float wv[32];
  __shared__ int wa[32];
  __shared__ int n_resc, n_match;
  const int b = blockIdx.x, t = threadIdx.x, lane = t & 31;
  const float* iou = ious + (size_t)b * A * L;
  uint8_t* mo = matched + (size_t)b * A;
  int64_t* go = match_gt + (size_t)b * A;
  float* io = match_iou + (size_t)b * A;
  for (int a = t; a < A; a += ROUND_THREADS) {
    mo[a] = 0;
    go[a] = -1;
    io[a] = -1.f;
  }
  for (int i = t; i < (A + 31) / 32; i += ROUND_THREADS) abits[i] = 0;
  // each column's best anchor from the tiles' bests: G threads a column
  // (the order does not matter: `before` is a total order)
  const int cols = min(L, ROUND_THREADS), G = ROUND_THREADS / cols;
  for (int l0 = 0; l0 < L; l0 += cols) {
    const int g = t / cols, l = l0 + t % cols;
    float bv = NEG_INF;
    int ba = A;
    if (g < G && l < L)
      for (int tile = g; tile < tiles; tile += G) {
        const size_t at = ((size_t)b * tiles + tile) * L + l;
        const float v = part_v[at];
        const int a = part_a[at];
        if (before(v, a, 0, bv, ba, 0)) {
          bv = v;
          ba = a;
        }
      }
    group_best(pv, pa, bv, ba, t, g, cols, G);
    if (t < cols && l < L) {
      colv[l] = pv[t];
      cola[l] = pa[t];
      cused[l] = 0;
    }
    __syncthreads();
  }
  // the rounds on warp 0; the block joins only for the rescans of the
  // columns whose best anchor a round took
  const int most = min(A, L);
  int matches = 0;                      // warp 0's
  for (;;) {
    if (t < 32 && L <= 64) {
      // many rounds at once: the free columns' keys sorted on the warp
      // (2 a lane); each in turn is the next round's pick until one whose
      // anchor this batch took: that column is rescanned first, and the
      // later ones may fall below its new best
      u64 key[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = lane + 32 * h;
        key[h] = l < L && !cused[l] ? round_key(colv[l], cola[l], l) : 0ull;
      }
      sort_desc64(key, lane);
      // entry e = lane + 32 h is a round while no entry up to it stops
      // (no free column, or not above 1e-6) and no earlier one has its
      // anchor; the batch is the entries before the first that fails
      unsigned an[2];
      bool stop[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = unordered((unsigned)(key[h] >> 32));
        stop[h] = !key[h] || !(v > 1e-6f);
        an[h] = 0xffffffu - (unsigned)((key[h] >> 8) & 0xffffffu);
      }
      bool dup[2] = {false, false};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned same = __match_any_sync(FULL, an[h]);
        dup[h] = (same & ((1u << lane) - 1)) != 0;
      }
      for (int j = 0; j < 32; ++j)      // entry lane + 32 against 0..31
        dup[1] |= __shfl_sync(FULL, an[0], j) == an[1];
      const unsigned f0 = __ballot_sync(FULL, stop[0] || dup[0]);
      const unsigned f1 = __ballot_sync(FULL, stop[1] || dup[1]);
      const int first = f0 ? __ffs(f0) - 1 : 32 + (f1 ? __ffs(f1) - 1 : 32);
      const int len = min(first, most - matches);
      // a batch that ends at a stop ends the rounds: no later one matches
      const bool at_stop =
          first < 64 && __shfl_sync(FULL, (int)(first < 32 ? stop[0] : stop[1]),
                                     first & 31);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = lane + 32 * h;
        if (e < len) {
          const int a = (int)an[h];
          const int l = (int)(0xffu - (unsigned)(key[h] & 0xffu));
          mlist[matches + e] = make_int2(a, l);
          mval[matches + e] = unordered((unsigned)(key[h] >> 32));
          cused[l] = 1;
          atomicOr(&abits[a >> 5], 1u << (a & 31));
        }
      }
      matches += len;
      const int done = at_stop || matches == most;
      __syncwarp();
      // the free columns whose best anchor is now taken
      int n = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = lane + 32 * h, a = l < L ? cola[l] : A;
        const bool hit = l < L && !cused[l] && live(colv[l]) && a < A
                         && ((abits[a >> 5] >> (a & 31)) & 1u);
        const unsigned m = __ballot_sync(FULL, hit);
        if (hit) resc[n + __popc(m & ((1u << lane) - 1))] = l;
        n += __popc(m);
      }
      if (lane == 0) {
        n_resc = done ? -1 : n;
        n_match = matches;
      }
    } else if (t < 32) {
      int n = 0;
      bool done = false;
      while (!done && n == 0) {
        if (matches == most) {
          done = true;
          break;
        }
        float bv = NEG_INF;
        int ba = A, bl = L;
        for (int l = lane; l < L; l += 32)
          if (!cused[l] && before(colv[l], cola[l], l, bv, ba, bl)) {
            bv = colv[l];
            ba = cola[l];
            bl = l;
          }
        // the warp's first in `before`'s order: the largest value, then
        // among those the lowest anchor, then the lowest column
        const unsigned hi = ordered(bv);
        const unsigned mh = __reduce_max_sync(FULL, hi);
        const unsigned lo = hi == mh ? 0xffffffffu - (unsigned)ba : 0u;
        const unsigned ml = __reduce_max_sync(FULL, lo);
        bl = (int)__reduce_min_sync(
            FULL, hi == mh && lo == ml ? (unsigned)bl : 0xffffffffu);
        ba = (int)(0xffffffffu - ml);
        bv = unordered(mh);
        if (!(bv > 1e-6f)) {            // no later round matches either
          done = true;
          break;
        }
        for (int l0 = 0; l0 < L; l0 += 32) {
          const int l = l0 + lane;
          const bool hit = l < L && l != bl && !cused[l] && live(colv[l])
                           && cola[l] == ba;
          const unsigned m = __ballot_sync(FULL, hit);
          if (hit) resc[n + __popc(m & ((1u << lane) - 1))] = l;
          n += __popc(m);
        }
        if (lane == 0) {
          mlist[matches] = make_int2(ba, bl);
          mval[matches] = bv;
          cused[bl] = 1;
          abits[ba >> 5] |= 1u << (ba & 31);
        }
        __syncwarp();
        ++matches;
      }
      if (lane == 0) {
        n_resc = done ? -1 : n;
        n_match = matches;
      }
    }
    __syncthreads();
    const int n = n_resc;
    if (n < 0) break;
    for (int i = 0; i < n; ++i) {
      const int j = resc[i];
      float nv;
      int na;
      column_best(iou, abits, A, L, j, wv, wa, &nv, &na);
      if (t == 0) {
        colv[j] = nv;
        cola[j] = na;
      }
      __syncthreads();
    }
  }
  // the matches, written by the block once the rounds are done
  for (int i = t; i < n_match; i += ROUND_THREADS) {
    const int2 m = mlist[i];
    mo[m.x] = 1;
    go[m.x] = m.y;
    io[m.x] = mval[i];
  }
}

}  // namespace m1

// route: 0 "segments" (a block a segment, per_image blocks an image), 1
// "mask" (n1_mask into the W-word rows of `mask`, then n1_sweep); B
// images, the caller's group
extern "C" int mxtt_nms_segments(const void* boxes, const void* ids,
                                 const void* valid, void* perm, void* sbox,
                                 void* segoff, void* nseg, void* keep,
                                 void* mask, int B, int N, float thresh,
                                 int force, int rank_order, int route,
                                 int per_image, int threads, int smem,
                                 void* stream) {
  const int chunks = (N + n1::TB - 1) / n1::TB;
  const int want_threads = route == 0 ? n1::SEG_THREADS : n1::SWEEP_THREADS;
  const int want_smem = route == 1 ? 16 * chunks : chunks * n1::TB;
  if (B < 1 || B > 65535 || N < 1 || per_image < 1 || per_image > 65535 ||
      route < 0 || route > 1 || (route == 1 && (!force || !mask ||
                                                per_image != 1)) ||
      (route == 1 && chunks > 65535) ||
      (rank_order != 0 && N > n1::RANK_MAX) || threads != want_threads ||
      smem != want_smem || smem + n1::STATIC_SMEM > n1::SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* slow = (int*)nseg + B;           // an image's flag: a non-finite box
  n1::n1_prep<<<B, n1::PREP_THREADS, 0, st>>>(
      (const float4*)boxes, (const float*)ids, (const uint8_t*)valid,
      (int64_t*)perm, (float4*)sbox, (int*)segoff, (int*)nseg, slow,
      (uint8_t*)keep, N, force, rank_order);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float4* sb = (const float4*)sbox;
  const int64_t* pm = (const int64_t*)perm;
  const int* so = (const int*)segoff;
  const int* ns = (const int*)nseg;
  uint8_t* kp = (uint8_t*)keep;
  if (route == 1) {
    n1::n1_mask<<<dim3(chunks, chunks, B), n1::TB, 0, st>>>(
        sb, so, ns, slow, (n1::u64*)mask, N, chunks, thresh);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(n1::n1_sweep,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return (int)e;
    }
    n1::n1_sweep<<<B, n1::SWEEP_THREADS, smem, st>>>(
        (const n1::u64*)mask, pm, so, ns, kp, N, chunks);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(n1::n1_segments,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  n1::n1_segments<<<dim3(per_image, B), n1::SEG_THREADS, smem, st>>>(
      sb, pm, so, ns, slow, kp, N, per_image, thresh);
  return (int)cudaGetLastError();
}

extern "C" int mxtt_bipartite_walk(const void* scores, const void* order,
                                   void* row_match, void* col_match, int B,
                                   int N, int M, long long stride,
                                   long long k, float thresh, int ascend,
                                   int threads, int smem, void* stream) {
  if (B < 1 || N < 1 || M < 1 || k < 0 || k > stride ||
      stride > (long long)N * M || threads != m1::WALK_THREADS ||
      smem != 8 * (N < M ? N : M) + 4 * ((N + 31) / 32 + (M + 31) / 32) ||
      smem + m1::STATIC_SMEM > m1::SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        m1::bipartite_walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  m1::bipartite_walk<<<B, m1::WALK_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)scores, (const int64_t*)order, (float*)row_match,
      (float*)col_match, N, M, stride, k, thresh, ascend);
  return (int)cudaGetLastError();
}

extern "C" int mxtt_bipartite_rounds(const void* iou, void* part,
                                     void* matched, void* match_gt,
                                     void* match_iou, int B, int A, int L,
                                     int threads, int smem, void* stream) {
  if (B < 1 || B > 65535 || A < 1 || L < 1 ||
      threads != m1::ROUND_THREADS ||
      smem != 25 * L + 4 * ((A + 31) / 32) ||
      smem + m1::STATIC_SMEM > m1::SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (A + m1::TILE_A - 1) / m1::TILE_A;
  float* pv = (float*)part;
  int* pa = (int*)part + (size_t)B * tiles * L;
  m1::column_tiles<<<dim3(tiles, B), m1::TILE_THREADS, 0, st>>>(
      (const float*)iou, pv, pa, A, L);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(m1::bipartite_rounds,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  m1::bipartite_rounds<<<B, m1::ROUND_THREADS, smem, st>>>(
      (const float*)iou, pv, pa, tiles, (uint8_t*)matched,
      (int64_t*)match_gt, (float*)match_iou, A, L);
  return (int)cudaGetLastError();
}
