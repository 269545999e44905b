// Nearest-neighbour indices: brute force, and a pruned scan with its
// prepass.
//
// Replaces the TPU kernels kaolin_tpu/kernels/nn_distance.py
// nearest_idx_pallas (brute force) and nearest_idx_pruned (a Morton-sorted
// range scan, whose sort, boxes and bounds the JAX package forms outside
// its Pallas kernel). The Pallas kernels hold the whole reference cloud in
// VMEM (at most 640k points); these read it from device memory and take
// any size.
//
// Distance, ties and NaN, as the plain PyTorch version (nearest_idx_plain)
// and the JAX package's XLA scan: d = p - q, then (dx*dx + dy*dy) + dz*dz,
// compiled with --fmad=false so that no product is fused into a sum. The
// XLA scan takes the references in chunks of CHUNK = 1024 original
// indices, takes a chunk's first minimum only when it is strictly smaller
// than the best so far, and keeps index 0 until it takes one. A chunk's
// minimum is NaN, and the chunk is passed over, when any of its distances
// is NaN: for a finite query exactly when a reference of the chunk has a
// NaN coordinate (an infinite one gives inf); for a query with a
// non-finite coordinate every distance is inf or NaN and nothing is taken
// anyway. So both kernels keep this rule: the first reference of least
// distance, ties to the lowest index, index 0 when none is taken, and no
// reference taken from a chunk (base = 1024 * (j / 1024)) that holds a NaN
// coordinate.
//
// Brute force: nn_brute_kernel, then nn_merge_kernel when the references
// are split. What bounds it on an H100: operations. 9 float operations
// per (query, reference) pair (3 subtractions, 3 products, 2 sums, 1 min),
// 10^10 pairs at config 3's 100k x 100k: 1.34 ms at 67 TFLOP/s, a rate
// that counts a fused multiply-add as two. With --fmad=false nothing
// fuses, so a pair issues 9 instructions, and about 0.5 more for the
// loads and the group's compare below; an SM issues 128 lanes a clock:
// at 1.98 GHz about 2.8 ms at 100k x 100k and 0.028 ms at 10k x 10k, 2.1
// times the bound. The bytes (12 per point in, 4 per query out) are a
// few megabytes. The design:
// - a block takes QB = 384 queries (RQ = 3 a thread, in registers) and a
//   slice of the references, which pass through shared memory a chunk
//   (up to 1024) at a time as float4 records, staged by cp.async while
//   the chunk before is scanned: one 16-byte broadcast load serves 3
//   pairs;
// - a thread folds each group of G = 16 references into one least
//   distance a query with fminf (which drops NaN, as the scan never takes
//   it) and compares it with the query's best once a group, keeping the
//   group's number; after the chunk, for a query whose best moved, it
//   finds the first reference of that group at that distance. So a pair
//   costs 8 operations and a min, and the compare and the index are off
//   its path;
// - the block ORs a NaN flag over the chunk it staged (__syncthreads_or,
//   the chunk's barrier) and skips a flagged chunk;
// - the grid is B * ceil(N1 / QB) query tiles by S slices of L
//   references, planned on the host (brute_plan, kernels/nn_distance.py)
//   from B, N1, N2 and the SM count so that the blocks share the SMs
//   evenly: S = 1 where the tiles do so alone. L is a multiple of 1024, so
//   that a slice holds whole chunks, or a power of two below 1024, so that
//   a chunk is whole slices; such a slice cannot see its chunk's flag and
//   writes a NaN partial instead;
// - with S > 1 every block writes its queries' (distance, index) partials,
//   (B, N1, S), in full; nn_merge_kernel, a warp a query, drops each chunk
//   that holds a NaN partial and takes the least (distance, index) pair of
//   the rest, which is what a strict < over the slices in order takes, in
//   whatever order it reduces. Two launches at most, no host read, no
//   memset, the same bits at every launch.
//
// The pruned scan meets the references in another order, so it keeps the
// smallest (distance, original index) pair, and writes 0 where its best
// distance is still inf (every distance inf or NaN): the same index. It
// keeps the NaN rule through its prepass: nn_codes_kernel flags each
// (batch entry, chunk of 1024 original indices) that holds a NaN
// coordinate (flags that nn_extent_kernel, launched before it, zeroes),
// and nn_pack_kernel writes NaN coordinates into the record of every
// reference of a flagged chunk. Its distance is then NaN for every query,
// and the scan, which takes d <= best only, never takes it.
//
// What bounds the pruned scan: the nearest neighbour of a point lies among
// a handful of references, so its bound is the pairs no box test can rule
// out (chip_smoke.py counts them from the winners). The design, four
// kernels and a sort on one stream:
// 1. nn_extent_kernel: per batch entry, EXT_BLOCKS blocks each reduce the
//    min and max of a stripe of both clouds, and zero the entry's chunk
//    flags.
// 2. nn_codes_kernel: each block reduces the stripes' extents of its batch
//    entry into one box (lo, span) shared by both clouds, as the plain
//    prepass forms it (the entry's first block writes it to `frame` for
//    the scan), and writes each point's 32-bit sort key: the segment
//    (2 b + cloud) in the top bits, below it the Morton code of the point
//    on a 2^m grid of that box (m = 10 for B <= 2). The keys are stored
//    with the top bit flipped, so that their order as signed ints (the
//    order torch.sort gives) is their order as unsigned ones. A reference
//    with a NaN coordinate sets its chunk's flag.
// 3. torch.sort(keys, stable=True), outside this file: one sort of both
//    clouds of every batch entry; each (entry, cloud) is a contiguous run.
// 4. nn_pack_kernel: writes both sorted clouds as float4 records (x, y, z,
//    the original index's bits; x, y, z NaN for a reference of a flagged
//    chunk), the queries padded to tiles of TQ and the references to
//    chunks of CH by repeating the last sorted point with the index
//    PAD_ORIG, and each reference chunk's box (lo, hi), one warp per
//    chunk, with the bits of its first and last sort key in lo.w and hi.w.
// 5. nn_pruned_kernel: one warp per tile of TQ sorted queries (R a lane,
//    kept in registers with their best distances). The warp finds its
//    place among the sorted references (a binary search of the middle
//    query's key) and visits the chunks outward from there, nearest in
//    Morton order first: 0, -1, +1, -2, +2, ... chunks away, so that the
//    best distances shrink early. It takes 32 chunks a step, one a lane:
//    each lane loads its chunk's box and tests it against the warp's query
//    box and the warp's largest best distance (a ballot). The chunks that
//    pass meet the exact test, in order, with their boxes taken from their
//    lanes' registers: skip the chunk when in every lane the squared gap
//    from each of the lane's queries to the box exceeds that query's best
//    (a ballot). The first chunk that passes is staged into shared memory
//    with cp.async; while it arrives and is scanned the next one that
//    passes is found and staged (two buffers a warp), and tested again
//    after that scan. A chunk is scanned in full by every lane, one
//    16-byte broadcast load per reference.
//    The walk ends when no chunk left can hold a winner: whenever its
//    largest best has shrunk, the warp forms the sort keys of the corners
//    L and H of its query box grown by h, the least float with h*h above
//    that best (below), and it skips each chunk whose keys (from its box's
//    w) all lie outside [key(L), key(H)]; when every chunk of a step is
//    skipped so, or lies past the ends, the warp is done.
//
// Why a skip changes nothing. For a query q and a reference r in a box
// [lo, hi], the kernel's gap along x is g = max(fl(lo.x - q.x),
// fl(q.x - hi.x), 0). If lo.x > q.x then r.x - q.x >= lo.x - q.x > 0, and
// rounding to nearest is monotone, so |fl(q.x - r.x)| = fl(r.x - q.x) >= g;
// likewise on the other side, and g = 0 otherwise. Squares of nonnegative
// floats and their sums round monotonically too, so the gap formed as the
// distance is, G = fl(fl(gx*gx + gy*gy) + gz*gz), is at most the computed
// distance of every pair in the box: the rounding margin is zero. The
// scan skips only on G > best, so every skipped pair has a computed
// distance > best and is neither the winner nor tied with it. The same
// holds for the warp's query box in place of q (its gap is at most each
// query's) and its largest best. A NaN gap (NaN inputs) never skips, and
// fmaxf drops a NaN operand, giving 0. The NaN records of flagged chunks
// keep this true: a chunk's box is reduced with fminf and fmaxf, which
// drop NaN, so it bounds the chunk's other records, the only ones that can
// be taken (a chunk of NaN records only has a NaN box, whose gap is 0: it
// is scanned and gives nothing). So the result is the full scan's,
// whatever the visiting order, and two launches give the same bits.
//
// Why the walk's end changes nothing. Let worst, the largest best of the
// warp, be finite (else no chunk is skipped so): then every query of the
// tile is finite, and lies in its box [Ql, Qh]. If a reference r has
// r.x < L.x = next float below fl(Ql.x - h), then exactly q.x - r.x >
// Ql.x - L.x >= h for each query q; rounding is monotone and h a float,
// so |fl(q.x - r.x)| >= h, and the distance, a rounded sum of nonnegative
// terms one of which is fl(dx*dx) >= fl(h*h) > worst, exceeds every best
// of the tile: r is no winner and no tie. Likewise above H and on y and
// z. So a candidate lies in [L, H] on every axis. The quantization that
// forms the sort keys (a subtraction, a division and a product by
// positive constants, a clamp, a truncation) is monotone in each
// coordinate, and so is the Morton code of the cells, so a candidate's
// key lies in [key(L), key(H)]: a chunk with none there holds none. NaN
// and infinite coordinates map to cell 0 and give equal, not inverted,
// keys; a NaN record is never taken. A flagged reference keeps the key of
// its own coordinates: the marking changes no key, no order and no box's
// w, and takes away only references that are no candidates. The
// references sorted, the chunks past c0 have keys at or above the middle
// query's, which is at least key(L), and those before c0 keys below it,
// which is at most key(H): a chunk beyond H on the right, or below L on
// the left, has all the chunks past it so too, and as the bests only
// shrink, [L, H] only shrinks. A step whose chunks are all so skipped is
// therefore the last.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BT = 128;        // brute force: threads per block
constexpr int RQ = 3;          // brute force: queries per thread
constexpr int QB = BT * RQ;    // brute force: queries per block
constexpr int G = 16;          // brute force: references per fold
constexpr int CHUNK = 1024;    // the NaN rule's chunk of references
constexpr int MIN_SLICE = 32;  // brute force: fewest references a slice
constexpr int R = 2;           // pruned: queries per lane
constexpr int TQ = 32 * R;     // pruned: queries per warp tile
constexpr int CH = 32;         // pruned: references per chunk
constexpr int WARPS = 4;       // pruned: warps per scan block
constexpr int EXT_BLOCKS = 64;  // extent blocks per batch entry
constexpr int PAD_ORIG = 0x7fffffff;  // original index of a pad
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = qx - rx, dy = qy - ry, dz = qz - rz;
  return (dx * dx + dy * dy) + dz * dz;
}

// Starts the copy of n references (3n floats at ref) into buf as float4
// records, one float a cp.async, and pads the records to a multiple of G
// with +inf, whose distance is inf or NaN and never taken.
__device__ __forceinline__ void stage_refs(float4* buf, const float* ref,
                                           int n) {
  float* f = reinterpret_cast<float*>(buf);
  for (int e = threadIdx.x; e < 3 * n; e += BT) {
    const int k = e / 3;
    const unsigned s =
        (unsigned)__cvta_generic_to_shared(f + 4 * k + (e - 3 * k));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(ref + e));
  }
  for (int k = n + threadIdx.x; k < (n + G - 1) / G * G; k += BT)
    buf[k] = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
  asm volatile("cp.async.commit_group;\n" ::);
}

// Whether a float this thread copied into buf (n references) is NaN; call
// after its copies have completed.
__device__ __forceinline__ bool staged_nan(const float4* buf, int n) {
  const float* f = reinterpret_cast<const float*>(buf);
  bool nan = false;
  for (int e = threadIdx.x; e < 3 * n; e += BT) {
    const int k = e / 3;
    nan |= isnan(f[4 * k + (e - 3 * k)]);
  }
  return nan;
}

// p1 (B, N1, 3), p2 (B, N2, 3). Block (b * C1 + tile, s) scans references
// [s L, min((s + 1) L, N2)) for queries [tile QB, (tile + 1) QB) of entry
// b. part == nullptr (one slice): idx (B, N1) gets the indices; else part
// (B, N1, S) gets (distance, index bits), NaN where L < CHUNK and the
// slice holds a NaN coordinate.
__global__ void __launch_bounds__(BT)
nn_brute_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                int* __restrict__ idx, float2* __restrict__ part, int N1,
                int N2, int L, int C1) {
  extern __shared__ float4 sbuf[];
  const int K = min(L, CHUNK);
  const int b = blockIdx.x / C1, tile = blockIdx.x % C1, s = blockIdx.y;
  const int s0 = s * L, s1 = min(N2 - s0, L) + s0;
  const float* ref = p2 + (size_t)b * N2 * 3;
  // threads past N1 take the last query and write nothing, so that every
  // thread reaches the barriers
  float qx[RQ], qy[RQ], qz[RQ], best[RQ];
  int bi[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = min(tile * QB + r * BT + (int)threadIdx.x, N1 - 1);
    const float* q = p1 + ((size_t)b * N1 + i) * 3;
    qx[r] = q[0];
    qy[r] = q[1];
    qz[r] = q[2];
    best[r] = INFINITY;
    bi[r] = 0;
  }
  const int T = (s1 - s0 + K - 1) / K;
  bool flagged = false;
  stage_refs(sbuf, ref + (size_t)s0 * 3, min(K, s1 - s0));
  for (int t = 0; t < T; ++t) {
    const int base = s0 + t * K, n = min(K, s1 - base);
    const float4* cur = sbuf + (t & 1) * K;
    asm volatile("cp.async.wait_group 0;\n" ::);
    // the barrier: the chunk is in, and the other buffer is free
    const bool nan = __syncthreads_or(staged_nan(cur, n));
    if (t + 1 < T)
      stage_refs(sbuf + ((t + 1) & 1) * K, ref + (size_t)(base + K) * 3,
                 min(K, s1 - base - K));
    flagged |= nan;
    if (nan) continue;
    int grp[RQ];
#pragma unroll
    for (int r = 0; r < RQ; ++r) grp[r] = -1;
    const int groups = (n + G - 1) / G;
#pragma unroll 2
    for (int k = 0; k < groups; ++k) {
      const float4* gp = cur + k * G;
      float m[RQ];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 p = gp[g];
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          const float d = sq_dist(qx[r], qy[r], qz[r], p.x, p.y, p.z);
          m[r] = g == 0 ? d : fminf(m[r], d);
        }
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        if (m[r] < best[r]) {
          best[r] = m[r];
          grp[r] = k;
        }
      }
    }
    // the first reference of the last group that lowered a best: the
    // group's least distance is that best
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      if (grp[r] >= 0) {
        const float4* gp = cur + grp[r] * G;
        int g = 0;
        while (g < G - 1 && sq_dist(qx[r], qy[r], qz[r], gp[g].x, gp[g].y,
                                    gp[g].z) != best[r])
          ++g;
        bi[r] = base + grp[r] * G + g;
      }
    }
  }
  const int S = gridDim.y;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int i = tile * QB + r * BT + threadIdx.x;
    if (i >= N1) continue;
    const size_t q = (size_t)b * N1 + i;
    if (part == nullptr)
      idx[q] = bi[r];
    else
      part[q * S + s] = flagged && L < CHUNK
                            ? make_float2(NAN, 0.f)
                            : make_float2(best[r], __int_as_float(bi[r]));
  }
}

// part (BN1, S) from nn_brute_kernel, the slices of a chunk in groups of
// GS (1 when a slice holds whole chunks, a power of two up to 32 else);
// idx (BN1): one warp a query.
__global__ void __launch_bounds__(256)
nn_merge_kernel(const float2* __restrict__ part, int* __restrict__ idx,
                long long BN1, int S, int GS) {
  const long long q = ((long long)blockIdx.x * 256 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= BN1) return;  // the whole warp
  float d = INFINITY;
  int id = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const float2 p = s < S ? part[q * S + s] : make_float2(INFINITY, 0.f);
    // a chunk's GS slices are GS aligned lanes: OR their NaN flags
    bool nan = isnan(p.x);
    for (int o = 1; o < GS; o <<= 1)
      nan |= __shfl_xor_sync(FULL, (int)nan, o) != 0;
    const int pi = __float_as_int(p.y);
    if (!nan && (p.x < d || (p.x == d && pi < id))) {
      d = p.x;
      id = pi;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float d2 = __shfl_xor_sync(FULL, d, o);
    const int i2 = __shfl_xor_sync(FULL, id, o);
    if (d2 < d || (d2 == d && i2 < id)) {
      d = d2;
      id = i2;
    }
  }
  if (lane == 0) idx[q] = id;
}

// The key layout for B batch entries: the segment takes the top sbits
// bits (2B segments), the Morton code 3m bits below them.
__device__ __forceinline__ int seg_bits(int B) {
  int s = 1;
  while ((1 << s) < 2 * B) ++s;
  return s;
}

__device__ __forceinline__ unsigned spread3(unsigned v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  return (v | (v << 2)) & 0x09249249u;
}

// the Morton code of (x, y, z) on a 2^m grid of the box (lo, span)
__device__ __forceinline__ unsigned morton(float x, float y, float z,
                                          float4 lo, float4 span, int m) {
  const float scale = (float)(1 << m), top = (float)((1 << m) - 1);
  const float v[3] = {(x - lo.x) / span.x * scale, (y - lo.y) / span.y * scale,
                      (z - lo.z) / span.z * scale};
  unsigned code = 0;
  for (int c = 0; c < 3; ++c)
    code |= spread3((unsigned)(int)fminf(fmaxf(v[c], 0.f), top)) << (2 - c);
  return code;
}

// the bits of a point's code below its segment's, at most 10 an axis
__device__ __forceinline__ int morton_bits(int B) {
  return min(10, (32 - seg_bits(B)) / 3);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// ext (B, EXT_BLOCKS, 6): each block's min xyz and max xyz over its
// stripe of the batch entry's N1 + N2 points; flags (B, NC), NC =
// ceil(N2 / CHUNK): zeroed
__global__ void __launch_bounds__(256)
nn_extent_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                 float* __restrict__ ext, int* __restrict__ flags, int N1,
                 int N2) {
  __shared__ float part[8][6];
  const int b = blockIdx.y;
  const int n = N1 + N2, NC = (N2 + CHUNK - 1) / CHUNK;
  for (int c = blockIdx.x * 256 + threadIdx.x; c < NC; c += EXT_BLOCKS * 256)
    flags[(size_t)b * NC + c] = 0;
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n; i += EXT_BLOCKS * 256) {
    const float* p = i < N1 ? p1 + ((size_t)b * N1 + i) * 3
                            : p2 + ((size_t)b * N2 + (i - N1)) * 3;
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], p[c]);
      hi[c] = fmaxf(hi[c], p[c]);
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = 0; c < 3; ++c) {
    lo[c] = warp_min(lo[c]);
    hi[c] = warp_max(hi[c]);
    if (lane == 0) {
      part[warp][c] = lo[c];
      part[warp][3 + c] = hi[c];
    }
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int c = threadIdx.x;
    float v = part[0][c];
    for (int w = 1; w < 8; ++w)
      v = c < 3 ? fminf(v, part[w][c]) : fmaxf(v, part[w][c]);
    ext[((size_t)b * EXT_BLOCKS + blockIdx.x) * 6 + c] = v;
  }
}

// keys (B, N1 + N2) int32: entry b's queries, then its references;
// frame (B, 2) float4: the box (lo; span), w = 0; flags (B, NC) zeroed,
// set to 1 for each chunk of CHUNK references that holds a NaN coordinate
__global__ void __launch_bounds__(256)
nn_codes_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                const float* __restrict__ ext, int* __restrict__ keys,
                float4* __restrict__ frame, int* __restrict__ flags, int B,
                int N1, int N2) {
  __shared__ float s_lo[4], s_span[4];
  const int b = blockIdx.y;
  if (threadIdx.x < 3) {
    const int c = threadIdx.x;
    const float* e = ext + (size_t)b * EXT_BLOCKS * 6;
    float lo = e[c], hi = e[3 + c];
    for (int g = 1; g < EXT_BLOCKS; ++g) {
      lo = fminf(lo, e[g * 6 + c]);
      hi = fmaxf(hi, e[g * 6 + 3 + c]);
    }
    s_lo[c] = lo;
    s_span[c] = fmaxf(hi - lo, 1e-12f);
  }
  if (threadIdx.x == 3) s_lo[3] = s_span[3] = 0.f;
  __syncthreads();
  const float4 lo = make_float4(s_lo[0], s_lo[1], s_lo[2], s_lo[3]);
  const float4 span = make_float4(s_span[0], s_span[1], s_span[2], s_span[3]);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    frame[2 * b] = lo;
    frame[2 * b + 1] = span;
  }
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= N1 + N2) return;
  const int cloud = i >= N1;
  const float* p = cloud ? p2 + ((size_t)b * N2 + (i - N1)) * 3
                         : p1 + ((size_t)b * N1 + i) * 3;
  const unsigned code = morton(p[0], p[1], p[2], lo, span, morton_bits(B));
  const unsigned u = ((unsigned)(2 * b + cloud) << (32 - seg_bits(B))) | code;
  keys[(size_t)b * (N1 + N2) + i] = (int)(u ^ 0x80000000u);
  // the same value from every writer: no order matters
  if (cloud && (isnan(p[0]) || isnan(p[1]) || isnan(p[2])))
    flags[(size_t)b * ((N2 + CHUNK - 1) / CHUNK) + (i - N1) / CHUNK] = 1;
}

// skeys, order (B * (N1 + N2)) the sorted keys and the sort's order;
// flags (B, NC) from nn_codes_kernel; qrec (B, QP), rrec (B, RP) float4
// records, x, y, z NaN for a reference of a flagged chunk; rbox (B, RP /
// CH, 2) float4 (lo, hi; w the bits of the chunk's first and last key).
// QP and RP are multiples of 32, so a warp lies in one entry and one
// cloud, and in the references one warp is one chunk.
__global__ void __launch_bounds__(256)
nn_pack_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
               const int* __restrict__ skeys,
               const long long* __restrict__ order,
               const int* __restrict__ flags, float4* __restrict__ qrec,
               float4* __restrict__ rrec, float4* __restrict__ rbox, int N1,
               int N2, int QP, int RP, long long total) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const int b = (int)(i / (QP + RP));
  const int r = (int)(i % (QP + RP));
  const bool cloud = r >= QP;
  const int j = cloud ? r - QP : r;
  const int n = cloud ? N2 : N1;
  const long long seg = (long long)b * (N1 + N2);
  const long long at = seg + (cloud ? N1 : 0) + min(j, n - 1);
  const long long src = order[at] - seg;
  const int k = (int)(cloud ? src - N1 : src);
  const float* p = cloud ? p2 + ((size_t)b * N2 + k) * 3
                         : p1 + ((size_t)b * N1 + k) * 3;
  float4 rec =
      make_float4(p[0], p[1], p[2], __int_as_float(j < n ? k : PAD_ORIG));
  if (!cloud) {
    qrec[(size_t)b * QP + j] = rec;
    return;
  }
  if (flags[(size_t)b * ((N2 + CHUNK - 1) / CHUNK) + k / CHUNK])
    rec.x = rec.y = rec.z = __int_as_float(0x7fc00000);  // PyTorch's NaN
  rrec[(size_t)b * RP + j] = rec;
  // a pad repeats the last key, so lane 31 holds the chunk's last
  const int key = skeys[at];
  const float4 lo = make_float4(warp_min(rec.x), warp_min(rec.y),
                                warp_min(rec.z),
                                __int_as_float(__shfl_sync(FULL, key, 0)));
  const float4 hi = make_float4(warp_max(rec.x), warp_max(rec.y),
                                warp_max(rec.z),
                                __int_as_float(__shfl_sync(FULL, key, 31)));
  if ((threadIdx.x & 31) == 0) {
    float4* box = rbox + ((size_t)b * (RP / CH) + j / CH) * 2;
    box[0] = lo;
    box[1] = hi;
  }
}

// the squared gap from [alo, ahi] to [blo, bhi], formed as the distance is
__device__ __forceinline__ float gap2(float alox, float aloy, float aloz,
                                      float ahix, float ahiy, float ahiz,
                                      float4 blo, float4 bhi) {
  const float gx = fmaxf(fmaxf(blo.x - ahix, alox - bhi.x), 0.f);
  const float gy = fmaxf(fmaxf(blo.y - ahiy, aloy - bhi.y), 0.f);
  const float gz = fmaxf(fmaxf(blo.z - ahiz, aloz - bhi.z), 0.f);
  return (gx * gx + gy * gy) + gz * gz;
}

// one lane's record of a chunk into the warp's buffer
__device__ __forceinline__ void stage(float4* dst, const float4* src,
                                      int lane) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst + lane);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src + lane));
  asm volatile("cp.async.commit_group;\n" ::);
}

// The exact test of lane l's chunk, box [blo, bhi] in lane l's registers:
// does any query of any lane lie within its best distance of the box?
__device__ __forceinline__ bool needs(int l, const float4 (&q)[R],
                                      const float (&best)[R], float4 blo,
                                      float4 bhi) {
  const float4 lo4 = make_float4(__shfl_sync(FULL, blo.x, l),
                                 __shfl_sync(FULL, blo.y, l),
                                 __shfl_sync(FULL, blo.z, l), 0.f);
  const float4 hi4 = make_float4(__shfl_sync(FULL, bhi.x, l),
                                 __shfl_sync(FULL, bhi.y, l),
                                 __shfl_sync(FULL, bhi.z, l), 0.f);
  bool need = false;
#pragma unroll
  for (int r = 0; r < R; ++r)
    need |= !(gap2(q[r].x, q[r].y, q[r].z, q[r].x, q[r].y, q[r].z, lo4,
                   hi4) > best[r]);
  return __any_sync(FULL, need);
}

// The first lane of `left`, in order, whose chunk passes the exact test,
// taking the lanes it passes over out of `left`; -1 when none does.
__device__ __forceinline__ int next_needed(unsigned& left,
                                           const float4 (&q)[R],
                                           const float (&best)[R],
                                           float4 blo, float4 bhi) {
  while (left) {
    const int l = __ffs(left) - 1;
    left &= left - 1;
    if (needs(l, q, best, blo, bhi)) return l;
  }
  return -1;
}

// The sort keys [key(L), key(H)] that a reference within reach of the
// query box [l, h] can have, for a largest best `worst` (finite): L and H
// are the box's corners grown by the least float g with g*g > worst, one
// float further out, as keys of entry b's references. Out of line, so
// that the scan's loop keeps its registers.
__device__ __noinline__ int2 key_range(float lx, float ly, float lz,
                                       float hx, float hy, float hz,
                                       float worst,
                                       const float4* __restrict__ frame,
                                       int b, int B) {
  float g = fmaxf(sqrtf(worst), 1e-18f);
  while (!(g * g > worst)) g = nextafterf(g, INFINITY);
  const float4 lo = frame[2 * b], span = frame[2 * b + 1];
  const int m = morton_bits(B);
  const unsigned seg = (unsigned)(2 * b + 1) << (32 - seg_bits(B));
  const unsigned kl = morton(nextafterf(lx - g, -INFINITY),
                             nextafterf(ly - g, -INFINITY),
                             nextafterf(lz - g, -INFINITY), lo, span, m);
  const unsigned kh = morton(nextafterf(hx + g, INFINITY),
                             nextafterf(hy + g, INFINITY),
                             nextafterf(hz + g, INFINITY), lo, span, m);
  return make_int2((int)((seg | kl) ^ 0x80000000u),
                   (int)((seg | kh) ^ 0x80000000u));
}

// skeys (B * (N1 + N2)) the sorted keys; frame from nn_codes_kernel;
// qrec, rrec, rbox from nn_pack_kernel; out (B, N1), written at each
// query's original index; scanned: optional count of the chunks scanned,
// each TQ x CH pairs
__global__ void __launch_bounds__(WARPS * 32)
nn_pruned_kernel(const int* __restrict__ skeys,
                 const float4* __restrict__ frame,
                 const float4* __restrict__ qrec,
                 const float4* __restrict__ rrec,
                 const float4* __restrict__ rbox, int* __restrict__ out,
                 int B, int N1, int N2, int C1, int C2,
                 unsigned long long* __restrict__ scanned) {
  __shared__ float4 buf[WARPS][2][CH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * WARPS + warp;
  if (t >= (long long)B * C1) return;
  const int b = (int)(t / C1), tile = (int)(t % C1);
  const size_t seg = (size_t)b * (N1 + N2);
  const float4* rr = rrec + (size_t)b * C2 * CH;
  const float4* bx = rbox + (size_t)b * C2 * 2;

  float4 q[R];
  float best[R];
  int bo[R];
  float lox = INFINITY, loy = INFINITY, loz = INFINITY;
  float hix = -INFINITY, hiy = -INFINITY, hiz = -INFINITY;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    q[r] = qrec[((size_t)b * C1 + tile) * TQ + r * 32 + lane];
    best[r] = INFINITY;
    bo[r] = PAD_ORIG;
    lox = fminf(lox, q[r].x);
    loy = fminf(loy, q[r].y);
    loz = fminf(loz, q[r].z);
    hix = fmaxf(hix, q[r].x);
    hiy = fmaxf(hiy, q[r].y);
    hiz = fmaxf(hiz, q[r].z);
  }
  lox = warp_min(lox);
  loy = warp_min(loy);
  loz = warp_min(loz);
  hix = warp_max(hix);
  hiy = warp_max(hiy);
  hiz = warp_max(hiz);

  // the first reference at or after the middle query in Morton order
  const int sb = seg_bits(B);
  const int target = (int)((unsigned)skeys[seg + min(tile * TQ + TQ / 2,
                                                       N1 - 1)]
                           + (1u << (32 - sb)));
  const int* rkeys = skeys + seg + N1;
  int lo = 0, hi = N2;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rkeys[mid] < target) lo = mid + 1; else hi = mid;
  }
  const int c0 = min(lo / CH, C2 - 1);
  // steps s = 0, 1, 2, ... visit chunk c0 + 0, -1, +1, -2, +2, ...
  const int steps = max(2 * c0, 2 * (C2 - 1 - c0) + 1);
  unsigned long long count = 0;
  float4(*wb)[CH] = buf[warp];
  // the keys a winner may have, formed for the largest best kworst
  int klo = INT_MIN, khi = INT_MAX;
  float kworst = INFINITY;

  for (int w0 = 0; w0 < steps; w0 += 32) {
    // 32 chunks, one a lane, against the warp's box and largest best
    const int s = w0 + lane;
    const int c = c0 + ((s & 1) ? -((s + 1) >> 1) : (s >> 1));
    float worst = best[0];
#pragma unroll
    for (int r = 1; r < R; ++r) worst = fmaxf(worst, best[r]);
    worst = warp_max(worst);
    if (worst < kworst) {
      const int2 k = key_range(lox, loy, loz, hix, hiy, hiz, worst, frame,
                               b, B);
      klo = k.x;
      khi = k.y;
      kworst = worst;
    }
    float4 blo = make_float4(0.f, 0.f, 0.f, 0.f), bhi = blo;
    bool cand = false, beyond = true;
    if (s < steps && c >= 0 && c < C2) {
      blo = bx[2 * c];
      bhi = bx[2 * c + 1];
      beyond = __float_as_int(blo.w) > khi || __float_as_int(bhi.w) < klo;
      cand = !beyond
             && !(gap2(lox, loy, loz, hix, hiy, hiz, blo, bhi) > worst);
    }
    if (__all_sync(FULL, beyond)) break;
    // the next candidate, in visiting order, that passes the exact test
    // with the best distances as they stand; -1 when none is left
    unsigned left = __ballot_sync(FULL, cand);
    int cur = next_needed(left, q, best, blo, bhi);
    if (cur < 0) continue;
    int slot = 0;
    bool fresh = true;  // cur passed the test with the current distances
    stage(wb[0], rr + (size_t)__shfl_sync(FULL, c, cur) * CH, lane);
    while (cur >= 0) {
      // the next one is found and staged while this one is scanned
      const int nxt = next_needed(left, q, best, blo, bhi);
      if (nxt >= 0) {
        stage(wb[slot ^ 1], rr + (size_t)__shfl_sync(FULL, c, nxt) * CH,
              lane);
      } else {
        asm volatile("cp.async.commit_group;\n" ::);
      }
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncwarp();
      const bool scan = fresh || needs(cur, q, best, blo, bhi);
      if (scan) {
        ++count;
        const float4* t4 = wb[slot];
#pragma unroll
        for (int k = 0; k < CH; ++k) {
          const float4 p = t4[k];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float d = sq_dist(q[r].x, q[r].y, q[r].z, p.x, p.y, p.z);
            if (d <= best[r]) {
              const int o = __float_as_int(p.w);
              if (d < best[r] || o < bo[r]) {
                best[r] = d;
                bo[r] = o;
              }
            }
          }
        }
      }
      __syncwarp();
      // nxt was tested before this scan: test it again if there was one
      fresh = !scan;
      cur = nxt;
      slot ^= 1;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int o = __float_as_int(q[r].w);
    if (o < N1)
      out[(size_t)b * N1 + o] = best[r] < INFINITY && bo[r] < N2 ? bo[r] : 0;
  }
  if (scanned != nullptr && lane == 0) atomicAdd(scanned, count);
}

}  // namespace

extern "C" {

// idx (B, N1) int32, every entry written. The references in S slices of
// L (brute_plan): S = ceil(N2 / L), L a multiple of CHUNK or a power of
// two from MIN_SLICE below it; part (B, N1, S, 2) float scratch, every
// entry written, when S > 1, else null. N2 >= 1.
int nearest_idx_forward(const float* p1, const float* p2, int* idx,
                        float* part, int B, int N1, int N2, int L, int S,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || N1 == 0) return (int)cudaGetLastError();
  const bool slice_ok = L % CHUNK == 0
                        || (L >= MIN_SLICE && L < CHUNK && !(L & (L - 1)));
  const int C1 = (N1 + QB - 1) / QB;
  if (N2 < 1 || N2 > (1 << 30) || L < 1 || !slice_ok
      || S != (N2 + L - 1) / L || S > 65535 || (S > 1) != (part != nullptr)
      || (long long)B * C1 > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  nn_brute_kernel<<<dim3(B * C1, S), BT, 2 * min(L, CHUNK) * sizeof(float4),
                    st>>>(p1, p2, idx, (float2*)part, N1, N2, L, C1);
  if (S > 1) {
    const long long BN1 = (long long)B * N1;
    nn_merge_kernel<<<(unsigned)((BN1 * 32 + 255) / 256), 256, 0, st>>>(
        (const float2*)part, idx, BN1, S, L < CHUNK ? CHUNK / L : 1);
  }
  return (int)cudaGetLastError();
}

// The layout, into out[0..6] (host ints): the pruned scan's queries per
// tile, references per chunk, extent blocks per batch entry and a pad's
// original index; the brute force's queries per block, the NaN rule's
// chunk and the fewest references a slice. The wrapper sizes its buffers
// and plans its slices from these.
int nearest_idx_layout(void* out) {
  int* o = (int*)out;
  o[0] = TQ;
  o[1] = CH;
  o[2] = EXT_BLOCKS;
  o[3] = PAD_ORIG;
  o[4] = QB;
  o[5] = CHUNK;
  o[6] = MIN_SLICE;
  return 0;
}

// Prepass steps 1-2: ext (B, EXT_BLOCKS, 6) float scratch; keys
// (B, N1 + N2) int32, every entry written; frame (B, 2, 4) float, each
// entry's box (lo; span); flags (B, ceil(N2 / CHUNK)) int32, every entry
// written: 1 for a chunk of references with a NaN coordinate. N1, N2 >= 1.
int nearest_idx_keys(const float* p1, const float* p2, float* ext, int* keys,
                     float* frame, int* flags, int B, int N1, int N2,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  if (B > (1 << 29) || N1 < 1 || N2 < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  nn_extent_kernel<<<dim3(EXT_BLOCKS, B), 256, 0, s>>>(p1, p2, ext, flags,
                                                       N1, N2);
  nn_codes_kernel<<<dim3((N1 + N2 + 255) / 256, B), 256, 0, s>>>(
      p1, p2, ext, keys, (float4*)frame, flags, B, N1, N2);
  return (int)cudaGetLastError();
}

// Prepass step 4: skeys (B * (N1 + N2)) int32 and order int64, the
// stable sort of the keys; flags from the keys; qrec (B, C1 * TQ, 4) and
// rrec (B, C2 * CH, 4) float; rbox (B, C2, 2, 4) float, with C1 =
// ceil(N1 / TQ), C2 = ceil(N2 / CH).
int nearest_idx_pack(const float* p1, const float* p2, const int* skeys,
                     const void* order, const int* flags, float* qrec,
                     float* rrec, float* rbox, int B, int N1, int N2,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  const int QP = (N1 + TQ - 1) / TQ * TQ, RP = (N2 + CH - 1) / CH * CH;
  const long long total = (long long)B * (QP + RP);
  nn_pack_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                   (cudaStream_t)stream>>>(
      p1, p2, skeys, (const long long*)order, flags, (float4*)qrec,
      (float4*)rrec, (float4*)rbox, N1, N2, QP, RP, total);
  return (int)cudaGetLastError();
}

// The scan: skeys the sorted keys, frame from the keys, qrec, rrec, rbox
// from the pack; out (B, N1) int32, every entry written once. scanned, if
// not null, a zeroed 64-bit count that gains the chunks scanned (TQ x CH
// pairs each). N1, N2 >= 1.
int nearest_idx_pruned_forward(const int* skeys, const float* frame,
                               const float* qrec, const float* rrec,
                               const float* rbox, int* out, int B, int N1,
                               int N2, void* scanned, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  if (N1 < 1 || N2 < 1) return (int)cudaErrorInvalidValue;
  const int C1 = (N1 + TQ - 1) / TQ, C2 = (N2 + CH - 1) / CH;
  const long long warps = (long long)B * C1;
  nn_pruned_kernel<<<(unsigned)((warps + WARPS - 1) / WARPS), WARPS * 32, 0,
                     (cudaStream_t)stream>>>(
      skeys, (const float4*)frame, (const float4*)qrec, (const float4*)rrec,
      (const float4*)rbox, out, B, N1, N2, C1, C2,
      (unsigned long long*)scanned);
  return (int)cudaGetLastError();
}

}  // extern "C"
