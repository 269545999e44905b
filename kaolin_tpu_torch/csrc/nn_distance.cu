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
// Distance and ties, as the plain PyTorch version (nearest_idx_plain) and
// the JAX package's XLA scan: d = p - q, then (dx*dx + dy*dy) + dz*dz,
// compiled with --fmad=false so that no product is fused into a sum.
// Brute force scans the references in index order and takes a distance
// only when it is strictly smaller, so ties keep the lowest index, and the
// index is 0 until a distance is taken (every distance inf or NaN). The
// pruned scan sees the references in another order, so it keeps the
// smallest (distance, original index) pair, and writes 0 where its best
// distance is still inf (every distance inf or NaN): the same index.
//
// What bounds it on an H100: operations. 9 float operations per (query,
// reference) pair (3 subtractions, 3 products, 2 sums, 1 compare), 10^10
// pairs at config 3's 100k x 100k by brute force: 1.34 ms at 67 TFLOP/s;
// the bytes (12 per point in, 4 per query out) are a few megabytes. The
// nearest neighbour of a point lies among a handful of references, so the
// pruned scan's bound is the pairs no box test can rule out (chip_smoke.py
// counts them from the winners).
//
// The pruned design, four kernels and a sort on one stream:
// 1. nn_extent_kernel: per batch entry, EXT_BLOCKS blocks each reduce the
//    min and max of a stripe of both clouds.
// 2. nn_codes_kernel: each block reduces the stripes' extents of its batch
//    entry into one box (lo, span) shared by both clouds, as the plain
//    prepass forms it (the entry's first block writes it to `frame` for
//    the scan), and writes each point's 32-bit sort key: the segment
//    (2 b + cloud) in the top bits, below it the Morton code of the point
//    on a 2^m grid of that box (m = 10 for B <= 2). The keys are stored
//    with the top bit flipped, so that their order as signed ints (the
//    order torch.sort gives) is their order as unsigned ones.
// 3. torch.sort(keys, stable=True), outside this file: one sort of both
//    clouds of every batch entry; each (entry, cloud) is a contiguous run.
// 4. nn_pack_kernel: writes both sorted clouds as float4 records (x, y, z,
//    the original index's bits), the queries padded to tiles of TQ and the
//    references to chunks of CH by repeating the last sorted point with
//    the index PAD_ORIG, and each reference chunk's box (lo, hi), one warp
//    per chunk, with the bits of its first and last sort key in lo.w and
//    hi.w.
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
// fmaxf drops a NaN operand, giving 0. So the result is the full scan's,
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
// keys; a NaN reference is never taken. The references sorted, the chunks
// past c0 have keys at or above the middle query's, which is at least
// key(L), and those before c0 keys below it, which is at most key(H): a
// chunk beyond H on the right, or below L on the left, has all the chunks
// past it so too, and as the bests only shrink, [L, H] only shrinks. A
// step whose chunks are all so skipped is therefore the last.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // brute force: queries per block
constexpr int CHUNK = 1024;    // brute force: references staged per pass
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

// p1 (B, N1, 3), p2 (B, N2, 3); idx (B, N1)
__global__ void __launch_bounds__(THREADS)
nn_brute_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                int* __restrict__ idx, int N1, int N2) {
  __shared__ float sx[CHUNK], sy[CHUNK], sz[CHUNK];
  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  // threads past N1 load the last query and write nothing, so that every
  // thread reaches the barriers
  const float* q = p1 + ((size_t)b * N1 + min(i, N1 - 1)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float* ref = p2 + (size_t)b * N2 * 3;
  float best = INFINITY;
  int best_i = 0;
  for (int base = 0; base < N2; base += CHUNK) {
    const int n = min(CHUNK, N2 - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += THREADS) {
      const float* r = ref + (size_t)(base + k) * 3;
      sx[k] = r[0];
      sy[k] = r[1];
      sz[k] = r[2];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float d = sq_dist(qx, qy, qz, sx[k], sy[k], sz[k]);
      if (d < best) {
        best = d;
        best_i = base + k;
      }
    }
  }
  if (i < N1) idx[(size_t)b * N1 + i] = best_i;
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
// stripe of the batch entry's N1 + N2 points
__global__ void __launch_bounds__(256)
nn_extent_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                 float* __restrict__ ext, int N1, int N2) {
  __shared__ float part[8][6];
  const int b = blockIdx.y;
  const int n = N1 + N2;
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
// frame (B, 2) float4: the box (lo; span), w = 0
__global__ void __launch_bounds__(256)
nn_codes_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                const float* __restrict__ ext, int* __restrict__ keys,
                float4* __restrict__ frame, int B, int N1, int N2) {
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
}

// skeys, order (B * (N1 + N2)) the sorted keys and the sort's order;
// qrec (B, QP), rrec (B, RP) float4 records; rbox (B, RP / CH, 2) float4
// (lo, hi; w the bits of the chunk's first and last key). QP and RP are
// multiples of 32, so a warp lies in one entry and one cloud, and in the
// references one warp is one chunk.
__global__ void __launch_bounds__(256)
nn_pack_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
               const int* __restrict__ skeys,
               const long long* __restrict__ order, float4* __restrict__ qrec,
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
  const float4 rec =
      make_float4(p[0], p[1], p[2], __int_as_float(j < n ? k : PAD_ORIG));
  if (!cloud) {
    qrec[(size_t)b * QP + j] = rec;
    return;
  }
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

// idx (B, N1) int32, every entry written.
int nearest_idx_forward(const float* p1, const float* p2, int* idx, int B,
                        int N1, int N2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || N1 == 0) return (int)cudaGetLastError();
  const dim3 grid((N1 + THREADS - 1) / THREADS, B);
  nn_brute_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p1, p2, idx, N1,
                                                              N2);
  return (int)cudaGetLastError();
}

// The pruned scan's layout, into out[0..3] (host ints): queries per tile,
// references per chunk, extent blocks per batch entry, a pad's original
// index. The wrapper sizes its buffers from these.
int nearest_idx_layout(void* out) {
  int* o = (int*)out;
  o[0] = TQ;
  o[1] = CH;
  o[2] = EXT_BLOCKS;
  o[3] = PAD_ORIG;
  return 0;
}

// Prepass steps 1-2: ext (B, EXT_BLOCKS, 6) float scratch; keys
// (B, N1 + N2) int32, every entry written; frame (B, 2, 4) float, each
// entry's box (lo; span). N1, N2 >= 1.
int nearest_idx_keys(const float* p1, const float* p2, float* ext, int* keys,
                     float* frame, int B, int N1, int N2, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  if (B > (1 << 29) || N1 < 1 || N2 < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  nn_extent_kernel<<<dim3(EXT_BLOCKS, B), 256, 0, s>>>(p1, p2, ext, N1, N2);
  nn_codes_kernel<<<dim3((N1 + N2 + 255) / 256, B), 256, 0, s>>>(
      p1, p2, ext, keys, (float4*)frame, B, N1, N2);
  return (int)cudaGetLastError();
}

// Prepass step 4: skeys (B * (N1 + N2)) int32 and order int64, the
// stable sort of the keys; qrec (B, C1 * TQ, 4) and rrec (B, C2 * CH, 4)
// float; rbox (B, C2, 2, 4) float, with C1 = ceil(N1 / TQ), C2 =
// ceil(N2 / CH).
int nearest_idx_pack(const float* p1, const float* p2, const int* skeys,
                     const void* order, float* qrec, float* rrec, float* rbox,
                     int B, int N1, int N2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  const int QP = (N1 + TQ - 1) / TQ * TQ, RP = (N2 + CH - 1) / CH * CH;
  const long long total = (long long)B * (QP + RP);
  nn_pack_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                   (cudaStream_t)stream>>>(
      p1, p2, skeys, (const long long*)order, (float4*)qrec, (float4*)rrec,
      (float4*)rbox, N1, N2, QP, RP, total);
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
