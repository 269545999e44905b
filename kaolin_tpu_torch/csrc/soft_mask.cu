// DIB-R soft silhouette mask, forward and backward.
//
// Replaces two TPU kernels of kaolin_tpu/kernels/soft_mask.py:
//   soft_mask_forward_pallas   (entry point soft_mask_forward)
//   soft_mask_backward_pallas  (entry point soft_mask_backward)
//
// Forward, one thread per pixel. A covered pixel (face index >= 0) gets 1.
// An uncovered pixel walks the faces in ORIGINAL order, records the first
// knum whose boxlen-enlarged bbox contains it, and gets
// 1 - prod(1 - exp(-sigmainv * d^2 / m^2)) over them, with d^2 the least of
// the squared distances to the face's 3 edges (where the foot of the
// perpendicular falls inside the edge) and 3 vertices. This is the
// order-exact semantics of the JAX package's XLA path
// (kaolin_tpu/render/mesh/dibr.py _soft_mask_forward, _min6), not the
// Pallas kernel's spatially sorted order with its per-segment count reset.
//
// Backward. The gradient to a face's 6 coordinates is a sum over the pixels
// that recorded the face, and blocks run in no order; a face-major pass
// takes the place of atomics, so every launch gives the same bits. The
// per-pair terms are the JAX package's XLA backward's (dibr.py
// _dibr_soft_mask_bwd): dLdz = -sigmainv * dLdp * (1 - mask) /
// (1 - p + 1e-7) * p, times the derivative of the least distance (first
// of the 6 on ties), by vertex or by edge. The Pallas kernel's moment form
// is not carried over.
//   When a gradient is needed, the forward also writes, per uncovered
//   pixel, the id of its knum-th recorded face, or F where it recorded
//   fewer; -1 for covered pixels (the cut). So face f was recorded at
//   pixel p iff its enlarged bbox holds p and f <= cut[p].
//
// What bounds it on an H100: a few bytes per pixel and a few dozen per
// face, so the work is the (pixel, face) pairs, here about a hundred float
// operations and one exp per recorded pair (twice that in the backward).
// The forward walks, a block a 16x16 tile, the tile's own list of faces
// (tile_lists.cuh: the faces whose enlarged bbox overlaps the tile's
// pixel-centre rectangle, a bit a face in slots of CHUNK ids) in id order,
// so the first-knum rule is exact, staged 256 faces at a time with the
// tile's pixels in each one's bbox (tile_mask); a tile with no uncovered
// pixel stages nothing, and a block stops once none of its pixels can
// record more. A warp takes 32 staged faces at a time: 17 ballots turn the
// faces' pixel bits into each pixel's 32-face mask, cut to the first
// knum - recorded; the recorded pairs join a queue, computed 32 at a time,
// one a lane, and each pixel multiplies its factors in in id order. So the
// ~300 instructions of a pair (9 IEEE divisions, an exp) run in full warps.
//   The backward's pairs lie on the few uncovered pixels near the
// silhouette (at config 2, 93,032 of 2,097,152 pixels), but every face's
// enlarged bbox spans about 400 pixels. So it walks bits, not pixels:
// - soft_mask_live_kernel writes the live bitmap, one bit a pixel (32 a
//   word along the row): uncovered (cut >= 0) and a nonzero cotangent;
// - soft_mask_bwd_kernel takes a face a warp at a time. The warp reads the
//   words of its pixel rectangle (the enlarged bbox's, padded by one
//   pixel, clipped to the slab and trimmed by the forward's float test),
//   one row segment of 32 columns a lane, masked to the rectangle's
//   columns; a scan of their bit counts numbers the live pixels in it, the
//   candidates. Lane j takes candidate j (the segment by a search over the
//   scan, the column by the bit's rank) and loads its cut, cotangent and
//   mask; a candidate inside the float bbox and at or under its cut is a
//   recorded pair. The pairs are listed in shared memory and taken 32 at a
//   time, one a lane, so that the ~300 instructions of a pair (16 IEEE
//   divisions, an exp) run in full warps, the nearest vertex's or edge's
//   derivative taken by selects so that the lanes run one path. A face
//   with no live pixel in its rectangle (at config 2, 71% of them) costs a
//   load a lane and writes zeros. A face whose rectangle spans more than
//   BIG_SEGS row segments is queued for the whole block: after every warp
//   is done, the block takes its queues in order, the warps the segment
//   steps in turn, and adds the warps' sums in warp order (a warp whose
//   queue of BIG_QUEUE is full takes the face alone). With PERSIST or more
//   faces a warp the grid is persistent (as many blocks as the card holds,
//   each warp taking faces warp, warp + the grid's warps, ..., the next
//   face's bbox loaded while it works on one); with fewer, a warp a face.
// Lanes sum in registers and fixed shuffle trees add them.

// Arithmetic follows the plain PyTorch version operation for operation
// (--fmad=false, IEEE division). expf may differ from PyTorch's exp on the
// CPU by an ulp or two; the plain version on the card calls the same
// expf. The backward's per-face sums run in another order than the plain
// version's.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "tile_lists.cuh"

namespace {

constexpr int THREADS = TILE * TILE;
constexpr int BWD_WARPS = 8;                // faces per backward block
constexpr int PAIRS = 64;                   // listed pairs a warp holds
constexpr int BWD_BLOCKS = 3;               // blocks an SM holds: <= 85 regs
// a face whose rectangle spans more row segments (32 columns of a row)
// waits for all the block's warps, up to BIG_QUEUE a warp
constexpr int BIG_SEGS = 4 * 32;
constexpr int BIG_QUEUE = 32;
constexpr int PERSIST = 8;                  // faces a warp: persistent grid
constexpr unsigned FULL = 0xffffffffu;
constexpr float EPS = 1e-7f;                // dibr.py _EPS

struct Params {
  const float* img;        // (B, F, 6) scaled image verts
  const float* bbox;       // (B, F, 4) scaled bbox, enlarged by boxlen*m
  const int32_t* face_idx; // (B, H, W) forward only
  const float* mask;       // (B, H, W) backward: the forward's mask
  const float* grad;       // (B, H, W) backward: cotangent of the mask
  int32_t* cut;            // (B, H, W) forward: out, or null; backward: in
  float* out;              // forward: mask; backward: (B, F, 6) gradient
  int B, F, H, W, row_start, total_height, knum;  // knum: forward only
  float sx, sy, sigmainv, multiplier, bad;
};

// Least squared distance from (px, py) to a face, as dibr.py _min6, and
// which of the 6 it is (0-2 the edges, 3-5 the vertices; first on ties).
__device__ __forceinline__ float min6(float px, float py, const float* v,
                                      float bad, int* which) {
  float dmin = INFINITY;
  int id = 0;
  for (int i = 0; i < 3; ++i) {
    const int j = (i + 1) % 3;
    const float x1 = v[2 * i], y1 = v[2 * i + 1];
    const float x2 = v[2 * j], y2 = v[2 * j + 1];
    const float A = y2 - y1;
    const float B = x1 - x2;
    const float C = x2 * y1 - x1 * y2;
    const float up = A * px + B * py + C;
    const float down = A * A + B * B;
    const float x3 = (B * B * px - A * B * py - A * C) / (down + EPS);
    const float y3 = (A * A * py - A * B * px - B * C) / (down + EPS);
    const float direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2);
    const float perp = up * up / (down + EPS);
    const float d = direct > 0.f ? bad : perp;
    if (d < dmin) { dmin = d; id = i; }
  }
  for (int i = 0; i < 3; ++i) {
    const float dx = px - v[2 * i], dy = py - v[2 * i + 1];
    const float d = dx * dx + dy * dy;
    if (d < dmin) { dmin = d; id = 3 + i; }
  }
  *which = id;
  return dmin;
}

// Faces staged for the block, in id order: the pixels of the tile in each
// one's enlarged bbox (tile_mask), its verts and id; the tile's pixel
// centres.
struct Staged {
  unsigned mask[THREADS];
  float img[THREADS][6];
  int id[THREADS];
  float x[TILE], y[TILE];
};

// The pixel of this thread.
struct Pixel {
  int b, col, hy;
  bool active;
  size_t pix;
  float px, py;
};

__device__ Pixel block_pixel(const Params& p) {
  Pixel q;
  q.b = blockIdx.z;
  q.col = blockIdx.x * TILE + threadIdx.x;
  q.hy = blockIdx.y * TILE + threadIdx.y;
  q.active = q.col < p.W && q.hy < p.H;
  q.pix = ((size_t)q.b * p.H + q.hy) * p.W + q.col;
  q.px = pixel_x(p.sx, q.col, p.W);
  q.py = pixel_y(p.sy, p.row_start + q.hy, p.total_height);
  return q;
}

__device__ __forceinline__ bool in_bbox(float px, float py, const float* bb) {
  return px >= bb[0] && px < bb[2] && py >= bb[1] && py < bb[3];
}

// Position of the n-th (from 0) set bit of m.
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (n >= c) {
      n -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// A warp's queue of (pixel, face) pairs waiting for a full round: lane j
// holds entry j < n (the lane of its pixel, the stage index of its face).
struct Pending {
  int owner, k, n;
};

// Appends the warp's pairs of one batch of faces (k0 + the set bits of each
// lane's mask; by lane, then face) to the queue, and runs every full round
// of 32, entry j on lane j (round(owner, k, 32)); the rest wait in pend,
// for a later batch or round(pend.owner, pend.k, pend.n). A pixel's pairs
// keep their order. Every lane of the warp calls it.
template <typename Round>
__device__ __forceinline__ void queue_pairs(unsigned mask, int k0, int lane,
                                            Pending& pend, Round round) {
  const int cnt = __popc(mask);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  const int all = pend.n + __shfl_sync(FULL, incl, 31);
  // entry c: the pending ones, then the batch's
  auto entry = [&](int c, int* owner, int* k) {
    const int po = __shfl_sync(FULL, pend.owner, c & 31);
    const int pk = __shfl_sync(FULL, pend.k, c & 31);
    const int t = c - pend.n;
    int at = 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int v = __shfl_sync(FULL, incl, at + o - 1);
      if (v <= t) at += o;
    }
    const unsigned m = __shfl_sync(FULL, mask, at);
    const int before = __shfl_sync(FULL, incl - cnt, at);
    *owner = c < pend.n ? po : at;
    *k = c < pend.n ? pk : k0 + nth_bit(m, t - before);
  };
  int c0 = 0;
  for (; c0 + 32 <= all; c0 += 32) {
    int owner, k;
    entry(c0 + lane, &owner, &k);
    round(owner, k, 32);
  }
  int owner = 0, k = 0;
  if (c0 < all) entry(c0 + lane, &owner, &k);
  pend = Pending{owner, k, all - c0};
}

// Sum over the warp's lanes, in a fixed order; lane 0 holds it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

// One round of pairs, one a lane (the first n valid): each lane computes
// its pair's factor 1 - p, then each pixel multiplies in its own factors in
// the round's order.
__device__ __forceinline__ void pair_round(const Params& p, const Staged& s,
                                           const Pixel& q, int owner, int k,
                                           int n, int lane, float& prod) {
  const float px = __shfl_sync(FULL, q.px, owner);
  const float py = __shfl_sync(FULL, q.py, owner);
  float factor = 1.f;
  if (lane < n) {
    int which;
    const float d2 = min6(px, py, s.img[k], p.bad, &which);
    const float z = p.sigmainv * d2 / p.multiplier / p.multiplier;
    factor = 1.f - expf(-z);
  }
  for (int u = 0; u < n; ++u) {
    const int o = __shfl_sync(FULL, owner, u);
    const float v = __shfl_sync(FULL, factor, u);
    if (lane == o) prod = prod * v;
  }
}

// Records one batch of up to 32 staged faces (k0 ..) for the warp's pixels:
// each lane marks the faces its pixel records (inside the enlarged bbox,
// knum in all), and the pairs join the warp's queue (queue_pairs), whose
// full rounds are computed a pair a lane (pair_round). A pixel's pairs keep
// their id order, so its product is the sequential one. Every lane of the
// warp calls it.
__device__ __forceinline__ void record_batch(const Params& p, const Pixel& q,
                                             const Staged& s, int k0,
                                             int count, bool open, int lane,
                                             int& recorded, int& cut,
                                             float& prod, Pending& pend) {
  // the batch's faces over this pixel: lane k holds face k0 + k's
  // tile_mask, and a ballot a column and one for this pixel's row turn the
  // faces' pixels into the pixels' faces
  const unsigned fm = k0 + lane < count ? s.mask[k0 + lane] : 0u;
  unsigned cols = 0u;
#pragma unroll
  for (int c = 0; c < TILE; ++c) {
    const unsigned v = __ballot_sync(FULL, (fm >> c) & 1u);
    if (c == (int)threadIdx.x) cols = v;
  }
  const int r0 = threadIdx.y & ~1;          // the warp's two rows
  const unsigned row0 = __ballot_sync(FULL, (fm >> (TILE + r0)) & 1u);
  const unsigned row1 = __ballot_sync(FULL, (fm >> (TILE + r0 + 1)) & 1u);
  unsigned mask = 0u;
  if (open) {
    mask = cols & (threadIdx.y & 1 ? row1 : row0);
    const int room = p.knum - recorded;
    if (__popc(mask) > room) mask &= (2u << nth_bit(mask, room - 1)) - 1u;
  }
  const int cnt = __popc(mask);
  if (cnt > 0) {
    recorded += cnt;
    if (recorded == p.knum) cut = s.id[k0 + 31 - __clz(mask)];
  }
  queue_pairs(mask, k0, lane, pend, [&](int owner, int k, int n) {
    pair_round(p, s, q, owner, k, n, lane, prod);
  });
}

// Walks the tile's own list in id order (walk_tile), THREADS faces staged
// at a time and recorded 32 at a time (record_batch); stops once none of
// the block's pixels can record more, and walks nothing where none can
// record any.
__global__ void __launch_bounds__(THREADS)
soft_mask_kernel(Params p, const uint32_t* words, int chunks) {
  __shared__ Staged s;
  __shared__ WalkLists lists;
  const Pixel q = block_pixel(p);
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int lane = tid & 31;
  const bool uncovered = q.active && p.face_idx[q.pix] < 0;
  int recorded = 0, cut = p.F;
  float prod = 1.f;
  if (tid < TILE) s.x[tid] = pixel_x(p.sx, blockIdx.x * TILE + tid, p.W);
  else if (tid < 2 * TILE)
    s.y[tid - TILE] = pixel_y(p.sy, p.row_start + blockIdx.y * TILE + tid -
                                        TILE, p.total_height);

  if (__syncthreads_or(uncovered && p.knum > 0)) {
    walk_tile(words, chunks, lists, [&](int n) {
      for (int s0 = 0; s0 < n; s0 += THREADS) {
        // also the barrier before the stage is overwritten
        if (!__syncthreads_or(uncovered && recorded < p.knum)) return false;
        const int count = min(THREADS, n - s0);
        if (tid < count) {
          const int f = lists.order[s0 + tid];
          const size_t face = (size_t)q.b * p.F + f;
          s.mask[tid] = tile_mask(p.bbox + face * 4, s.x, s.y);
          for (int j = 0; j < 6; ++j) s.img[tid][j] = p.img[face * 6 + j];
          s.id[tid] = f;
        }
        __syncthreads();
        Pending pend{0, 0, 0};
        for (int k0 = 0; k0 < count; k0 += 32) {
          const bool open = uncovered && recorded < p.knum;
          if (!__any_sync(FULL, open)) break;
          record_batch(p, q, s, k0, count, open, lane, recorded, cut, prod,
                       pend);
        }
        // the stage is overwritten next: the last pairs now
        pair_round(p, s, q, pend.owner, pend.k, pend.n, lane, prod);
      }
      __syncthreads();
      return true;
    });
  }

  if (q.active) {
    p.out[q.pix] = uncovered ? 1.f - prod : 1.f;
    if (p.cut) p.cut[q.pix] = uncovered && p.knum > 0 ? cut : -1;
  }
}

// Indices i whose centre s * (2i + 1 - n) can lie in [v0, v1), padded by
// one on each side; unclipped. rs = 1 / s: the padding covers its
// rounding, and the caller trims by the exact test.
__device__ __forceinline__ void centre_span(float v0, float v1, float rs,
                                            int n, float* lo, float* hi) {
  *lo = floorf((v0 * rs + (float)(n - 1)) * 0.5f) - 1.f;
  *hi = ceilf((v1 * rs + (float)(n - 1)) * 0.5f) + 1.f;
}

__device__ __forceinline__ int clamp_index(float v, int lo, int hi) {
  return (int)fminf(fmaxf(v, (float)lo), (float)hi);
}

// The live bitmap: bit c of word (row, q) is set where pixel (row, 32q + c)
// is uncovered (cut >= 0) and its cotangent is nonzero. One warp a word.
__global__ void __launch_bounds__(BWD_WARPS * 32)
soft_mask_live_kernel(const int32_t* cut, const float* grad, uint32_t* live,
                      int rows, int W, int W32) {
  const int lane = threadIdx.x & 31;
  const int word = blockIdx.x * BWD_WARPS + (threadIdx.x >> 5);
  if (word >= rows * W32) return;          // the whole warp leaves together
  const int row = word / W32, col = (word - row * W32) * 32 + lane;
  bool bit = false;
  if (col < W) {
    const size_t pix = (size_t)row * W + col;
    bit = cut[pix] >= 0 && grad[pix] != 0.f;
  }
  const unsigned m = __ballot_sync(FULL, bit);
  if (lane == 0) live[word] = m;
}

// A face of the backward: its enlarged bbox and verts, and the rows and
// 32-column words of its pixel rectangle.
struct Face {
  int b, f;
  float v[6], bb[4];
  int r0, nr, c0, c1, q0, nq;
};

__device__ __forceinline__ void load_bbox(const Params& p, int face,
                                          float* bb) {
  for (int j = 0; j < 4; ++j) bb[j] = p.bbox[(size_t)face * 4 + j];
}

// The face's verts and pixel rectangle, from its bbox: the columns and
// rows whose centres can lie in the bbox (centre_span, padded by one,
// clipped to the slab), then trimmed by the forward's own float test, at
// most two a side (the centres are monotone in the index, so the pixels
// that pass are one span).
__device__ __forceinline__ void load_face(const Params& p, int face,
                                          const float* bb, Face& s) {
  s.b = face / p.F;
  s.f = face - s.b * p.F;
  for (int j = 0; j < 4; ++j) s.bb[j] = bb[j];
  for (int j = 0; j < 6; ++j) s.v[j] = p.img[(size_t)face * 6 + j];
  float lo, hi;
  centre_span(s.bb[0], s.bb[2], 1.f / p.sx, p.W, &lo, &hi);
  int c0 = clamp_index(lo, 0, p.W), c1 = clamp_index(hi, -1, p.W - 1);
  centre_span(-s.bb[3], -s.bb[1], 1.f / p.sy, p.total_height, &lo, &hi);
  int r0 = clamp_index(lo - (float)p.row_start, 0, p.H);
  int r1 = clamp_index(hi - (float)p.row_start, -1, p.H - 1);
  for (int i = 0; i < 2; ++i) {
    if (c0 <= c1 && !(pixel_x(p.sx, c0, p.W) >= s.bb[0])) ++c0;
    if (c0 <= c1 && !(pixel_x(p.sx, c1, p.W) < s.bb[2])) --c1;
    // rows count down in y
    if (r0 <= r1 && !(pixel_y(p.sy, p.row_start + r0, p.total_height) <
                      s.bb[3]))
      ++r0;
    if (r0 <= r1 && !(pixel_y(p.sy, p.row_start + r1, p.total_height) >=
                      s.bb[1]))
      --r1;
  }
  const bool empty = c1 < c0 || r1 < r0;
  s.c0 = c0;
  s.c1 = c1;
  s.r0 = r0;
  s.nr = empty ? 0 : r1 - r0 + 1;
  s.q0 = c0 >> 5;
  s.nq = empty ? 0 : (c1 >> 5) - s.q0 + 1;
}

// The word of row segment k of the face's rectangle, masked to its
// columns; its row and word index in *hy, *q.
__device__ __forceinline__ unsigned segment(const Params& p,
                                           const uint32_t* live, int W32,
                                           const Face& s, int k, int* hy,
                                           int* q) {
  const int rr = k / s.nq;
  *hy = s.r0 + rr;
  *q = s.q0 + k - rr * s.nq;
  unsigned m = live[((size_t)s.b * p.H + *hy) * W32 + *q];
  const int lo = s.c0 - 32 * *q, hi = s.c1 - 32 * *q;
  if (lo > 0) m &= ~0u << lo;
  if (hi < 31) m &= (2u << hi) - 1u;
  return m;
}

// Listed pairs of a warp: the pixel (row << 16 | column), its cotangent and
// its mask.
struct PairList {
  int pix[PAIRS];
  float g[PAIRS], m[PAIRS];
};

// Adds one recorded pair's terms (dibr.py _dibr_soft_mask_bwd) to acc:
// the derivative of the nearest vertex or edge, taken by selects, so the
// lanes of a warp run one path whichever they need.
__device__ __forceinline__ void add_pair(const Params& p, const Face& s,
                                         int hy, int col, float g,
                                         float mask, float* acc) {
  const float* v = s.v;
  const float px = pixel_x(p.sx, col, p.W);
  const float py = pixel_y(p.sy, p.row_start + hy, p.total_height);
  int which;
  const float d2 = min6(px, py, v, p.bad, &which);
  const float z = p.sigmainv * d2 / p.multiplier / p.multiplier;
  const float prob = expf(-z);
  const float dLdz = -p.sigmainv * g * (1.f - mask) /
                     (1.f - prob + EPS) * prob;
  // terms t0, t1 to columns 2e, 2e + 1 and t2, t3 to 2j, 2j + 1
  const bool vertex = which >= 3;
  const int e = vertex ? which - 3 : which, j = e == 2 ? 0 : e + 1;
  const float x1 = e == 0 ? v[0] : e == 1 ? v[2] : v[4];
  const float y1 = e == 0 ? v[1] : e == 1 ? v[3] : v[5];
  const float x2 = j == 0 ? v[0] : j == 1 ? v[2] : v[4];
  const float y2 = j == 0 ? v[1] : j == 1 ? v[3] : v[5];
  float t0, t1, t2 = 0.f, t3 = 0.f;
  if (vertex) {
    t0 = dLdz * 2.f * (x1 - px);
    t1 = dLdz * 2.f * (y1 - py);
  } else {
    const float A = y2 - y1;
    const float B = x1 - x2;
    const float C = x2 * y1 - x1 * y2;
    const float up = A * px + B * py + C;
    const float down = A * A + B * B;
    const float dsq = up * up / (down + EPS);
    const float dzdA = 2.f * (px * up - dsq * A) / (down + EPS);
    const float dzdB = 2.f * (py * up - dsq * B) / (down + EPS);
    const float dzdC = 2.f * up / (down + EPS);
    t0 = dLdz * (dzdB - y2 * dzdC);
    t1 = dLdz * (x2 * dzdC - dzdA);
    t2 = dLdz * (y1 * dzdC - dzdB);
    t3 = dLdz * (dzdA - x1 * dzdC);
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const int k = c >> 1;
    const float t = k == e ? (c & 1 ? t1 : t0)
                           : (!vertex && k == j ? (c & 1 ? t3 : t2) : 0.f);
    acc[c] += t;
  }
}

// Takes the first n <= 32 listed pairs, one a lane.
__device__ __forceinline__ void pairs(const Params& p, const Face& s,
                                      const PairList& L, int n, int lane,
                                      float* acc) {
  __syncwarp();
  if (lane < n)
    add_pair(p, s, L.pix[lane] >> 16, L.pix[lane] & 0xffff, L.g[lane],
             L.m[lane], acc);
  __syncwarp();
}

// Walks steps first, first + stride, ... (32 row segments of the
// rectangle each) of the face: the live pixels of a step are its
// candidates, taken 32 at a time, one a lane; those inside the float bbox
// and at or under their cut are listed, with their cotangent and mask
// (loaded beside the cut), and every 32 listed pairs are added. Returns
// how many pairs it listed.
__device__ __forceinline__ int walk(const Params& p, const uint32_t* live,
                                    int W32, const Face& s, int first,
                                    int stride, int lane, PairList& L,
                                    float* acc) {
  const int nseg = s.nr * s.nq;
  int count = 0, total = 0;
  for (int s0 = first * 32; s0 < nseg; s0 += stride * 32) {
    const int k = s0 + lane;
    unsigned m = 0u;
    int hy = 0, q = 0;
    if (k < nseg) m = segment(p, live, W32, s, k, &hy, &q);
    if (!__any_sync(FULL, m != 0u)) continue;    // no candidate
    const int cnt = __popc(m);
    int incl = cnt;                        // inclusive scan over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    const int cands = __shfl_sync(FULL, incl, 31);
    // 32 candidates at a time, one a lane
    for (int j0 = 0; j0 < cands; j0 += 32) {
      // candidate j lies in the segment of the first lane whose scan
      // exceeds j
      const int j = j0 + lane;
      int at = 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const int t = __shfl_sync(FULL, incl, at + o - 1);
        if (t <= j) at += o;
      }
      const unsigned mj = __shfl_sync(FULL, m, at);
      const int before = __shfl_sync(FULL, incl - cnt, at);
      const int hj = __shfl_sync(FULL, hy, at);
      const int qj = __shfl_sync(FULL, q, at);
      const int col = 32 * qj + nth_bit(mj, j - before);
      const float px = pixel_x(p.sx, col, p.W);
      const float py = pixel_y(p.sy, p.row_start + hj, p.total_height);
      bool ok = false;
      float gv = 0.f, mv = 0.f;
      if (j < cands && in_bbox(px, py, s.bb)) {
        const size_t pix = ((size_t)s.b * p.H + hj) * p.W + col;
        ok = s.f <= p.cut[pix];
        gv = p.grad[pix];
        mv = p.mask[pix];
      }
      const unsigned ballot = __ballot_sync(FULL, ok);
      if (ok) {
        const int at_list = count + __popc(ballot & ((1u << lane) - 1u));
        L.pix[at_list] = hj << 16 | col;
        L.g[at_list] = gv;
        L.m[at_list] = mv;
      }
      count += __popc(ballot);
      total += __popc(ballot);
      if (count >= 32) {
        pairs(p, s, L, 32, lane, acc);
        const int rest = count - 32;
        int mp = 0;
        float mg = 0.f, mm = 0.f;
        if (lane < rest) {
          mp = L.pix[32 + lane];
          mg = L.g[32 + lane];
          mm = L.m[32 + lane];
        }
        __syncwarp();
        if (lane < rest) {
          L.pix[lane] = mp;
          L.g[lane] = mg;
          L.m[lane] = mm;
        }
        count = rest;
      }
    }
  }
  if (count > 0) pairs(p, s, L, count, lane, acc);
  return total;
}

// The face's 6 sums, one warp's: a fixed shuffle tree, lane 0 writes.
__device__ __forceinline__ void write_face(const Params& p, int face,
                                           float* acc, int lane) {
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float sum = warp_sum(acc[c]);
    if (lane == 0) p.out[(size_t)face * 6 + c] = sum / p.multiplier;
  }
}

// Persistent: each warp takes faces warp, warp + the grid's warps, ...,
// the next face's bbox loaded while it works on the current one. A face
// of more than BIG_SEGS row segments is queued for the whole block, which
// takes the queues after every warp is done, segment steps in turn, and
// adds the warps' sums in warp order.
__global__ void __launch_bounds__(BWD_WARPS * 32, BWD_BLOCKS)
soft_mask_bwd_kernel(Params p, const uint32_t* live, int W32) {
  __shared__ PairList lists[BWD_WARPS];
  __shared__ float part[BWD_WARPS][6];
  __shared__ int queue[BWD_WARPS][BIG_QUEUE];
  __shared__ int queued[BWD_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  PairList& L = lists[warp];
  const int faces = p.B * p.F, stride = gridDim.x * BWD_WARPS;
  int nq = 0;
  int face = blockIdx.x * BWD_WARPS + warp;
  float next[4] = {0.f, 0.f, 0.f, 0.f};
  if (face < faces) load_bbox(p, face, next);
  for (; face < faces; face += stride) {
    float bb[4] = {next[0], next[1], next[2], next[3]};
    if (face + stride < faces) load_bbox(p, face + stride, next);
    Face s;
    load_face(p, face, bb, s);
    if (s.nr * s.nq > BIG_SEGS && nq < BIG_QUEUE) {
      if (lane == 0) queue[warp][nq] = face;
      ++nq;
      continue;
    }
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (walk(p, live, W32, s, 0, 1, lane, L, acc) > 0)
      write_face(p, face, acc, lane);
    else if (lane < 6)
      p.out[(size_t)face * 6 + lane] = 0.f;
  }
  if (lane == 0) queued[warp] = nq;
  __syncthreads();
  for (int w = 0; w < BWD_WARPS; ++w) {
    for (int k = 0; k < queued[w]; ++k) {
      const int f = queue[w][k];
      float bb[4];
      load_bbox(p, f, bb);
      Face t;
      load_face(p, f, bb, t);
      float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      walk(p, live, W32, t, warp, BWD_WARPS, lane, L, acc);
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const float sum = warp_sum(acc[c]);
        if (lane == 0) part[warp][c] = sum;
      }
      __syncthreads();
      if (threadIdx.x < 6) {
        float sum = 0.f;
        for (int i = 0; i < BWD_WARPS; ++i) sum += part[i][threadIdx.x];
        p.out[(size_t)f * 6 + threadIdx.x] = sum / p.multiplier;
      }
      __syncthreads();
    }
  }
}

dim3 pixel_grid(int B, int H, int W) {
  return dim3((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
}

}  // namespace

extern "C" {

// mask (B, H, W); cut (B, H, W) int32, written when not null; lists, the
// per-tile lists (tile_lists.cuh) of bboxes that hold these, made here
// from bbox first when bin_first is 1.
int soft_mask_forward(const float* img, const float* bbox,
                      const int32_t* face_idx, uint32_t* lists,
                      int bin_first, float* mask, int32_t* cut, int B, int F,
                      int H, int W, int row_start, int total_height, int knum,
                      float sx, float sy, float sigmainv, float multiplier,
                      float bad, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const Grid g = make_grid(B, F, H, W, row_start, total_height, sx, sy);
  if (bin_first) {
    err = bin(bbox, g, lists, s);
    if (err != cudaSuccess) return (int)err;
  }
  Params p{img, bbox, face_idx, nullptr, nullptr, cut, mask,
           B, F, H, W, row_start, total_height, knum,
           sx, sy, sigmainv, multiplier, bad};
  soft_mask_kernel<<<pixel_grid(B, H, W), dim3(TILE, TILE), 0, s>>>(
      p, lists, g.chunks);
  return (int)cudaGetLastError();
}

// grad_img (B, F, 6), the gradient of the UNSCALED image verts, every entry
// written; cut (B, H, W) from the forward; live, scratch of B * H *
// ceil(W / 32) words.
int soft_mask_backward(const float* img, const float* bbox,
                       const int32_t* cut, const float* mask,
                       const float* grad, int32_t* live, float* grad_img,
                       int B, int F, int H, int W, int row_start,
                       int total_height, float sx, float sy, float sigmainv,
                       float multiplier, float bad, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || F == 0) return (int)cudaGetLastError();
  // a listed pair packs its row and column in 16 bits each
  if (H > 32767 || W > 65535 || (long long)B * H * W > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int W32 = (W + 31) / 32, words = B * H * W32;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  Params p{img, bbox, nullptr, mask, grad, const_cast<int32_t*>(cut),
           grad_img, B, F, H, W, row_start, total_height, 0,
           sx, sy, sigmainv, multiplier, bad};
  if (words > 0)
    soft_mask_live_kernel<<<(words + BWD_WARPS - 1) / BWD_WARPS,
                            BWD_WARPS * 32, 0, (cudaStream_t)stream>>>(
        cut, grad, (uint32_t*)live, B * H, W, W32);
  // persistent (as many blocks as the card holds at once) when each warp
  // gets PERSIST faces or more; else a warp a face
  const long long faces = (long long)B * F, resident = (long long)sms * BWD_BLOCKS;
  const int blocks = (int)(faces >= resident * BWD_WARPS * PERSIST
                               ? resident
                               : (faces + BWD_WARPS - 1) / BWD_WARPS);
  soft_mask_bwd_kernel<<<blocks, BWD_WARPS * 32, 0, (cudaStream_t)stream>>>(
      p, (const uint32_t*)live, W32);
  return (int)cudaGetLastError();
}

}  // extern "C"
