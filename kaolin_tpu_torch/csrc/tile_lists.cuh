// Per-tile face lists of the forward render kernels (rasterize.cu and the
// soft mask's forward in soft_mask.cu): for every 16x16 tile of pixels, the
// faces whose bbox overlaps the tile's pixel-centre rectangle, by the test
// (bb[0] <= x_hi && bb[2] > x_lo && bb[1] <= y_hi && bb[3] > y_lo).
//
// Layout: n slots of WORDS words. A slot is a (tile, CHUNK-face id range)
// pair; slot ((b * tile rows + ty) * tile columns + tx) * chunks + c holds
// the faces c * CHUNK .. of tile (ty, tx) of batch entry b, face f as bit
// f % 32 of word (f % CHUNK) / 32. The size depends on the shapes only (B
// * tiles * F / 8 bytes), so no count is read back to size it and no list
// is ever cut short; a slot's bits are its faces in id order, so a walk in
// id order needs no sort.
//
// bin_faces (the binning, after a memset of the words): a warp takes up to
// 32 faces; a lane maps its face's bbox to a span of tiles by integer
// arithmetic, padded by one tile, and trims the span at both ends by the
// float test; a face over a few tiles sets its bits itself, a larger one is
// set by the whole warp, a tile a lane (atomics that return nothing). With
// few faces a warp takes fewer, to spread them over the card.
// A walk (walk_tile) loads its tile's words into shared memory, PASS slots
// at a time, counts each slot's faces, and hands each nonempty slot's
// faces to the kernel in id order.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int TILE = 16;                    // pixels a side of a tile
constexpr int CHUNK = 1024;                 // face ids a slot
constexpr int WORDS = CHUNK / 32;           // words a slot

__device__ __forceinline__ float pixel_x(float sx, int col, int W) {
  return sx * (float)(2 * col + 1 - W);
}

__device__ __forceinline__ float pixel_y(float sy, int row, int total_h) {
  return sy * (float)(total_h - 2 * row - 1);
}

// The tiles of one binning: the slab's rows and columns, its place in a
// taller image, the pixel scales, and the tile and slot counts.
struct Grid {
  int B, F, H, W, row_start, total_height, tx, ty, chunks;
  float sx, sy;
};

inline Grid make_grid(int B, int F, int H, int W, int row_start,
                      int total_height, float sx, float sy) {
  return Grid{B, F, H, W, row_start, total_height, (W + TILE - 1) / TILE,
              (H + TILE - 1) / TILE, (F + CHUNK - 1) / CHUNK, sx, sy};
}

// The float test, split by axis: the bbox overlaps tile column t's, or
// tile row t's, pixel-centre range.
__device__ __forceinline__ bool x_overlap(const float* bb, const Grid& g,
                                          int t) {
  const int c0 = t * TILE, c1 = min(c0 + TILE, g.W) - 1;
  return bb[0] <= pixel_x(g.sx, c1, g.W) && bb[2] > pixel_x(g.sx, c0, g.W);
}

__device__ __forceinline__ bool y_overlap(const float* bb, const Grid& g,
                                          int t) {
  const int r0 = t * TILE, r1 = min(r0 + TILE, g.H) - 1;
  return bb[1] <= pixel_y(g.sy, g.row_start + r0, g.total_height) &&
         bb[3] > pixel_y(g.sy, g.row_start + r1, g.total_height);
}

// Tiles of n_tiles whose pixels (of a line of n centres s * (2i + 1 - n),
// less `first`) can have centres in [v0, v1): the pixel span padded by one,
// then by one tile on each side, clipped. rs = 1 / s; fminf and fmaxf keep
// NaN and infinite bounds finite, and the caller trims by the float test.
__device__ __forceinline__ void tile_span(float v0, float v1, float rs,
                                          int n, int first, int n_tiles,
                                          int* t0, int* t1) {
  const float a = (v0 * rs + (float)(n - 1)) * 0.5f;
  const float b = (v1 * rs + (float)(n - 1)) * 0.5f;
  const float edge = (float)(n_tiles * TILE);
  float lo = floorf(fminf(a, b)) - 1.f - (float)first;
  float hi = ceilf(fmaxf(a, b)) + 1.f - (float)first;
  lo = fminf(fmaxf(lo, -(float)TILE), edge);
  hi = fminf(fmaxf(hi, -(float)TILE), edge);
  *t0 = max((int)floorf(lo / TILE) - 1, 0);
  *t1 = min((int)floorf(hi / TILE) + 1, n_tiles - 1);
}

// The tiles whose pixel-centre rectangle the bbox overlaps: a span from
// tile_span, trimmed at both ends by the float test (each axis's test is
// monotone in the tile index, so the tiles that pass are one span).
// Returns false when there are none.
__device__ __forceinline__ bool face_tiles(const float* bb, const Grid& g,
                                           int* tx0, int* tx1, int* ty0,
                                           int* ty1) {
  tile_span(bb[0], bb[2], 1.f / g.sx, g.W, 0, g.tx, tx0, tx1);
  // rows count down in y
  tile_span(-bb[3], -bb[1], 1.f / g.sy, g.total_height, g.row_start, g.ty,
            ty0, ty1);
  while (*tx0 <= *tx1 && !x_overlap(bb, g, *tx0)) ++*tx0;
  while (*tx1 >= *tx0 && !x_overlap(bb, g, *tx1)) --*tx1;
  while (*ty0 <= *ty1 && !y_overlap(bb, g, *ty0)) ++*ty0;
  while (*ty1 >= *ty0 && !y_overlap(bb, g, *ty1)) --*ty1;
  return *tx0 <= *tx1 && *ty0 <= *ty1;
}

constexpr int SMALL = 8;                    // tiles a lane sets alone

// Sets the bits of faces warp * per .. warp * per + per - 1 (of B * F),
// per <= 32: lane l < per finds face l's tiles; a face over at most SMALL
// tiles is set by its own lane, a larger one by the whole warp, a tile a
// lane. Every lane of the warp calls it.
__device__ __forceinline__ void bin_faces(const float* bbox, const Grid& g,
                                          uint32_t* words, long long warp,
                                          int per, int lane) {
  const long long i = warp * per + lane;
  int tx0 = 0, tx1 = -1, ty0 = 0, ty1 = -1, b = 0, f = 0;
  if (lane < per && i < (long long)g.B * g.F) {
    b = (int)(i / g.F);
    f = (int)(i - (long long)b * g.F);
    const float bb[4] = {bbox[i * 4], bbox[i * 4 + 1], bbox[i * 4 + 2],
                         bbox[i * 4 + 3]};
    if (!face_tiles(bb, g, &tx0, &tx1, &ty0, &ty1)) tx1 = tx0 - 1;
  }
  const int nx = max(tx1 - tx0 + 1, 0), pairs = nx * max(ty1 - ty0 + 1, 0);
  // the face's bit in slot (0, 0) of its tiles' row-major walk
  const size_t word = (size_t)(f / CHUNK) * WORDS + ((f % CHUNK) >> 5);
  const size_t base = (size_t)b * g.ty * g.tx;
  const unsigned bit = 1u << (f & 31);
  const size_t stride = (size_t)g.chunks * WORDS;     // words a tile
  if (pairs <= SMALL) {
    for (int ty = ty0; ty <= ty1; ++ty)
      for (int tx = tx0; tx <= tx1; ++tx)
        atomicOr(&words[(base + (size_t)ty * g.tx + tx) * stride + word], bit);
  }
  for (unsigned m = __ballot_sync(0xffffffffu, pairs > SMALL); m != 0u;
       m &= m - 1u) {
    const int l = __ffs(m) - 1;
    const int n = __shfl_sync(0xffffffffu, pairs, l);
    const int w = __shfl_sync(0xffffffffu, nx, l);
    const int x0 = __shfl_sync(0xffffffffu, tx0, l);
    const int y0 = __shfl_sync(0xffffffffu, ty0, l);
    const size_t lb = __shfl_sync(0xffffffffu, base, l);
    const size_t lw = __shfl_sync(0xffffffffu, word, l);
    const unsigned lbit = __shfl_sync(0xffffffffu, bit, l);
    for (int k = lane; k < n; k += 32) {
      const int ty = y0 + k / w, tx = x0 + k % w;
      atomicOr(&words[(lb + (size_t)ty * g.tx + tx) * stride + lw], lbit);
    }
  }
}

constexpr int BIN_THREADS = 64;             // two warps a block: spread wide

__global__ void __launch_bounds__(BIN_THREADS)
tile_bins_kernel(const float* bbox, Grid g, uint32_t* words, int per) {
  bin_faces(bbox, g, words,
            ((long long)blockIdx.x * BIN_THREADS + threadIdx.x) >> 5, per,
            threadIdx.x & 31);
}

// Bins bbox (B, F, 4) into words (n * WORDS, n = B * tiles * chunks).
inline cudaError_t bin(const float* bbox, const Grid& g, uint32_t* words,
                       cudaStream_t s) {
  const size_t n = (size_t)g.B * g.ty * g.tx * g.chunks;
  if (n == 0) return cudaGetLastError();
  cudaError_t err =
      cudaMemsetAsync(words, 0, n * WORDS * sizeof(uint32_t), s);
  if (err != cudaSuccess) return err;
  // faces a warp: enough warps to spread few faces over the card
  const long long faces = (long long)g.B * g.F;
  const int per = (int)std::min<long long>(32, std::max(1LL, faces / 4096));
  const long long warps = (faces + per - 1) / per;
  tile_bins_kernel<<<(unsigned)((warps * 32 + BIN_THREADS - 1) /
                                BIN_THREADS),
                     BIN_THREADS, 0, s>>>(bbox, g, words, per);
  return cudaGetLastError();
}

// Warp 0 of a walk's block: the faces of a slot (its WORDS words, ids from
// base), in id order, into order[]; a lane a word, a scan of the words'
// bit counts placing each.
__device__ __forceinline__ void slot_ids(const uint32_t* words, int base,
                                         int lane, int* order) {
  static_assert(WORDS == 32, "a lane a word");
  const unsigned m = words[lane];
  const int cnt = __popc(m);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  int at = incl - cnt;
  for (unsigned w = m; w != 0u; w &= w - 1u)
    order[at++] = base + lane * 32 + __ffs(w) - 1;
}

// A face's pixels in a 16x16 tile, exactly as the bbox test picks them: bit
// c (low 16) where column c's centre xs[c] lies in [bb[0], bb[2]), bit 16 +
// r where row r's centre ys[r] lies in [bb[1], bb[3]); the pixel (r, c) is
// inside the bbox iff both bits are set. The columns, and the rows, that
// pass are one span each (the centres are monotone).
__device__ __forceinline__ unsigned tile_mask(const float* bb,
                                              const float* xs,
                                              const float* ys) {
  unsigned m = 0u;
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    m |= (unsigned)(xs[i] >= bb[0] && xs[i] < bb[2]) << i;
    m |= (unsigned)(ys[i] >= bb[1] && ys[i] < bb[3]) << (TILE + i);
  }
  return m;
}

constexpr int PASS = 32;                    // slots a walk holds at a time

// What a walk keeps in shared memory: a pass of its tile's words, each
// slot's face count, a slot's faces in id order.
struct WalkLists {
  uint32_t words[PASS * WORDS];
  int count[PASS];
  int order[CHUNK];
};

// The walk of one 16x16 tile's list (the block's; blockDim 16 x 16): for
// each nonempty slot in id order, warp 0 lists its faces into L.order and
// take(n) runs with n of them; a take must end with a barrier, and may
// return false to stop the walk. Every thread of the block calls it.
template <typename Take>
__device__ __forceinline__ void walk_tile(const uint32_t* words, int chunks,
                                          WalkLists& L, Take take) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t tile =
      ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  words += tile * chunks * WORDS;
  for (int c0 = 0; c0 < chunks; c0 += PASS) {
    const int slots = min(PASS, chunks - c0);
    // the last take ended with a barrier: the arrays are free
    for (int k = tid; k < slots * WORDS; k += 256)
      L.words[k] = words[(size_t)c0 * WORDS + k];
    __syncthreads();
    for (int c = warp; c < slots; c += 8) {
      const int n = __reduce_add_sync(0xffffffffu,
                                      __popc(L.words[c * WORDS + lane]));
      if (lane == 0) L.count[c] = n;
    }
    __syncthreads();
    for (int c = 0; c < slots; ++c) {
      if (L.count[c] == 0) continue;
      if (warp == 0)
        slot_ids(L.words + c * WORDS, (c0 + c) * CHUNK, lane, L.order);
      __syncthreads();
      if (!take(L.count[c])) return;
    }
  }
}

}  // namespace
