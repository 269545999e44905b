// Z-buffer rasterization of triangle faces, one thread per pixel, over
// per-tile face lists; and the binning pass that makes those lists, for this
// kernel and for the soft mask's forward (soft_mask.cu).
//
// Replaces two TPU kernels of the JAX package:
//   kaolin_tpu/kernels/rasterize.py  rasterize_interp_pallas  (interp mode)
//   kaolin_tpu/kernels/rasterize.py  rasterize_select_pallas  (select mode)
// Both compute, per pixel, the covering face with the largest interpolated
// z, ties to the lowest original face id. Interp mode writes that face's
// index (-1 where uncovered), its barycentric weights and its interpolated
// features; select mode writes the winning z (-inf where uncovered) and the
// index.
//
// What bounds it on an H100: the outputs are a few bytes per pixel and the
// faces a few dozen bytes each, so the bytes are small; the work is the
// (pixel, face) pairs. A face's bbox spans a few of the 16x16 pixel tiles
// (about 100 pixels at 20,480 faces and 512x512), so a tile needs only the
// faces whose bbox overlaps it. As the TPU design gives each tile a face
// range, a binning pass (tile_lists.cuh) lists them, a bit a (tile, face):
// the entry points bin their own bboxes first, or take the lists that
// dibr_rasterization made once from the soft mask's enlarged bboxes, which
// hold these (tile_bins). A block a tile walks its list in id order,
// staging 256 faces at a time in one round of loads, each with the tile's
// pixels in its bbox (tile_mask: a bit a column and a bit a row); a warp (2
// rows of 16 pixels) takes 32 staged faces at a time, skips those over none
// of its pixels, and each pixel runs the plain version's arithmetic on the
// faces whose bbox holds it, skipping the three divisions where an edge
// function's sign already puts it outside. The z-test is a strict '>' in id
// order, which gives the lowest-id tie rule without a packed key. The TPU
// design's band sort, 128-lane face table and face segments exist for the
// TPU's vector unit and are not carried over. What remains bounds it: the
// divergent per-pixel arithmetic (a warp pays for a face if one of its
// pixels is in the bbox, the IEEE divisions if one is inside).
//
// Arithmetic matches the plain PyTorch version operation for operation
// (kaolin_tpu_torch/kernels/rasterize.py): the library is built with
// --fmad=false so no a*b+c is contracted, divisions are IEEE, the pixel
// scale m/W is formed on the host in double and rounded to float, and
// copysignf keeps the sign of a zero norm.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_lists.cuh"

namespace {

constexpr int THREADS = TILE * TILE;        // one face per thread per stage
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* fz;       // (B, F, 3)
  const float* img;      // (B, F, 6) scaled image verts
  const float* bbox;     // (B, F, 4) scaled (xmin, ymin, xmax, ymax)
  const float* feat;     // (B, F, 3*D) vertex-major, interp mode only
  const uint32_t* words;   // the per-tile lists (tile_lists.cuh)
  int32_t* idx;          // (B, H, W)
  float* weights;        // (B, H, W, 3), interp mode
  float* out_feat;       // (B, H, W, D), interp mode
  float* zbuf;           // (B, H, W), select mode
  int F, H, W, D, row_start, total_height, chunks;
  float sx, sy, eps;
};

// True where w / norm is surely < 0, so the pixel is outside the face and
// the divisions can be skipped: the signs differ and the quotient cannot
// round to zero (|w| > |norm| * 2^-100); a zero, infinite or NaN norm, or a
// zero or NaN w, is left to the divisions.
__device__ __forceinline__ bool outside(float w, float norm) {
  return (w < 0.f) != (norm < 0.f) && fabsf(w) > fabsf(norm) * 0x1p-100f &&
         norm != 0.f;
}

// The barycentric weights of (px, py) in the face of scaled verts v, the
// plain version's operations in its order; true where the pixel is inside
// (all three >= 0). A pixel surely outside skips the divisions and returns
// false with the weights unset.
__device__ __forceinline__ bool barycentric(const float* v, float px,
                                            float py, float eps, float* u0,
                                            float* u1, float* u2) {
  const float ax = v[0] - px, ay = v[1] - py;
  const float bx = v[2] - px, by = v[3] - py;
  const float cx = v[4] - px, cy = v[5] - py;
  const float w0 = bx * cy - by * cx;
  const float w1 = cx * ay - cy * ax;
  const float w2 = ax * by - ay * bx;
  float norm = w0 + w1 + w2;
  norm = norm + copysignf(eps, norm);
  if (outside(w0, norm) || outside(w1, norm) || outside(w2, norm))
    return false;
  *u0 = w0 / norm;
  *u1 = w1 / norm;
  *u2 = w2 / norm;
  return *u0 >= 0.f && *u1 >= 0.f && *u2 >= 0.f;
}

// Whether the pixel (r, c) of the tile is in a face of tile_mask m.
__device__ __forceinline__ bool in_mask(unsigned m, int r, int c) {
  return (m >> c) & (m >> (TILE + r)) & 1u;
}

template <bool INTERP>
__global__ void __launch_bounds__(THREADS)
rasterize_kernel(Params p) {
  __shared__ unsigned s_mask[THREADS];
  __shared__ float s_img[THREADS][6];
  __shared__ float s_z[THREADS][3];
  __shared__ int s_id[THREADS];
  __shared__ float s_x[TILE], s_y[TILE];
  __shared__ WalkLists lists;

  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int col = blockIdx.x * TILE + threadIdx.x;
  const int hy = blockIdx.y * TILE + threadIdx.y;
  const bool active = col < p.W && hy < p.H;
  // the tile's pixel centres (x rises with col, y falls with row)
  if (tid < TILE) s_x[tid] = pixel_x(p.sx, blockIdx.x * TILE + tid, p.W);
  else if (tid < 2 * TILE)
    s_y[tid - TILE] = pixel_y(p.sy, p.row_start + blockIdx.y * TILE + tid -
                                        TILE, p.total_height);
  const float px = pixel_x(p.sx, col, p.W);
  const float py = pixel_y(p.sy, p.row_start + hy, p.total_height);
  // the rows of this warp's pixels
  const unsigned warp_rows = 3u << (TILE + 2 * warp);

  const size_t fbase = (size_t)b * p.F;
  float best_z = -INFINITY;
  int best = -1;

  walk_tile(p.words, p.chunks, lists, [&](int n) {
    for (int s0 = 0; s0 < n; s0 += THREADS) {
      const int count = min(THREADS, n - s0);
      if (tid < count) {
        // culled faces carry an empty bbox: no pixel
        const int f = lists.order[s0 + tid];
        const float* im = p.img + (fbase + f) * 6;
        const float* z = p.fz + (fbase + f) * 3;
        s_mask[tid] = tile_mask(p.bbox + (fbase + f) * 4, s_x, s_y);
        for (int j = 0; j < 6; ++j) s_img[tid][j] = im[j];
        for (int j = 0; j < 3; ++j) s_z[tid][j] = z[j];
        s_id[tid] = f;
      }
      __syncthreads();
      // 32 faces at a time: those over this warp's pixels, in id order
      for (int k0 = 0; k0 < count; k0 += 32) {
        const unsigned fm = k0 + lane < count ? s_mask[k0 + lane] : 0u;
        const bool over = (fm & warp_rows) && (fm & 0xffffu);
        for (unsigned m = __ballot_sync(FULL, over); m != 0u; m &= m - 1u) {
          const int k = k0 + __ffs(m) - 1;
          if (!active || !in_mask(s_mask[k], threadIdx.y, threadIdx.x))
            continue;
          float u0, u1, u2;
          if (!barycentric(s_img[k], px, py, p.eps, &u0, &u1, &u2)) continue;
          const float z = u0 * s_z[k][0] + u1 * s_z[k][1] + u2 * s_z[k][2];
          if (z > best_z) {
            best_z = z;
            best = s_id[k];
          }
        }
      }
      __syncthreads();
    }
    return true;
  });

  if (!active) return;
  const size_t pix = ((size_t)b * p.H + hy) * p.W + col;
  p.idx[pix] = best;
  if (!INTERP) {
    p.zbuf[pix] = best_z;
    return;
  }
  // the winner's weights, computed again as its test computed them (held
  // through the walk they would cost the registers of two blocks an SM)
  float bw0 = 0.f, bw1 = 0.f, bw2 = 0.f;
  if (best >= 0)
    barycentric(p.img + (fbase + best) * 6, px, py, p.eps, &bw0, &bw1, &bw2);
  p.weights[pix * 3 + 0] = bw0;
  p.weights[pix * 3 + 1] = bw1;
  p.weights[pix * 3 + 2] = bw2;
  float* out = p.out_feat + pix * p.D;
  if (best < 0) {
    for (int d = 0; d < p.D; ++d) out[d] = 0.f;
    return;
  }
  const float* fv = p.feat + (fbase + best) * 3 * p.D;
  for (int d = 0; d < p.D; ++d)
    out[d] = bw0 * fv[d] + bw1 * fv[p.D + d] + bw2 * fv[2 * p.D + d];
}

// Bins p.bbox into the lists first when bin_first, then walks them.
cudaError_t launch(const Params& p, int B, bool interp, bool bin_first,
                   int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || p.H == 0 || p.W == 0) return cudaGetLastError();
  if (bin_first) {
    const Grid g = make_grid(B, p.F, p.H, p.W, p.row_start, p.total_height,
                             p.sx, p.sy);
    err = bin(p.bbox, g, const_cast<uint32_t*>(p.words), stream);
    if (err != cudaSuccess) return err;
  }
  const dim3 block(TILE, TILE);
  const dim3 grid((p.W + TILE - 1) / TILE, (p.H + TILE - 1) / TILE, B);
  if (interp)
    rasterize_kernel<true><<<grid, block, 0, stream>>>(p);
  else
    rasterize_kernel<false><<<grid, block, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Interp mode: idx (B,H,W) int32, weights (B,H,W,3), out_feat (B,H,W,D);
// lists, the per-tile lists (tile_lists.cuh), made here from bbox first
// when bin_first is 1.
int rasterize_interp(const float* fz, const float* img, const float* bbox,
                     const float* feat, uint32_t* lists, int bin_first,
                     int32_t* idx, float* weights, float* out_feat, int B,
                     int F, int H, int W, int D, int row_start,
                     int total_height, float sx, float sy, float eps,
                     int device, void* stream) {
  Params p{fz, img, bbox, feat, lists, idx, weights, out_feat, nullptr,
           F, H, W, D, row_start, total_height, (F + CHUNK - 1) / CHUNK,
           sx, sy, eps};
  return (int)launch(p, B, true, bin_first != 0, device,
                     (cudaStream_t)stream);
}

// Select mode: zbuf (B,H,W) float, idx (B,H,W) int32.
int rasterize_select(const float* fz, const float* img, const float* bbox,
                     uint32_t* lists, int bin_first, float* zbuf,
                     int32_t* idx, int B, int F, int H, int W, int row_start,
                     int total_height, float sx, float sy, float eps,
                     int device, void* stream) {
  Params p{fz, img, bbox, nullptr, lists, idx, nullptr, nullptr, zbuf,
           F, H, W, 0, row_start, total_height, (F + CHUNK - 1) / CHUNK,
           sx, sy, eps};
  return (int)launch(p, B, false, bin_first != 0, device,
                     (cudaStream_t)stream);
}

// The per-tile lists (tile_lists.cuh) of bbox (B, F, 4): B * ceil(H/16) *
// ceil(W/16) * ceil(F/CHUNK) * WORDS words.
int tile_bins(const float* bbox, uint32_t* lists, int B, int F, int H, int W,
              int row_start, int total_height, float sx, float sy,
              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)bin(bbox,
                  make_grid(B, F, H, W, row_start, total_height, sx, sy),
                  lists, (cudaStream_t)stream);
}

}  // extern "C"
