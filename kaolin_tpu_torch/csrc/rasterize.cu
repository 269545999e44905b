// Z-buffer rasterization of triangle faces, one thread per pixel.
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
// (pixel, face) pairs. A naive per-pixel loop would test every face for
// every pixel. Faces are staged through shared memory 256 at a time in
// ORIGINAL order, and each stage is first compacted to the faces whose
// bbox overlaps the block's 16x16 pixel-centre rectangle (a ballot and an
// order-keeping prefix sum), so a thread runs the bbox and edge tests only
// against faces near its block. The z-test is a strict '>' over faces in
// original order, which gives the lowest-id tie rule without a packed key.
// The TPU design's band sort, 128-lane face table and face segments exist
// for the TPU's vector unit and are not carried over.
//
// Arithmetic matches the plain PyTorch version operation for operation
// (kaolin_tpu_torch/kernels/rasterize.py): the library is built with
// --fmad=false so no a*b+c is contracted, divisions are IEEE, the pixel
// scale m/W is formed on the host in double and rounded to float, and
// copysignf keeps the sign of a zero norm.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;                    // 16x16 pixels per block
constexpr int THREADS = TILE * TILE;        // one face per thread per stage
constexpr int WARPS = THREADS / 32;

struct Params {
  const float* fz;       // (B, F, 3)
  const float* img;      // (B, F, 6) scaled image verts
  const float* bbox;     // (B, F, 4) scaled (xmin, ymin, xmax, ymax)
  const float* feat;     // (B, F, 3*D) vertex-major, interp mode only
  int32_t* idx;          // (B, H, W)
  float* weights;        // (B, H, W, 3), interp mode
  float* out_feat;       // (B, H, W, D), interp mode
  float* zbuf;           // (B, H, W), select mode
  int F, H, W, D, row_start, total_height;
  float sx, sy, eps;
};

__device__ __forceinline__ float pixel_x(float sx, int col, int W) {
  return sx * (float)(2 * col + 1 - W);
}

__device__ __forceinline__ float pixel_y(float sy, int row, int total_h) {
  return sy * (float)(total_h - 2 * row - 1);
}

template <bool INTERP>
__global__ void __launch_bounds__(THREADS)
rasterize_kernel(Params p) {
  __shared__ float s_bbox[THREADS][4];
  __shared__ float s_img[THREADS][6];
  __shared__ float s_z[THREADS][3];
  __shared__ int s_id[THREADS];
  __shared__ int s_warp[WARPS];

  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int col = blockIdx.x * TILE + threadIdx.x;
  const int hy = blockIdx.y * TILE + threadIdx.y;
  const bool active = col < p.W && hy < p.H;
  const float px = pixel_x(p.sx, col, p.W);
  const float py = pixel_y(p.sy, p.row_start + hy, p.total_height);

  // pixel-centre rectangle of the block (x rises with col, y falls with row)
  const int c0 = blockIdx.x * TILE, c1 = min(c0 + TILE, p.W) - 1;
  const int r0 = blockIdx.y * TILE, r1 = min(r0 + TILE, p.H) - 1;
  const float bx_lo = pixel_x(p.sx, c0, p.W), bx_hi = pixel_x(p.sx, c1, p.W);
  const float by_hi = pixel_y(p.sy, p.row_start + r0, p.total_height);
  const float by_lo = pixel_y(p.sy, p.row_start + r1, p.total_height);

  const size_t fbase = (size_t)b * p.F;
  float best_z = -INFINITY;
  int best = -1;
  float bw0 = 0.f, bw1 = 0.f, bw2 = 0.f;

  for (int base = 0; base < p.F; base += THREADS) {
    const int f = base + tid;
    float bb[4] = {INFINITY, INFINITY, -INFINITY, -INFINITY};
    if (f < p.F) {
      const float* src = p.bbox + (fbase + f) * 4;
      bb[0] = src[0]; bb[1] = src[1]; bb[2] = src[2]; bb[3] = src[3];
    }
    // the face can hold a pixel centre of this block only if its bbox
    // overlaps the block's rectangle; culled faces carry an empty bbox
    const bool keep = bb[0] <= bx_hi && bb[2] > bx_lo &&
                      bb[1] <= by_hi && bb[3] > by_lo;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, count = 0;
    for (int i = 0; i < WARPS; ++i) {
      const int c = s_warp[i];
      offset += i < warp ? c : 0;
      count += c;
    }
    if (keep) {
      const int k = offset + __popc(ballot & ((1u << lane) - 1u));
      const float* im = p.img + (fbase + f) * 6;
      const float* z = p.fz + (fbase + f) * 3;
      for (int j = 0; j < 4; ++j) s_bbox[k][j] = bb[j];
      for (int j = 0; j < 6; ++j) s_img[k][j] = im[j];
      for (int j = 0; j < 3; ++j) s_z[k][j] = z[j];
      s_id[k] = f;
    }
    __syncthreads();

    if (active) {
      for (int k = 0; k < count; ++k) {
        if (!(px >= s_bbox[k][0] && px < s_bbox[k][2] &&
              py >= s_bbox[k][1] && py < s_bbox[k][3]))
          continue;
        const float ax = s_img[k][0] - px, ay = s_img[k][1] - py;
        const float bx = s_img[k][2] - px, by = s_img[k][3] - py;
        const float cx = s_img[k][4] - px, cy = s_img[k][5] - py;
        const float w0 = bx * cy - by * cx;
        const float w1 = cx * ay - cy * ax;
        const float w2 = ax * by - ay * bx;
        float norm = w0 + w1 + w2;
        norm = norm + copysignf(p.eps, norm);
        const float u0 = w0 / norm, u1 = w1 / norm, u2 = w2 / norm;
        if (!(u0 >= 0.f && u1 >= 0.f && u2 >= 0.f)) continue;
        const float z = u0 * s_z[k][0] + u1 * s_z[k][1] + u2 * s_z[k][2];
        if (z > best_z) {
          best_z = z;
          best = s_id[k];
          bw0 = u0; bw1 = u1; bw2 = u2;
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
  const size_t pix = ((size_t)b * p.H + hy) * p.W + col;
  p.idx[pix] = best;
  if (!INTERP) {
    p.zbuf[pix] = best_z;
    return;
  }
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

cudaError_t launch(const Params& p, int B, bool interp, int device,
                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (B == 0 || p.H == 0 || p.W == 0) return cudaGetLastError();
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

// Interp mode: idx (B,H,W) int32, weights (B,H,W,3), out_feat (B,H,W,D).
int rasterize_interp(const float* fz, const float* img, const float* bbox,
                     const float* feat, int32_t* idx, float* weights,
                     float* out_feat, int B, int F, int H, int W, int D,
                     int row_start, int total_height, float sx, float sy,
                     float eps, int device, void* stream) {
  Params p{fz, img, bbox, feat, idx, weights, out_feat, nullptr,
           F, H, W, D, row_start, total_height, sx, sy, eps};
  return (int)launch(p, B, true, device, (cudaStream_t)stream);
}

// Select mode: zbuf (B,H,W) float, idx (B,H,W) int32.
int rasterize_select(const float* fz, const float* img, const float* bbox,
                     float* zbuf, int32_t* idx, int B, int F, int H, int W,
                     int row_start, int total_height, float sx, float sy,
                     float eps, int device, void* stream) {
  Params p{fz, img, bbox, nullptr, idx, nullptr, nullptr, zbuf,
           F, H, W, 0, row_start, total_height, sx, sy, eps};
  return (int)launch(p, B, false, device, (cudaStream_t)stream);
}

}  // extern "C"
