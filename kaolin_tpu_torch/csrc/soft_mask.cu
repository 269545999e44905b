// DIB-R soft silhouette mask, forward, one thread per pixel.
//
// Replaces the TPU kernel kaolin_tpu/kernels/soft_mask.py
// soft_mask_forward_pallas. A covered pixel (face index >= 0) gets 1. An
// uncovered pixel walks the faces in ORIGINAL order, records the first
// knum whose boxlen-enlarged bbox contains it, and gets
// 1 - prod(1 - exp(-sigmainv * d^2 / m^2)) over them, with d^2 the least of
// the squared distances to the face's 3 edges (where the foot of the
// perpendicular falls inside the edge) and 3 vertices. This is the
// order-exact semantics of the JAX package's XLA path
// (kaolin_tpu/render/mesh/dibr.py _soft_mask_forward, _min6), not the
// Pallas kernel's spatially sorted order with its per-segment count reset.
//
// What bounds it on an H100: a few bytes per pixel and a few dozen per
// face, so the work is again the (pixel, face) pairs, here about a hundred
// float operations and one exp per recorded pair. Faces are staged through
// shared memory 256 at a time in original order and compacted to those
// whose enlarged bbox overlaps the block's pixel-centre rectangle; the
// compaction keeps the order, so the first-knum rule is exact. A block
// whose pixels are all covered writes ones and reads no face.
//
// Arithmetic follows the plain PyTorch version operation for operation
// (--fmad=false, IEEE division). expf may differ from PyTorch's exp on the
// CPU by an ulp or two; the plain version on the card calls the same
// expf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr int WARPS = THREADS / 32;
constexpr float EPS = 1e-7f;                // dibr.py _EPS

struct Params {
  const float* img;        // (B, F, 6) scaled image verts
  const float* bbox;       // (B, F, 4) scaled bbox, enlarged by boxlen*m
  const int32_t* face_idx; // (B, H, W)
  float* mask;             // (B, H, W)
  int F, H, W, row_start, total_height, knum;
  float sx, sy, sigmainv, multiplier, bad;
};

__device__ __forceinline__ float pixel_x(float sx, int col, int W) {
  return sx * (float)(2 * col + 1 - W);
}

__device__ __forceinline__ float pixel_y(float sy, int row, int total_h) {
  return sy * (float)(total_h - 2 * row - 1);
}

// Least squared distance from (px, py) to a face, as dibr.py _min6.
__device__ __forceinline__ float min6(float px, float py, const float* v,
                                      float bad) {
  float dmin = INFINITY;
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
    dmin = d < dmin ? d : dmin;
  }
  for (int i = 0; i < 3; ++i) {
    const float dx = px - v[2 * i], dy = py - v[2 * i + 1];
    const float d = dx * dx + dy * dy;
    dmin = d < dmin ? d : dmin;
  }
  return dmin;
}

__global__ void __launch_bounds__(THREADS)
soft_mask_kernel(Params p) {
  __shared__ float s_bbox[THREADS][4];
  __shared__ float s_img[THREADS][6];
  __shared__ int s_warp[WARPS];

  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z;
  const int col = blockIdx.x * TILE + threadIdx.x;
  const int hy = blockIdx.y * TILE + threadIdx.y;
  const bool active = col < p.W && hy < p.H;
  const size_t pix = ((size_t)b * p.H + hy) * p.W + col;
  const bool uncovered = active && p.face_idx[pix] < 0;

  if (!__syncthreads_or(uncovered)) {
    if (active) p.mask[pix] = 1.f;
    return;
  }

  const float px = pixel_x(p.sx, col, p.W);
  const float py = pixel_y(p.sy, p.row_start + hy, p.total_height);
  const int c0 = blockIdx.x * TILE, c1 = min(c0 + TILE, p.W) - 1;
  const int r0 = blockIdx.y * TILE, r1 = min(r0 + TILE, p.H) - 1;
  const float bx_lo = pixel_x(p.sx, c0, p.W), bx_hi = pixel_x(p.sx, c1, p.W);
  const float by_hi = pixel_y(p.sy, p.row_start + r0, p.total_height);
  const float by_lo = pixel_y(p.sy, p.row_start + r1, p.total_height);

  const size_t fbase = (size_t)b * p.F;
  int recorded = 0;
  float prod = 1.f;

  for (int base = 0; base < p.F; base += THREADS) {
    const int f = base + tid;
    float bb[4] = {INFINITY, INFINITY, -INFINITY, -INFINITY};
    if (f < p.F) {
      const float* src = p.bbox + (fbase + f) * 4;
      bb[0] = src[0]; bb[1] = src[1]; bb[2] = src[2]; bb[3] = src[3];
    }
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
      for (int j = 0; j < 4; ++j) s_bbox[k][j] = bb[j];
      for (int j = 0; j < 6; ++j) s_img[k][j] = im[j];
    }
    __syncthreads();

    if (uncovered) {
      for (int k = 0; k < count && recorded < p.knum; ++k) {
        if (!(px >= s_bbox[k][0] && px < s_bbox[k][2] &&
              py >= s_bbox[k][1] && py < s_bbox[k][3]))
          continue;
        const float d2 = min6(px, py, s_img[k], p.bad);
        const float z = p.sigmainv * d2 / p.multiplier / p.multiplier;
        const float prob = expf(-z);
        prod = prod * (1.f - prob);
        ++recorded;
      }
    }
    __syncthreads();
  }

  if (active) p.mask[pix] = uncovered ? 1.f - prod : 1.f;
}

}  // namespace

extern "C" {

int soft_mask_forward(const float* img, const float* bbox,
                      const int32_t* face_idx, float* mask, int B, int F,
                      int H, int W, int row_start, int total_height, int knum,
                      float sx, float sy, float sigmainv, float multiplier,
                      float bad, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  Params p{img, bbox, face_idx, mask, F, H, W, row_start, total_height,
           knum, sx, sy, sigmainv, multiplier, bad};
  const dim3 block(TILE, TILE);
  const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  soft_mask_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
