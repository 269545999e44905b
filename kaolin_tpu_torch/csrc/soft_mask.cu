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
// takes the place of atomics, so every launch gives the same bits.
//   When a gradient is needed, the forward also writes, per uncovered
//   pixel, the id of its knum-th recorded face, or F where it recorded
//   fewer; -1 for covered pixels (the cut). So face f was recorded at
//   pixel p iff its enlarged bbox holds p and f <= cut[p].
//   The backward (soft_mask_bwd_kernel), one warp per (batch, face), walks
//   the pixel rectangle of the face's enlarged bbox, padded by one pixel
//   and clipped to the slab, keeps the pixels where the forward's float
//   bbox test passes, f <= cut and the incoming gradient is nonzero, and
//   sums the per-pixel terms of the JAX package's XLA backward (dibr.py
//   _dibr_soft_mask_bwd):
//   dLdz = -sigmainv * dLdp * (1 - mask) / (1 - p + 1e-7) * p, times the
//   derivative of the least distance (first of the 6 on ties), by vertex
//   or by edge. Lanes sum in registers and a shuffle tree adds them in a
//   fixed order. The Pallas kernel's moment form is not carried over.
//
// What bounds it on an H100: a few bytes per pixel and a few dozen per
// face, so the work is the (pixel, face) pairs, here about a hundred float
// operations and one exp per recorded pair (twice that in the backward).
// The forward stages faces through shared memory 256 at a time in
// original order, compacted to those whose enlarged bbox overlaps the
// block's pixel-centre rectangle; the compaction keeps the order, so the
// first-knum rule is exact, and a block stops walking once none of its
// pixels can record more. In the backward a face whose enlarged bbox
// covers much of the image makes its one warp walk many pixels (binning
// is later work).
//
// Arithmetic follows the plain PyTorch version operation for operation
// (--fmad=false, IEEE division). expf may differ from PyTorch's exp on the
// CPU by an ulp or two; the plain version on the card calls the same
// expf. The backward's per-face sums run in another order than the plain
// version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int THREADS = TILE * TILE;
constexpr int WARPS = THREADS / 32;
constexpr int BWD_WARPS = 8;                // faces per backward block
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

__device__ __forceinline__ float pixel_x(float sx, int col, int W) {
  return sx * (float)(2 * col + 1 - W);
}

__device__ __forceinline__ float pixel_y(float sy, int row, int total_h) {
  return sy * (float)(total_h - 2 * row - 1);
}

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

struct Staged {
  float bbox[THREADS][4];
  float img[THREADS][6];
  int id[THREADS];
  int warp_count[WARPS];
};

// Stages faces base .. base + THREADS - 1 of batch entry b into shared
// memory, compacted in original order to those whose enlarged bbox overlaps
// the block's pixel-centre rectangle [x_lo, x_hi] x [y_lo, y_hi]; returns
// how many it kept. Every thread of the block calls it.
__device__ int stage_faces(const Params& p, int b, int base, float x_lo,
                           float x_hi, float y_lo, float y_hi, Staged& s) {
  const int tid = threadIdx.y * TILE + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int f = base + tid;
  const size_t face = (size_t)b * p.F + f;
  float bb[4] = {INFINITY, INFINITY, -INFINITY, -INFINITY};
  if (f < p.F) {
    const float* src = p.bbox + face * 4;
    bb[0] = src[0]; bb[1] = src[1]; bb[2] = src[2]; bb[3] = src[3];
  }
  const bool keep = bb[0] <= x_hi && bb[2] > x_lo &&
                    bb[1] <= y_hi && bb[3] > y_lo;
  const unsigned ballot = __ballot_sync(FULL, keep);
  if (lane == 0) s.warp_count[warp] = __popc(ballot);
  __syncthreads();
  int offset = 0, count = 0;
  for (int i = 0; i < WARPS; ++i) {
    const int c = s.warp_count[i];
    offset += i < warp ? c : 0;
    count += c;
  }
  if (keep) {
    const int k = offset + __popc(ballot & ((1u << lane) - 1u));
    const float* im = p.img + face * 6;
    for (int j = 0; j < 4; ++j) s.bbox[k][j] = bb[j];
    for (int j = 0; j < 6; ++j) s.img[k][j] = im[j];
    s.id[k] = f;
  }
  __syncthreads();
  return count;
}

// The pixel of this thread and the pixel-centre rectangle of its block.
struct Pixel {
  int b, col, hy;
  bool active;
  size_t pix;
  float px, py, x_lo, x_hi, y_lo, y_hi;
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
  const int c0 = blockIdx.x * TILE, c1 = min(c0 + TILE, p.W) - 1;
  const int r0 = blockIdx.y * TILE, r1 = min(r0 + TILE, p.H) - 1;
  q.x_lo = pixel_x(p.sx, c0, p.W);
  q.x_hi = pixel_x(p.sx, c1, p.W);
  q.y_hi = pixel_y(p.sy, p.row_start + r0, p.total_height);
  q.y_lo = pixel_y(p.sy, p.row_start + r1, p.total_height);
  return q;
}

__device__ __forceinline__ bool in_bbox(float px, float py, const float* bb) {
  return px >= bb[0] && px < bb[2] && py >= bb[1] && py < bb[3];
}

__global__ void __launch_bounds__(THREADS)
soft_mask_kernel(Params p) {
  __shared__ Staged s;
  const Pixel q = block_pixel(p);
  const bool uncovered = q.active && p.face_idx[q.pix] < 0;
  int recorded = 0, cut = p.F;
  float prod = 1.f;

  for (int base = 0; base < p.F; base += THREADS) {
    // also the barrier before the stage is overwritten
    if (!__syncthreads_or(uncovered && recorded < p.knum)) break;
    const int count = stage_faces(p, q.b, base, q.x_lo, q.x_hi, q.y_lo,
                                  q.y_hi, s);
    if (uncovered) {
      for (int k = 0; k < count && recorded < p.knum; ++k) {
        if (!in_bbox(q.px, q.py, s.bbox[k])) continue;
        int which;
        const float d2 = min6(q.px, q.py, s.img[k], p.bad, &which);
        const float z = p.sigmainv * d2 / p.multiplier / p.multiplier;
        const float prob = expf(-z);
        prod = prod * (1.f - prob);
        if (++recorded == p.knum) cut = s.id[k];
      }
    }
  }

  if (q.active) {
    p.out[q.pix] = uncovered ? 1.f - prod : 1.f;
    if (p.cut) p.cut[q.pix] = uncovered && p.knum > 0 ? cut : -1;
  }
}

// Indices i whose centre s * (2i + 1 - n) can lie in [v0, v1), padded by
// one on each side; unclipped.
__device__ __forceinline__ void centre_span(float v0, float v1, float s,
                                            int n, float* lo, float* hi) {
  *lo = floorf((v0 / s + (float)(n - 1)) * 0.5f) - 1.f;
  *hi = ceilf((v1 / s + (float)(n - 1)) * 0.5f) + 1.f;
}

__device__ __forceinline__ int clamp_index(float v, int lo, int hi) {
  return (int)fminf(fmaxf(v, (float)lo), (float)hi);
}

__global__ void __launch_bounds__(BWD_WARPS * 32)
soft_mask_bwd_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const int face = blockIdx.x * BWD_WARPS + (threadIdx.x >> 5);
  if (face >= p.B * p.F) return;          // the whole warp leaves together
  const int b = face / p.F, f = face - b * p.F;
  float v[6], bb[4];
  for (int j = 0; j < 6; ++j) v[j] = p.img[(size_t)face * 6 + j];
  for (int j = 0; j < 4; ++j) bb[j] = p.bbox[(size_t)face * 4 + j];

  // the enlarged bbox's pixel rectangle; rows count down in y
  float lo, hi;
  centre_span(bb[0], bb[2], p.sx, p.W, &lo, &hi);
  const int c0 = clamp_index(lo, 0, p.W), c1 = clamp_index(hi, -1, p.W - 1);
  centre_span(-bb[3], -bb[1], p.sy, p.total_height, &lo, &hi);
  const int r0 = clamp_index(lo - (float)p.row_start, 0, p.H);
  const int r1 = clamp_index(hi - (float)p.row_start, -1, p.H - 1);
  const int nc = c1 >= c0 ? c1 - c0 + 1 : 0;
  const int npix = r1 >= r0 ? nc * (r1 - r0 + 1) : 0;

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = lane; k < npix; k += 32) {
    const int hy = r0 + k / nc, col = c0 + k % nc;
    const float px = pixel_x(p.sx, col, p.W);
    const float py = pixel_y(p.sy, p.row_start + hy, p.total_height);
    if (!in_bbox(px, py, bb)) continue;
    const size_t pix = ((size_t)b * p.H + hy) * p.W + col;
    if (f > p.cut[pix]) continue;
    const float g = p.grad[pix];
    if (g == 0.f) continue;
    int which;
    const float d2 = min6(px, py, v, p.bad, &which);
    const float z = p.sigmainv * d2 / p.multiplier / p.multiplier;
    const float prob = expf(-z);
    const float dLdz = -p.sigmainv * g * (1.f - p.mask[pix]) /
                       (1.f - prob + EPS) * prob;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      if (which == 3 + i) {
        acc[2 * i] += dLdz * 2.f * (v[2 * i] - px);
        acc[2 * i + 1] += dLdz * 2.f * (v[2 * i + 1] - py);
      }
    }
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      if (which == e) {
        const int j = (e + 1) % 3;
        const float x1 = v[2 * e], y1 = v[2 * e + 1];
        const float x2 = v[2 * j], y2 = v[2 * j + 1];
        const float A = y2 - y1;
        const float B = x1 - x2;
        const float C = x2 * y1 - x1 * y2;
        const float up = A * px + B * py + C;
        const float down = A * A + B * B;
        const float dsq = up * up / (down + EPS);
        const float dzdA = 2.f * (px * up - dsq * A) / (down + EPS);
        const float dzdB = 2.f * (py * up - dsq * B) / (down + EPS);
        const float dzdC = 2.f * up / (down + EPS);
        acc[2 * e] += dLdz * (dzdB - y2 * dzdC);
        acc[2 * e + 1] += dLdz * (x2 * dzdC - dzdA);
        acc[2 * j] += dLdz * (y1 * dzdC - dzdB);
        acc[2 * j + 1] += dLdz * (dzdA - x1 * dzdC);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < 6; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[c] += __shfl_down_sync(FULL, acc[c], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 6; ++c)
      p.out[(size_t)face * 6 + c] = acc[c] / p.multiplier;
  }
}

dim3 pixel_grid(int B, int H, int W) {
  return dim3((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
}

}  // namespace

extern "C" {

// mask (B, H, W); cut (B, H, W) int32, written when not null.
int soft_mask_forward(const float* img, const float* bbox,
                      const int32_t* face_idx, float* mask, int32_t* cut,
                      int B, int F, int H, int W, int row_start,
                      int total_height, int knum, float sx, float sy,
                      float sigmainv, float multiplier, float bad,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  Params p{img, bbox, face_idx, nullptr, nullptr, cut, mask,
           B, F, H, W, row_start, total_height, knum,
           sx, sy, sigmainv, multiplier, bad};
  soft_mask_kernel<<<pixel_grid(B, H, W), dim3(TILE, TILE), 0,
                     (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// grad_img (B, F, 6), the gradient of the UNSCALED image verts, every entry
// written; cut (B, H, W) from the forward.
int soft_mask_backward(const float* img, const float* bbox,
                       const int32_t* cut, const float* mask,
                       const float* grad, float* grad_img, int B, int F,
                       int H, int W, int row_start, int total_height,
                       float sx, float sy, float sigmainv, float multiplier,
                       float bad, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || F == 0) return (int)cudaGetLastError();
  Params p{img, bbox, nullptr, mask, grad, const_cast<int32_t*>(cut),
           grad_img, B, F, H, W, row_start, total_height, 0,
           sx, sy, sigmainv, multiplier, bad};
  const int blocks = (B * F + BWD_WARPS - 1) / BWD_WARPS;
  soft_mask_bwd_kernel<<<blocks, BWD_WARPS * 32, 0, (cudaStream_t)stream>>>(
      p);
  return (int)cudaGetLastError();
}

}  // extern "C"
