// Backward of z-buffer rasterization, one warp per face.
//
// Replaces the TPU kernel kaolin_tpu/kernels/rasterize_bwd.py
// rasterize_backward_pallas. Per covered pixel, the winner face gets the
// gradient of its interpolated features with respect to its 6 image
// coordinates (the closed-form Cramer derivative of the barycentric
// weights, chained with the feature deltas) and w_i * g_d for its
// features. These are the formulas of the JAX package's XLA backward
// (kaolin_tpu/render/mesh/rasterization.py _rasterize_bwd), operation for
// operation; the Pallas kernel's k1 = bw*k3 rewrite is not carried over.
// Any feature width D is taken.
//
// The sums run over pixels and land on faces. Blocks run in no order, so
// the kernel is face-major: one warp per (batch, face) walks the pixel
// rectangle of the face's bbox, padded by one pixel on each side (against
// rounding of the bbox to pixel indices) and clipped to the slab's rows,
// and keeps the pixels whose face index is this face. Each lane sums the
// terms of its own pixels in registers (the 6 image gradients, and the
// feature gradients CH channels per walk of the rectangle), and a shuffle
// tree adds the lanes in a fixed order. No atomics, no zero-fill pass:
// every launch gives the same bits.
//
// What bounds it on an H100: bytes. Each covered pixel is read once
// (face index, weights, D gradients: 16 + 4D bytes) by the warp of its
// face, and each face writes 6 + 3D floats; the arithmetic is about
// 94 + 12D operations per covered pixel. The bbox rectangle costs one read
// of the face index per pixel of the rectangle and walk (one walk per CH
// channels); a face that covers much of the image makes its one warp walk
// many pixels (binning is later work).
//
// Arithmetic follows the plain PyTorch version
// (kaolin_tpu_torch/kernels/rasterize_bwd.py) per pixel: --fmad=false,
// IEEE division, copysignf for the signed-eps guard. Only the order of the
// per-face sums differs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                  // faces per block
constexpr int CH = 8;                     // feature channels per walk
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* grad;     // (B, H, W, D) cotangent of the features
  const int32_t* idx;    // (B, H, W) winner face, -1 where uncovered
  const float* weights;  // (B, H, W, 3)
  const float* img;      // (B, F, 6) UNSCALED image verts
  const float* feat;     // (B, F, 3*D) vertex-major
  float* grad_img;       // (B, F, 6)
  float* grad_feat;      // (B, F, 3*D)
  int B, F, H, W, D, row_start, total_height;
  float eps;
};

// Indices i whose centre (2i + 1 - n) / n can lie in [v0, v1), padded by
// one on each side; unclipped.
__device__ __forceinline__ void centre_span(float v0, float v1, int n,
                                            float* lo, float* hi) {
  *lo = floorf((v0 * (float)n + (float)(n - 1)) * 0.5f) - 1.f;
  *hi = ceilf((v1 * (float)n + (float)(n - 1)) * 0.5f) + 1.f;
}

__device__ __forceinline__ int clamp_index(float v, int lo, int hi) {
  return (int)fminf(fmaxf(v, (float)lo), (float)hi);
}

// Sum over the warp's lanes, in a fixed order; lane 0 holds it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

__global__ void __launch_bounds__(WARPS * 32)
rasterize_bwd_kernel(Params p) {
  const int lane = threadIdx.x & 31;
  const int face = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (face >= p.B * p.F) return;          // the whole warp leaves together
  const int b = face / p.F, f = face - b * p.F;
  const int D = p.D, D3 = 3 * p.D;

  const float* v = p.img + (size_t)face * 6;
  const float ax = v[0], ay = v[1], bx = v[2], by = v[3], cx = v[4],
              cy = v[5];
  const float* fv = p.feat + (size_t)face * D3;

  // the face's pixel rectangle; rows count down in y
  float lo, hi;
  centre_span(fminf(fminf(ax, bx), cx), fmaxf(fmaxf(ax, bx), cx), p.W, &lo,
              &hi);
  const int c0 = clamp_index(lo, 0, p.W), c1 = clamp_index(hi, -1, p.W - 1);
  centre_span(-fmaxf(fmaxf(ay, by), cy), -fminf(fminf(ay, by), cy),
              p.total_height, &lo, &hi);
  const int r0 = clamp_index(lo - (float)p.row_start, 0, p.H);
  const int r1 = clamp_index(hi - (float)p.row_start, -1, p.H - 1);
  const int nc = c1 >= c0 ? c1 - c0 + 1 : 0;
  const int npix = r1 >= r0 ? nc * (r1 - r0 + 1) : 0;

  float gi[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // channels ch0 .. ch0 + CH - 1 of the feature gradients per walk of the
  // rectangle; the image gradients come with the first walk
  for (int ch0 = 0; ch0 == 0 || ch0 < D; ch0 += CH) {
    float acc[3][CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[0][c] = acc[1][c] = acc[2][c] = 0.f;

    for (int k = lane; k < npix; k += 32) {
      const size_t pix = ((size_t)b * p.H + r0 + k / nc) * p.W + c0 + k % nc;
      if (p.idx[pix] != f) continue;
      const float* w = p.weights + pix * 3;
      const float aw = w[0], bw = w[1], cw = w[2];
      const float* g = p.grad + pix * D;

      if (ch0 == 0) {
        const float x0 = aw * ax + bw * bx + cw * cx;
        const float y0 = aw * ay + bw * by + cw * cy;
        const float m = bx - ax, pp = by - ay, n = cx - ax, q = cy - ay;
        const float s = x0 - ax, t = y0 - ay;
        const float k1 = s * q - n * t;
        const float k2 = m * t - s * pp;
        float k3 = m * q - n * pp;
        k3 = k3 + copysignf(p.eps, k3);
        // dk1/d{m,n,p,q,s,t} = 0, -t, 0, s, q, -n; dk2/d{..} = t, 0, -s,
        // 0, -p, m; dk3/d{m,n,p,q} = q, -p, -n, m
        const float dw1dm = 0.f * k3 - q * k1;
        const float dw1dn = -t * k3 - -pp * k1;
        const float dw1dp = 0.f * k3 - -n * k1;
        const float dw1dq = s * k3 - m * k1;
        const float dw1ds = q * k3;
        const float dw1dt = -n * k3;
        const float dw2dm = t * k3 - q * k2;
        const float dw2dn = 0.f * k3 - -pp * k2;
        const float dw2dp = -s * k3 - -n * k2;
        const float dw2dq = 0.f * k3 - m * k2;
        const float dw2ds = -pp * k3;
        const float dw2dt = m * k3;
        const float dw1dax = -(dw1dm + dw1dn + dw1ds);
        const float dw1day = -(dw1dp + dw1dq + dw1dt);
        const float dw2dax = -(dw2dm + dw2dn + dw2ds);
        const float dw2day = -(dw2dp + dw2dq + dw2dt);

        float s1 = 0.f, s2 = 0.f;
        for (int d = 0; d < D; ++d) {
          s1 += g[d] * (fv[D + d] - fv[d]);
          s2 += g[d] * (fv[2 * D + d] - fv[d]);
        }
        const float g1 = s1 / (k3 * k3), g2 = s2 / (k3 * k3);
        gi[0] += g1 * dw1dax + g2 * dw2dax;
        gi[1] += g1 * dw1day + g2 * dw2day;
        gi[2] += g1 * dw1dm + g2 * dw2dm;
        gi[3] += g1 * dw1dp + g2 * dw2dp;
        gi[4] += g1 * dw1dn + g2 * dw2dn;
        gi[5] += g1 * dw1dq + g2 * dw2dq;
      }

#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (ch0 + c < D) {
          const float gd = g[ch0 + c];
          acc[0][c] += aw * gd;
          acc[1][c] += bw * gd;
          acc[2][c] += cw * gd;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float sum = warp_sum(acc[i][c]);
        if (lane == 0 && ch0 + c < D)
          p.grad_feat[(size_t)face * D3 + i * D + ch0 + c] = sum;
      }
    }
  }

#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float sum = warp_sum(gi[c]);
    if (lane == 0) p.grad_img[(size_t)face * 6 + c] = sum;
  }
}

}  // namespace

extern "C" {

// grad_img (B,F,6) and grad_feat (B,F,3*D), every entry written.
int rasterize_backward(const float* grad, const int32_t* idx,
                       const float* weights, const float* img,
                       const float* feat, float* grad_img, float* grad_feat,
                       int B, int F, int H, int W, int D, int row_start,
                       int total_height, float eps, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || F == 0) return (int)cudaGetLastError();
  Params p{grad, idx, weights, img, feat, grad_img, grad_feat,
           B, F, H, W, D, row_start, total_height, eps};
  const int blocks = (B * F + WARPS - 1) / WARPS;
  rasterize_bwd_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
