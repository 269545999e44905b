// Backward of z-buffer rasterization: a warp a face, over the pixels the
// face owns.
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
// What bounds it on an H100: bytes. Each covered pixel is read once (face
// index, weights, D gradients: 16 + 4D bytes) and each face writes
// 6 + 3D floats; the arithmetic is about 94 + 12D operations per covered
// pixel. The sums run over pixels and land on faces, and blocks run in no
// order, so the kernel stays face-major: no atomics, every launch gives
// the same bits. The time goes to finding each face's pixels, not to
// them: a face's rectangle holds about 100 pixels at config 2, of which it
// owns about 22, and half the faces face away and own none.
//
// The design. A warp takes one face at a time:
// - a face the forward culled (valid, when given) owns no pixel: zeros,
//   and no read of the image;
// - else the warp reads the face index over the pixel rectangle of the
//   face's bbox (padded by one pixel against the rounding of the bbox to
//   pixel indices, clipped to the slab's rows), AHEAD steps of 32 pixels a
//   batch with the lanes along the rows, the next batch's loads in flight
//   while it takes this one. The pixels the face owns (a ballot) go, in
//   the walk's order, into the warp's list in shared memory; every 32
//   listed pixels are a chunk:
//   - lane j takes the chunk's pixel j: its weights, and in the first walk
//     its 6 image-gradient terms, which need all D channels of its
//     gradient; the lane adds them to its own 6 sums;
//   - then the feature gradients sum_j w_i[j] * g_d[j]: the lanes split
//     into 32 / DL groups of DL lanes (DL, the least power of two >= D, at
//     most 32); lane (group jg, lane dl of it) adds the chunk's pixels jg,
//     jg + 32 / DL, ... for channels dl + DL * q, so the lanes of a group
//     read a pixel's channels side by side, coalesced.
//   A walk covers DC = 64 channels, so D <= 64 (D = 40 too) takes one
//   walk. At the face's end fixed shuffle trees add the groups and the
//   lanes; a face that owns no pixel writes zeros and pays no tree.
// - A face of more than BIG_PIX pixels is queued for the whole block: after
//   every warp is done, the block takes its queues in order, the warps the
//   batches in turn, and adds the warps' sums in warp order (a warp whose
//   queue of BIG_QUEUE is full takes the face alone).
// With PERSIST or more faces a warp, the grid is persistent (as many blocks
// as the card holds at once, each warp taking faces warp, warp + the
// grid's warps, ...), and the next face's verts are loaded while the warp
// works on a face: at config 2 (163,840 faces) a face is a few hundred
// cycles of work behind a chain of dependent loads, and a block of 8 faces
// cost more in launches than in work. With fewer faces, a warp a face.
//
// Arithmetic follows the plain PyTorch version
// (kaolin_tpu_torch/kernels/rasterize_bwd.py) per pixel: --fmad=false,
// IEEE division, copysignf for the signed-eps guard. Only the order of the
// per-face sums differs.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int WARPS = 8;                  // faces per block
constexpr int BLOCKS = 2;                 // blocks an SM holds: <= 128 regs
constexpr int LIST = 64;                  // listed pixels a warp holds
constexpr int DC = 64;                    // feature channels per walk
constexpr int NQ = DC / 32;               // channels a lane sums per walk
constexpr int AHEAD = 2;                  // steps of index loads in flight
// a face whose rectangle holds more pixels waits for all the block's
// warps, up to BIG_QUEUE a warp
constexpr int BIG_PIX = 32 * AHEAD * WARPS;
constexpr int BIG_QUEUE = 32;
constexpr int PERSIST = 8;                // faces a warp, for the persistent grid
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const float* grad;     // (B, H, W, D) cotangent of the features
  const int32_t* idx;    // (B, H, W) winner face, -1 where uncovered
  const float* weights;  // (B, H, W, 3)
  const float* img;      // (B, F, 6) UNSCALED image verts
  const float* feat;     // (B, F, 3*D) vertex-major
  const uint8_t* valid;  // (B, F) the forward's culling, or null: all
  float* grad_img;       // (B, F, 6)
  float* grad_feat;      // (B, F, 3*D)
  int B, F, H, W, D, row_start, total_height;
  int dl_log;            // log2 of DL
  float eps;
};

struct WarpList {
  int pix[LIST];         // owned pixels, in the walk's order
  float w[32][3];        // the chunk's weights
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

// A face: its verts and features, its pixel rectangle, and the sums its
// lanes carry.
struct Face {
  int b, f;
  float ax, ay, bx, by, cx, cy;
  const float* fv;
  int r0, c0, nc, npix;
  float gi[6];
  float acc[3][NQ];
};

__device__ __forceinline__ void load_verts(const Params& p, int face,
                                           float* v, bool* valid) {
  for (int j = 0; j < 6; ++j) v[j] = p.img[(size_t)face * 6 + j];
  *valid = p.valid == nullptr || p.valid[face] != 0;
}

// The face from its verts: its features and its pixel rectangle.
__device__ __forceinline__ void load_face(const Params& p, int face,
                                          const float* v, Face& s) {
  s.b = face / p.F;
  s.f = face - s.b * p.F;
  s.ax = v[0]; s.ay = v[1]; s.bx = v[2]; s.by = v[3]; s.cx = v[4];
  s.cy = v[5];
  s.fv = p.feat + (size_t)face * 3 * p.D;
  // the bbox's pixel rectangle; rows count down in y
  float lo, hi;
  centre_span(fminf(fminf(s.ax, s.bx), s.cx), fmaxf(fmaxf(s.ax, s.bx), s.cx),
              p.W, &lo, &hi);
  const int c0 = clamp_index(lo, 0, p.W), c1 = clamp_index(hi, -1, p.W - 1);
  centre_span(-fmaxf(fmaxf(s.ay, s.by), s.cy), -fminf(fminf(s.ay, s.by), s.cy),
              p.total_height, &lo, &hi);
  const int r0 = clamp_index(lo - (float)p.row_start, 0, p.H);
  const int r1 = clamp_index(hi - (float)p.row_start, -1, p.H - 1);
  s.r0 = r0;
  s.c0 = c0;
  s.nc = c1 >= c0 ? c1 - c0 + 1 : 0;
  s.npix = r1 >= r0 ? s.nc * (r1 - r0 + 1) : 0;
  for (int c = 0; c < 6; ++c) s.gi[c] = 0.f;
}

// Chunk of n <= 32 listed pixels for the channels [ch0, ch1).
__device__ __forceinline__ void chunk(const Params& p, WarpList& L, Face& s,
                                      int n, int ch0, int ch1, int lane) {
  const int D = p.D;
  __syncwarp();
  if (lane < n) {
    const size_t pix = (size_t)L.pix[lane];
    const float* w = p.weights + pix * 3;
    const float aw = w[0], bw = w[1], cw = w[2];
    L.w[lane][0] = aw;
    L.w[lane][1] = bw;
    L.w[lane][2] = cw;
    if (ch0 == 0) {
      const float* g = p.grad + pix * D;
      const float ax = s.ax, ay = s.ay, bx = s.bx, by = s.by, cx = s.cx,
                  cy = s.cy;
      const float x0 = aw * ax + bw * bx + cw * cx;
      const float y0 = aw * ay + bw * by + cw * cy;
      const float m = bx - ax, pp = by - ay, n_ = cx - ax, q = cy - ay;
      const float sx = x0 - ax, t = y0 - ay;
      const float k1 = sx * q - n_ * t;
      const float k2 = m * t - sx * pp;
      float k3 = m * q - n_ * pp;
      k3 = k3 + copysignf(p.eps, k3);
      // dk1/d{m,n,p,q,s,t} = 0, -t, 0, s, q, -n; dk2/d{..} = t, 0, -s,
      // 0, -p, m; dk3/d{m,n,p,q} = q, -p, -n, m
      const float dw1dm = 0.f * k3 - q * k1;
      const float dw1dn = -t * k3 - -pp * k1;
      const float dw1dp = 0.f * k3 - -n_ * k1;
      const float dw1dq = sx * k3 - m * k1;
      const float dw1ds = q * k3;
      const float dw1dt = -n_ * k3;
      const float dw2dm = t * k3 - q * k2;
      const float dw2dn = 0.f * k3 - -pp * k2;
      const float dw2dp = -sx * k3 - -n_ * k2;
      const float dw2dq = 0.f * k3 - m * k2;
      const float dw2ds = -pp * k3;
      const float dw2dt = m * k3;
      const float dw1dax = -(dw1dm + dw1dn + dw1ds);
      const float dw1day = -(dw1dp + dw1dq + dw1dt);
      const float dw2dax = -(dw2dm + dw2dn + dw2ds);
      const float dw2day = -(dw2dp + dw2dq + dw2dt);

      const float* fv = s.fv;
      float s1 = 0.f, s2 = 0.f;
      for (int d = 0; d < D; ++d) {
        s1 += g[d] * (fv[D + d] - fv[d]);
        s2 += g[d] * (fv[2 * D + d] - fv[d]);
      }
      const float g1 = s1 / (k3 * k3), g2 = s2 / (k3 * k3);
      s.gi[0] += g1 * dw1dax + g2 * dw2dax;
      s.gi[1] += g1 * dw1day + g2 * dw2day;
      s.gi[2] += g1 * dw1dm + g2 * dw2dm;
      s.gi[3] += g1 * dw1dp + g2 * dw2dp;
      s.gi[4] += g1 * dw1dn + g2 * dw2dn;
      s.gi[5] += g1 * dw1dq + g2 * dw2dq;
    }
  }
  __syncwarp();
  const int DL = 1 << p.dl_log;
#pragma unroll 2
  for (int j = lane >> p.dl_log; j < n; j += 32 >> p.dl_log) {
    const float* g = p.grad + (size_t)L.pix[j] * D;
    const float w0 = L.w[j][0], w1 = L.w[j][1], w2 = L.w[j][2];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int d = ch0 + (lane & (DL - 1)) + q * DL;
      if (d < ch1) {
        const float gd = g[d];
        s.acc[0][q] += w0 * gd;
        s.acc[1][q] += w1 * gd;
        s.acc[2][q] += w2 * gd;
      }
    }
  }
  __syncwarp();
}

// Loads the face indices of batch k0 (AHEAD steps of 32 pixels of the
// face's rectangle, row-major, the lanes along the rows): the pixels and
// their indices, -1 past the rectangle.
__device__ __forceinline__ void fetch(const Params& p, const Face& s, int k0,
                                      int lane, int* pix, int* val) {
  // a step of 32 pixels moves a lane by 32 / nc rows and 32 % nc columns
  const int nc = s.nc, step_r = 32 / nc, step_c = 32 % nc;
  int row = (k0 + lane) / nc, col = k0 + lane - row * nc;
#pragma unroll
  for (int a = 0; a < AHEAD; ++a) {
    const bool inside = k0 + a * 32 + lane < s.npix;
    pix[a] = inside ? (s.b * p.H + s.r0 + row) * p.W + s.c0 + col : 0;
    val[a] = inside ? p.idx[pix[a]] : -1;
    col += step_c;
    row += step_r;
    if (col >= nc) {
      col -= nc;
      ++row;
    }
  }
}

// Walks batches first, first + stride, ... of the face's rectangle for the
// channels [ch0, ch1), the next batch's loads in flight while it takes
// this one: lists the pixels the face owns and takes them 32 at a time.
// Zeroes the feature sums first; returns how many pixels it listed.
__device__ __forceinline__ int walk(const Params& p, WarpList& L, Face& s,
                                    int ch0, int ch1, int first, int stride,
                                    int lane) {
  for (int i = 0; i < 3; ++i)
    for (int q = 0; q < NQ; ++q) s.acc[i][q] = 0.f;
  const int step = stride * 32 * AHEAD;
  int count = 0, total = 0;
  int pix[AHEAD], val[AHEAD];
  int k0 = first * 32 * AHEAD;
  if (k0 < s.npix) fetch(p, s, k0, lane, pix, val);
  for (; k0 < s.npix; k0 += step) {
    bool own[AHEAD];
    int cur[AHEAD];
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      own[a] = val[a] == s.f;
      cur[a] = pix[a];
    }
    if (k0 + step < s.npix) fetch(p, s, k0 + step, lane, pix, val);
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      const unsigned ballot = __ballot_sync(FULL, own[a]);
      if (own[a]) L.pix[count + __popc(ballot & ((1u << lane) - 1u))] = cur[a];
      count += __popc(ballot);
      total += __popc(ballot);
      if (count >= 32) {
        chunk(p, L, s, 32, ch0, ch1, lane);
        const int rest = count - 32;
        const int moved = lane < rest ? L.pix[32 + lane] : 0;
        __syncwarp();
        if (lane < rest) L.pix[lane] = moved;
        count = rest;
      }
    }
  }
  if (count > 0) chunk(p, L, s, count, ch0, ch1, lane);
  return total;
}

// Adds the lane groups of each channel: lanes 0 .. DL - 1 hold the sums.
__device__ __forceinline__ void add_groups(const Params& p, Face& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < (1 << p.dl_log)) break;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        s.acc[i][q] += __shfl_down_sync(FULL, s.acc[i][q], off);
  }
}

// Persistent: each warp takes faces warp, warp + the grid's warps, ...,
// the next face's verts loaded while it works on the current one. A face
// of more than BIG_PIX pixels is queued for the whole block, which takes
// the queues after every warp is done, batch by batch in turn, and adds
// the warps' sums in warp order.
__global__ void __launch_bounds__(WARPS * 32, BLOCKS)
rasterize_bwd_kernel(Params p) {
  __shared__ WarpList lists[WARPS];
  __shared__ float part[WARPS][6 + 3 * DC];
  __shared__ int queue[WARPS][BIG_QUEUE];
  __shared__ int queued[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpList& L = lists[warp];
  const int D = p.D, D3 = 3 * p.D, DL = 1 << p.dl_log;
  const int faces = p.B * p.F, stride = gridDim.x * WARPS;
  int nq = 0;
  int face = blockIdx.x * WARPS + warp;
  float next[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool next_valid = true;
  if (face < faces) load_verts(p, face, next, &next_valid);
  for (; face < faces; face += stride) {
    Face s;
    load_face(p, face, next, s);
    const bool culled = !next_valid;
    if (face + stride < faces) load_verts(p, face + stride, next, &next_valid);
    if (culled) {
      // culled in the forward: it owns no pixel
      for (int k = lane; k < D3; k += 32)
        p.grad_feat[(size_t)face * D3 + k] = 0.f;
      if (lane < 6) p.grad_img[(size_t)face * 6 + lane] = 0.f;
      continue;
    }
    if (s.npix > BIG_PIX && nq < BIG_QUEUE) {
      if (lane == 0) queue[warp][nq] = face;
      ++nq;
      continue;
    }
    bool owns = false;
    for (int ch0 = 0; ch0 == 0 || ch0 < D; ch0 += DC) {
      const int ch1 = min(D, ch0 + DC);
      owns = walk(p, L, s, ch0, ch1, 0, 1, lane) > 0 || owns;
      if (!owns) break;
      add_groups(p, s);
      if (lane < DL) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int d = ch0 + lane + q * DL;
          if (d < ch1) {
#pragma unroll
            for (int i = 0; i < 3; ++i)
              p.grad_feat[(size_t)face * D3 + i * D + d] = s.acc[i][q];
          }
        }
      }
    }
    if (owns) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const float sum = warp_sum(s.gi[c]);
        if (lane == 0) p.grad_img[(size_t)face * 6 + c] = sum;
      }
    } else {
      for (int k = lane; k < D3; k += 32)
        p.grad_feat[(size_t)face * D3 + k] = 0.f;
      if (lane < 6) p.grad_img[(size_t)face * 6 + lane] = 0.f;
    }
  }
  if (lane == 0) queued[warp] = nq;
  __syncthreads();

  for (int w = 0; w < WARPS; ++w) {
    for (int k = 0; k < queued[w]; ++k) {
      const size_t f = queue[w][k];
      float v[6];
      bool valid;
      load_verts(p, (int)f, v, &valid);
      Face t;
      load_face(p, (int)f, v, t);
      for (int ch0 = 0; ch0 == 0 || ch0 < D; ch0 += DC) {
        const int ch1 = min(D, ch0 + DC);
        walk(p, L, t, ch0, ch1, warp, WARPS, lane);
        add_groups(p, t);
        if (lane < DL) {
#pragma unroll
          for (int q = 0; q < NQ; ++q)
#pragma unroll
            for (int i = 0; i < 3; ++i)
              part[warp][6 + i * DC + lane + q * DL] = t.acc[i][q];
        }
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const float sum = warp_sum(t.gi[c]);
          if (lane == 0) part[warp][c] = sum;
        }
        __syncthreads();
        const int e = threadIdx.x;
        if (e < 6 && ch0 == 0) {
          float sum = 0.f;
          for (int i = 0; i < WARPS; ++i) sum += part[i][e];
          p.grad_img[f * 6 + e] = sum;
        } else if (e >= 6 && e < 6 + 3 * DC) {
          const int i = (e - 6) / DC, d = ch0 + (e - 6) % DC;
          if (d < ch1) {
            float sum = 0.f;
            for (int j = 0; j < WARPS; ++j) sum += part[j][e];
            p.grad_feat[f * D3 + i * D + d] = sum;
          }
        }
        __syncthreads();
      }
    }
  }
}

}  // namespace

extern "C" {

// grad_img (B,F,6) and grad_feat (B,F,3*D), every entry written; valid
// (B,F), the forward's culling (a culled face owns no pixel), or null.
int rasterize_backward(const float* grad, const int32_t* idx,
                       const float* weights, const float* img,
                       const float* feat, const uint8_t* valid,
                       float* grad_img, float* grad_feat,
                       int B, int F, int H, int W, int D, int row_start,
                       int total_height, float eps, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || F == 0) return (int)cudaGetLastError();
  // listed pixels are int offsets
  if ((long long)B * H * W > INT_MAX) return (int)cudaErrorInvalidValue;
  int dl_log = 0;
  while ((1 << dl_log) < D && dl_log < 5) ++dl_log;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  Params p{grad, idx, weights, img, feat, valid, grad_img, grad_feat,
           B, F, H, W, D, row_start, total_height, dl_log, eps};
  // persistent (as many blocks as the card holds at once) when each warp
  // gets PERSIST faces or more; else a warp a face
  const long long faces = (long long)B * F, resident = (long long)sms * BLOCKS;
  const int blocks = (int)(faces >= resident * WARPS * PERSIST
                               ? resident
                               : (faces + WARPS - 1) / WARPS);
  rasterize_bwd_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
