// Bilinear / nearest texture sampling with border padding, forward and
// backward.
//
// Replaces the TPU kernels kaolin_tpu/kernels/texture.py grid_sample_pallas
// (forward) and _grid_sample_bwd_pallas (backward). Those build one-hot
// weight matrices and sample with MXU products, because the TPU has no
// gather; the backward accumulates the texture gradient in VMEM over the
// points in grid order, so its sum is deterministic. The H100 has a
// gather, so the forward and the coordinate gradients follow the JAX
// package's XLA gather path (kaolin_tpu/render/mesh/utils.py
// grid_sample_2d): the four taps (x0, y0), (x1, y0), (x0, y1), (x1, y1)
// with c0 = floor(c), c1 = min(c0 + 1, size - 1), w = c - floor(c), and
//   v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx
// in that order; nearest mode takes the texel at rintf(c) (half to even,
// as jnp.round and torch.round). Any texture size is taken; the Pallas
// kernel takes at most 128 x 128.
//
// The coordinates come in one of two modes, fixed at compile time by the
// entry point (Coords):
//   Sampler (grid_sample_forward, grid_sample_backward): arrays ix, iy
//     (B, P), the sampler's coordinates, unnormalised and already clipped
//     to [0, size - 1] by the caller;
//   Uv (grid_sample_uv_forward, grid_sample_uv_backward): OpenGL UVs, u at
//     uv[b * sb + p * sp] and v beside it, which every kernel that reads a
//     point converts in its own thread (uv_to_sampler) with the operations
//     of texture_mapping's PyTorch composition (render/mesh/utils.py
//     _uv_coords and _sampler_coords), in their order:
//       u' = clip(u, 0, 1) * 2 - 1,     v' = (clip(v, 0, 1) * 2 - 1) * -1,
//       ix = clip(((u' + 1) * W - 1) / 2, 0, W - 1), iy the same of v' and H,
//     clip(x, lo, hi) = min(max(x, lo), hi) as torch.maximum and
//     torch.minimum take it on the card (a NaN x stays NaN). No coordinate
//     array is stored. The backward writes the UVs' gradient duv (B, P, 2)
//     in place of dix and diy: each point's thread takes dix, diy through
//     the composition's backward in autograd's order (uv_vjp): the axis
//     clip (the min's factor, then the max's), / 2, * W (or * H), for v
//     * -1, the sum of the two selects' gradients (+ 0), * 2, then the UV
//     clip (the min's factor, then the max's), where a factor is 1, 1/2 at
//     a tie with the other bound and 0 elsewhere (a NaN x equals nothing),
//     as _balanced gives it, so a NaN or infinite cotangent stays NaN where
//     a factor is 0. The samples, dmaps and duv are therefore the
//     composition's bits (grid_sample_coords on _uv_coords): same
//     operations, same order, no contraction.
// The tap indices are clamped to the texture as well, which changes
// nothing on the sampler's coordinates and keeps every read and write
// inside the buffers whatever the caller passes.
//
// Forward: the texture arrives planar, (B, C, H, W), so a tap's C channels
// lie a plane apart and a bilinear point would make 4 x C scattered
// 4-byte reads. A first kernel therefore interleaves the texture into a
// (B, H, W, C4) copy, C4 = C rounded up to a multiple of 4 and the
// padding zeroed, one thread per texel (planar reads and 16-byte writes,
// both coalesced). The sampler then reads each tap's channels as C4 / 4
// 16-byte loads: 4 loads a point at C = 3 instead of 12. No hardware
// texture filtering: its 8-bit fixed-point weights would break the
// bit-equality below. The autograd function keeps the copy for the
// backward.
//
// Backward: the coordinate gradients, per point,
//   dix = sum_c g_c * ((v01 - v00)*(1-wy) + (v11 - v10)*wy)
//   diy = sum_c g_c * ((v10 - v00)*(1-wx) + (v11 - v01)*wx)
// summed over channels in order by the point's own thread from the
// interleaved copy (exactly 0 in nearest mode), and the texture gradient,
// a scatter of g_c times each tap's weight. What bounds the scatter on an
// H100 is not bytes but where the terms land: on the DIB-R textured step
// the points of a face sample a small patch of the texture, and under a
// cotangent that is nonzero off the mesh every uncovered pixel samples
// UV 0, about 117,000 terms a batch element on one texel. Atomic adds
// serialise there (1.52 ms a call at config 2) and their order changes
// from launch to launch, so the sum was not bit-stable. The reduction
// here has no float atomics and a fixed order:
//   1. gs_bwd_point_kernel, a thread a point: dix and diy, and a record
//      of the 32 x 32 texel tiles the point's taps touch (1, 2 or 4), or
//      none where its cotangent is 0 in every channel (such a point adds
//      nothing and leaves the work); the warp's lanes that count into one
//      (tile, chunk of PW points) entry of a table are found with
//      __match_any_sync, and the lowest adds their number (an integer
//      atomic: exact in any order);
//   2. gs_bwd_scan_kernel, a block a tile: the exclusive scan of the table
//      in (tile, chunk) order by decoupled look-back (lookback.cuh), which
//      gives each tile a list and each (tile, chunk) its cursor; a list is
//      cut into chunks (plan_tile: at most LIST_CHUNK entries a chunk,
//      as many as the tile's share of the partial tiles' slots allows),
//      and gs_bwd_plan_kernel records each tile's chunks and each slot's
//      owner;
//   3. gs_bwd_place_kernel, a warp a chunk: step by step (32 points), and
//      by the rank of the tile among each point's tiles, the lanes that
//      list one tile take a run of entries at its cursor in lane order;
//      so a list is in the fixed order (step, rank, lane) of its points;
//   4. gs_bwd_sum_kernel, a block a (tile, list chunk): SUM_WARPS warps,
//      each with its own copy of the tile in shared memory, take the
//      chunk's entries 32 at a time, warp w the steps w, w + SUM_WARPS,
//      ...; for each tap the lanes that add into one texel are combined
//      by the lowest of them in lane order (all 32: by an xor butterfly),
//      which adds the sum into its warp's copy; the copies are added in
//      warp order. A tile of one chunk writes its texels of dtex;
//      otherwise each chunk writes a partial tile and the last chunk to
//      finish (an integer counter) adds the partials in chunk order.
//      Every texel of dtex is written once, so it needs no zeroing.
// Every sum therefore has one order, fixed by the inputs: dtex is the same
// bits at every launch. The buffers are sized from the shapes (a point in
// at most 4 lists), so no count is read back to the host.
//
// What bounds it on an H100: bytes and latency. The forward reads ix, iy
// (8 bytes per point; in Uv mode the UVs, 8 bytes at a stride of sp
// floats), writes C floats per point and reads the texture once (it fits
// in the 50 MB L2), plus the copy's write and read. The backward reads the
// coordinates and the cotangent twice (steps 1 and 4, L2-resident at
// config 2) and the copy's taps once, writes dix, diy (duv) and dtex once,
// and 4 bytes a point (its record) and a (tile, point) entry;
// the sum's steps are chains of dependent loads (the list, then the
// point), so each warp loads the list two steps ahead. The arithmetic is
// under 30 operations per point and channel.
//
// Arithmetic follows the plain PyTorch version
// (kaolin_tpu_torch/kernels/texture.py) operation for operation:
// --fmad=false, the same products in the same order, so the forward and
// dix/diy agree with it bit for bit, and each term g_c * w1 * w2 of dtex
// is the plain version's term.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
// points per thread of the sampler; 1, 2 and 4 took the same time within
// 5% at config 2's step on the H100 (PERF.md)
constexpr int PTS = 2;
// the backward's texel tiles, TILE x TILE texels
constexpr int TILE = 32;
constexpr int TILE_TEXELS = TILE * TILE;
// list entries a block of gs_bwd_sum_kernel sums: a longer list (a hot
// tile) is cut into chunks summed by separate blocks
constexpr int LIST_CHUNK = 4096;
// warps of gs_bwd_sum_kernel, each with its own copy of the tile, and the
// channels a copy holds at once
constexpr int SUM_WARPS = 8;
constexpr int SUM_CG = 3;
// slots of partial tiles (make_layout): SLOTS_PER_TILE a tile and
// SLOTS_EXTRA, at most SLOTS_MAX
constexpr int SLOTS_PER_TILE = 2;
constexpr int SLOTS_EXTRA = 512;
constexpr int SLOTS_MAX = 4096;
constexpr unsigned FULL = 0xffffffffu;

// Where a kernel's points come from (the header's two modes).
enum class Coords { Sampler, Uv };

struct Src {
  const float* ix;  // Sampler: (B, P) each
  const float* iy;
  const float* uv;  // Uv: u of point (b, p) at uv[b * sb + p * sp], v after
  long long sb, sp;
};

// torch.maximum / torch.minimum on the card with a bound that is no NaN:
// a NaN x is returned as it is, else fmaxf / fminf
__device__ __forceinline__ float t_max(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float t_min(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}

// A grid coordinate a in [-1, 1] to the sampler's along an axis of n
// texels, unclipped: ((a + 1) * n - 1) / 2
__device__ __forceinline__ float unnormalise(float a, int n) {
  return ((a + 1.f) * (float)n - 1.f) / 2.f;
}

// OpenGL UVs to the sampler's clipped coordinates (the header's sequence)
__device__ __forceinline__ void uv_to_sampler(float u, float v, int H, int W,
                                              float& x, float& y) {
  const float gu = t_min(t_max(u, 0.f), 1.f) * 2.f - 1.f;
  const float gv = (t_min(t_max(v, 0.f), 1.f) * 2.f - 1.f) * -1.f;
  x = t_min(t_max(unnormalise(gu, W), 0.f), (float)(W - 1));
  y = t_min(t_max(unnormalise(gv, H), 0.f), (float)(H - 1));
}

// The derivative factor of a max or min for its input x (_balanced): 1
// where x gave ans, 1/2 where the other operand equals ans too, else 0
__device__ __forceinline__ float balanced(float x, float ans, float other) {
  return x == ans ? (other == ans ? 0.5f : 1.f) : 0.f;
}

// g through clip(x, lo, hi) = min(max(x, lo), hi): the min's factor, then
// the max's
__device__ __forceinline__ float clip_vjp(float x, float lo, float hi,
                                          float g) {
  const float m = t_max(x, lo), y = t_min(m, hi);
  return (g * balanced(m, y, hi)) * balanced(x, m, lo);
}

// The sampler coordinate's cotangent g along an axis of n texels back to
// the grid coordinate a: the clip, / 2, * n
__device__ __forceinline__ float axis_vjp(float a, int n, float g) {
  return (clip_vjp(unnormalise(a, n), 0.f, (float)(n - 1), g) / 2.f)
         * (float)n;
}

// dix, diy of a point at UVs (u, v) to the UVs' gradient (the header's
// order)
__device__ __forceinline__ void uv_vjp(float u, float v, int H, int W,
                                       float gx, float gy, float& du,
                                       float& dv) {
  const float gu = t_min(t_max(u, 0.f), 1.f) * 2.f - 1.f;
  const float gv = (t_min(t_max(v, 0.f), 1.f) * 2.f - 1.f) * -1.f;
  const float eu = axis_vjp(gu, W, gx) + 0.f;
  const float ev = axis_vjp(gv, H, gy) * -1.f + 0.f;
  du = clip_vjp(u, 0.f, 1.f, eu * 2.f);
  dv = clip_vjp(v, 0.f, 1.f, ev * 2.f);
}

// Point i = b * P + p's UVs; i < B * P < 2^29 (the UV route's entry
// points take no more), so b is a 32-bit division
__device__ __forceinline__ const float* uv_at(const Src& s, size_t i,
                                              int P) {
  const unsigned k = (unsigned)i, b = k / (unsigned)P;
  return s.uv + b * s.sb + (k - b * (unsigned)P) * s.sp;
}

// Point i's sampler coordinates, from the arrays or from its UVs (u, v
// too, 0 in Sampler mode); no kernel writes them, so through the read-only
// cache
template <Coords M>
__device__ __forceinline__ void point_coords(const Src& s, size_t i, int P,
                                             int H, int W, float& x,
                                             float& y, float& u, float& v) {
  if constexpr (M == Coords::Sampler) {
    x = __ldg(s.ix + i);
    y = __ldg(s.iy + i);
    u = v = 0.f;
  } else {
    const float* q = uv_at(s, i, P);
    u = __ldg(q);
    v = __ldg(q + 1);
    uv_to_sampler(u, v, H, W, x, y);
  }
}

template <Coords M>
__device__ __forceinline__ void point_coords(const Src& s, size_t i, int P,
                                             int H, int W, float& x,
                                             float& y) {
  float u, v;
  point_coords<M>(s, i, P, H, W, x, y, u, v);
}

struct Taps {
  size_t i00, i01, i10, i11;  // texel offsets y * W + x
  int x0, x1, y0, y1;
  float wx, wy;
};

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__device__ __forceinline__ Taps bilinear_taps(float x, float y, int H,
                                              int W) {
  const float x0f = floorf(x), y0f = floorf(y);
  Taps t;
  t.wx = x - x0f;
  t.wy = y - y0f;
  t.x0 = clamp_int((int)x0f, 0, W - 1);
  t.y0 = clamp_int((int)y0f, 0, H - 1);
  t.x1 = min(t.x0 + 1, W - 1);
  t.y1 = min(t.y0 + 1, H - 1);
  t.i00 = (size_t)t.y0 * W + t.x0;
  t.i01 = (size_t)t.y0 * W + t.x1;
  t.i10 = (size_t)t.y1 * W + t.x0;
  t.i11 = (size_t)t.y1 * W + t.x1;
  return t;
}

__device__ __forceinline__ int nearest_x(float x, int W) {
  return clamp_int((int)rintf(x), 0, W - 1);
}

__device__ __forceinline__ size_t nearest_tap(float x, float y, int H,
                                              int W) {
  return (size_t)clamp_int((int)rintf(y), 0, H - 1) * W + nearest_x(x, W);
}

// maps (B, C, H, W) -> tex (B, H, W, C4), channels past C zeroed; one
// thread per texel
__global__ void __launch_bounds__(THREADS)
interleave_kernel(const float* __restrict__ maps, float4* __restrict__ tex,
                  int B, int C, int HW, int G) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)B * HW) return;
  const size_t b = i / HW, t = i - b * HW;
  const float* m = maps + b * C * HW + t;
  float4* o = tex + i * G;
  for (int g = 0; g < G; ++g) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * g + k;
      v[k] = c < C ? __ldg(m + (size_t)c * HW) : 0.f;
    }
    o[g] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx, in the
// plain version's order
__device__ __forceinline__ float lerp4(float v00, float v01, float v10,
                                       float v11, float ax, float ay,
                                       float wx, float wy) {
  return v00 * ay * ax + v01 * ay * wx + v10 * wy * ax + v11 * wy * wx;
}

__device__ __forceinline__ void store_group(float* o, int g, int C,
                                            float4 r) {
  const float v[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4 && 4 * g + k < C; ++k) o[4 * g + k] = v[k];
}

// tex (B, H, W, C4) interleaved; the points of src (B, P); out (B, P, C).
// A thread samples PTS points THREADS apart, their coordinates loaded
// first, so that more loads are in flight per thread.
template <Coords M>
__global__ void __launch_bounds__(THREADS)
grid_sample_fwd_kernel(const float4* __restrict__ tex, Src src,
                       float* __restrict__ out, int B, int C, int H, int W,
                       int P, int G, int nearest) {
  const size_t first = (size_t)blockIdx.x * THREADS * PTS + threadIdx.x;
  const size_t total = (size_t)B * P;
  float x[PTS], y[PTS];
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    const size_t i = first + (size_t)j * THREADS;
    x[j] = y[j] = 0.f;
    if (i < total) point_coords<M>(src, i, P, H, W, x[j], y[j]);
  }
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    const size_t i = first + (size_t)j * THREADS;
    if (i >= total) break;
    const float4* t4 = tex + (i / P) * H * W * G;
    float* o = out + i * C;
    if (nearest) {
      const float4* k = t4 + nearest_tap(x[j], y[j], H, W) * G;
      for (int g = 0; g < G; ++g) store_group(o, g, C, __ldg(k + g));
      continue;
    }
    const Taps t = bilinear_taps(x[j], y[j], H, W);
    const float ax = 1.f - t.wx, ay = 1.f - t.wy;
    for (int g = 0; g < G; ++g) {
      const float4 v00 = __ldg(t4 + t.i00 * G + g);
      const float4 v01 = __ldg(t4 + t.i01 * G + g);
      const float4 v10 = __ldg(t4 + t.i10 * G + g);
      const float4 v11 = __ldg(t4 + t.i11 * G + g);
      store_group(o, g, C, make_float4(
          lerp4(v00.x, v01.x, v10.x, v11.x, ax, ay, t.wx, t.wy),
          lerp4(v00.y, v01.y, v10.y, v11.y, ax, ay, t.wx, t.wy),
          lerp4(v00.z, v01.z, v10.z, v11.z, ax, ay, t.wx, t.wy),
          lerp4(v00.w, v01.w, v10.w, v11.w, ax, ay, t.wx, t.wy)));
    }
  }
}


// ---------------------------------------------------------------- backward

struct Geo {
  int B, C, H, W, P;
  int TX, T;      // tiles across the texture, tiles a batch element
  int PW, NCH;    // points a chunk (a multiple of 32), chunks an element
  int G;          // float4 groups of a texel in the interleaved copy
  int nearest;
};

// A point's record for the binning: -1 if its cotangent is 0 in every
// channel, else the first tile its taps touch, k0 (bits 0-28), and
// whether they straddle a tile edge in x (bit 30) and in y (bit 29).
constexpr int REC_TILE = (1 << 29) - 1;

// The distinct tiles of a record, ascending: k0, then k1 .. k3 as n says
// (1, 2 or 4; 0 for no record).
struct Keys {
  int k0, k1, k2, k3, n;
};

__device__ __forceinline__ Keys record_keys(int rec, int TX) {
  Keys r;
  if (rec < 0) {
    r.k0 = r.k1 = r.k2 = r.k3 = 0;
    r.n = 0;
    return r;
  }
  const bool sx = (rec >> 30) & 1, sy = (rec >> 29) & 1;
  r.k0 = rec & REC_TILE;
  r.k1 = sx ? r.k0 + 1 : r.k0 + TX;
  r.k2 = r.k0 + TX;
  r.k3 = r.k0 + TX + 1;
  r.n = sx && sy ? 4 : (sx || sy ? 2 : 1);
  return r;
}

// The j-th of a record's tiles (j < n).
__device__ __forceinline__ int key_at(const Keys& k, int j) {
  return j == 0 ? k.k0 : j == 1 ? k.k1 : j == 2 ? k.k2 : k.k3;
}

constexpr int POINT_THREADS = 256;

// Step 1, a thread a point: dix and diy (from the interleaved copy; 0 in
// nearest mode), written to d0 and d1 (Sampler) or taken through uv_vjp to
// the UVs' gradient, written to d0 (B, P, 2) (Uv), the point's record, and
// its tiles counted into the (tile, chunk) table cnt (B, T, NCH), zeroed:
// the lanes that add to one entry are found with __match_any_sync and
// their number added by the lowest of them (integer atomics: the counts
// are exact in any order).
template <Coords M>
__global__ void __launch_bounds__(POINT_THREADS)
gs_bwd_point_kernel(const float4* __restrict__ tex, Src src,
                    const float* __restrict__ cot, float* __restrict__ d0,
                    float* __restrict__ d1, int* __restrict__ rec,
                    int* __restrict__ cnt, Geo g) {
  const size_t i = (size_t)blockIdx.x * POINT_THREADS + threadIdx.x;
  const bool valid = i < (size_t)g.B * g.P;
  int r = -1;
  int entry = 0;    // the point's chunk within the table's rows
  if (valid) {
    const int b = (int)(i / g.P), p = (int)(i - (size_t)b * g.P);
    entry = b * g.T * g.NCH + p / g.PW;
    float x, y, u, v;
    point_coords<M>(src, i, g.P, g.H, g.W, x, y, u, v);
    const float* gp = cot + i * g.C;
    float gx = 0.f, gy = 0.f;
    bool live = false;
    int k0;
    bool sx = false, sy = false;
    if (g.nearest) {
      for (int c = 0; c < g.C; ++c) live |= gp[c] != 0.f;
      const int xn = nearest_x(x, g.W);
      const int yn = clamp_int((int)rintf(y), 0, g.H - 1);
      k0 = (yn / TILE) * g.TX + xn / TILE;
    } else {
      const Taps t = bilinear_taps(x, y, g.H, g.W);
      const float ax = 1.f - t.wx, ay = 1.f - t.wy;
      const float4* t4 = tex + (size_t)b * g.H * g.W * g.G;
      for (int grp = 0; grp < g.G; ++grp) {
        const float4 a = __ldg(t4 + t.i00 * g.G + grp);
        const float4 bq = __ldg(t4 + t.i01 * g.G + grp);
        const float4 cq = __ldg(t4 + t.i10 * g.G + grp);
        const float4 dq = __ldg(t4 + t.i11 * g.G + grp);
        const float v00[4] = {a.x, a.y, a.z, a.w};
        const float v01[4] = {bq.x, bq.y, bq.z, bq.w};
        const float v10[4] = {cq.x, cq.y, cq.z, cq.w};
        const float v11[4] = {dq.x, dq.y, dq.z, dq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * grp + j;
          if (c >= g.C) break;
          const float gc = gp[c];
          live |= gc != 0.f;
          gx += gc * ((v01[j] - v00[j]) * ay + (v11[j] - v10[j]) * t.wy);
          gy += gc * ((v10[j] - v00[j]) * ax + (v11[j] - v01[j]) * t.wx);
        }
      }
      k0 = (t.y0 / TILE) * g.TX + t.x0 / TILE;
      sx = t.x1 / TILE != t.x0 / TILE;
      sy = t.y1 / TILE != t.y0 / TILE;
    }
    if constexpr (M == Coords::Sampler) {
      d0[i] = gx;
      d1[i] = gy;
    } else {
      uv_vjp(u, v, g.H, g.W, gx, gy, d0[2 * i], d0[2 * i + 1]);
    }
    r = live ? k0 | ((int)sx << 30) | ((int)sy << 29) : -1;
    rec[i] = r;
  }
  const Keys k = record_keys(r, g.TX);
  const int rounds = __reduce_max_sync(FULL, k.n);
  for (int j = 0; j < rounds; ++j) {
    const int key = j < k.n ? entry + key_at(k, j) * g.NCH : -1;
    const unsigned grp = __match_any_sync(FULL, key);
    if (key >= 0 && (int)(threadIdx.x & 31) == __ffs(grp) - 1)
      atomicAdd(cnt + key, __popc(grp));
  }
}

constexpr int BIN_THREADS = 256;
// steps of 32 records a warp loads at once
constexpr int REC_ROUND = 4;

// Step 3, a warp a chunk of PW consecutive points of one batch element,
// step by step (32 points), and in a step by the rank of the tile among
// each point's tiles: the lanes that list one tile take a run of entries
// at the (tile, chunk) cursor (cur, scanned), in lane order. A tile's
// list is thus in the order (step, rank, lane) of its points.
__global__ void __launch_bounds__(BIN_THREADS)
gs_bwd_place_kernel(const int* __restrict__ rec, int* __restrict__ cur,
                    int* __restrict__ list, Geo g) {
  const int w = (int)(((size_t)blockIdx.x * BIN_THREADS + threadIdx.x) >> 5);
  if (w >= g.B * g.NCH) return;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int b = w / g.NCH, chunk = w - b * g.NCH;
  int* col = cur + (size_t)b * g.T * g.NCH + chunk;
  const int first = chunk * g.PW, last = min(first + g.PW, g.P);
  const int* r = rec + (size_t)b * g.P;
  for (int p0 = first; p0 < last; p0 += 32 * REC_ROUND) {
    int rr[REC_ROUND];
#pragma unroll
    for (int s = 0; s < REC_ROUND; ++s) {
      const int p = p0 + s * 32 + lane;
      rr[s] = p < last ? r[p] : -1;
    }
#pragma unroll
    for (int s = 0; s < REC_ROUND; ++s) {
      if (p0 + s * 32 >= last) break;
      const Keys k = record_keys(rr[s], g.TX);
      const int point = (int)((size_t)b * g.P + p0 + s * 32 + lane);
      const int rounds = __reduce_max_sync(FULL, k.n);
      for (int j = 0; j < rounds; ++j) {
        const int t = j < k.n ? key_at(k, j) : -1;
        const unsigned grp = __match_any_sync(FULL, t);
        const int leader = __ffs(grp) - 1;
        int base = 0;
        if (t >= 0 && lane == leader)
          base = atomicAdd(col + (size_t)t * g.NCH, __popc(grp));
        base = __shfl_sync(grp, base, leader);
        if (t >= 0) list[base + __popc(grp & below)] = point;
        __syncwarp();
      }
    }
  }
}

constexpr int SCAN_THREADS = 256;

// Step 2, a block a tile in ticket order: the tile's row of counts scanned
// in place into cursors, offset by the tile's list start, which the
// look-back gives; the last tile writes the lists' total length.
__global__ void __launch_bounds__(SCAN_THREADS)
gs_bwd_scan_kernel(int* __restrict__ cnt, int* __restrict__ tile_start,
                   int* __restrict__ tile_n, int* __restrict__ entries,
                   int* __restrict__ ticket,
                   unsigned long long* __restrict__ status, int ntiles,
                   int nch) {
  __shared__ int s_tile;
  __shared__ int s_warp[32];
  __shared__ int s_start;
  const int tt = lookback::take_ticket(ticket, &s_tile);
  if (tt >= ntiles) return;
  int* row = cnt + (size_t)tt * nch;
  int n = 0;
  for (int base = 0; base < nch; base += SCAN_THREADS) {
    const int e = base + threadIdx.x;
    const int v = e < nch ? row[e] : 0;
    int total;
    const int ex = lookback::block_exclusive_scan(v, s_warp, &total);
    if (e < nch) row[e] = n + ex;
    n += total;
  }
  if (threadIdx.x < 32) {
    const int ex = (int)lookback::exclusive_prefix(status, tt,
                                                    (unsigned)n);
    if (threadIdx.x == 0) s_start = ex;
  }
  __syncthreads();
  const int start = s_start;
  for (int e = threadIdx.x; e < nch; e += SCAN_THREADS) row[e] += start;
  if (threadIdx.x == 0) {
    tile_start[tt] = start;
    tile_n[tt] = n;
    if (tt == ntiles - 1) *entries = start + n;
  }
}

// How a tile's list is summed: in `items` chunks of ceil(n / items)
// entries, their partial tiles in slots first .. first + items - 1. The
// `slots` slots are shared out in proportion to the tiles' entries: tile
// with list [start, start + n) of `total` owns slots [slots * start /
// total, slots * (start + n) / total), so the regions never overlap, and
// it takes ceil(n / LIST_CHUNK) chunks, at most its region's size; one
// chunk (no slot) where that leaves fewer than 2.
struct Plan {
  int items, first;
};

__device__ __forceinline__ int slot_of(int start, int total, int slots) {
  return total ? (int)((long long)slots * start / total) : 0;
}

__device__ __forceinline__ Plan plan_tile(int start, int n, int total,
                                          int slots) {
  Plan pl;
  pl.first = slot_of(start, total, slots);
  const int region = slot_of(start + n, total, slots) - pl.first;
  pl.items = min((n + LIST_CHUNK - 1) / LIST_CHUNK, region);
  if (pl.items < 2) pl.items = 1;
  return pl;
}

// Adds each lane's cg values into texel `local` (< 0: none) of its warp's
// copy (cg planes of TILE_TEXELS floats). grp: the lanes of that texel.
// They are summed by the lowest of them in lane order; when all 32 lanes
// share the texel, by an xor butterfly (16, 8, 4, 2, 1) instead. Either
// way the order is fixed by the inputs.
__device__ __forceinline__ void add_group(float* copy, int local,
                                          unsigned grp,
                                          const float (&v)[SUM_CG], int cg) {
  if (local < 0) return;
  const int lane = threadIdx.x & 31;
  float s[SUM_CG];
#pragma unroll
  for (int k = 0; k < SUM_CG; ++k) s[k] = v[k];
  if (grp == FULL) {
    for (int o = 16; o; o >>= 1) {
#pragma unroll
      for (int k = 0; k < SUM_CG; ++k) s[k] += __shfl_xor_sync(FULL, s[k], o);
    }
  } else {
    for (unsigned rest = grp & (grp - 1u); rest; rest &= rest - 1u) {
      const int j = __ffs(rest) - 1;
#pragma unroll
      for (int k = 0; k < SUM_CG; ++k) s[k] += __shfl_sync(grp, v[k], j);
    }
  }
  if (lane == __ffs(grp) - 1)
    for (int k = 0; k < cg; ++k) copy[k * TILE_TEXELS + local] += s[k];
}

// The texel of (xx, yy) in the tile at (tx0, ty0), or -1 outside it.
__device__ __forceinline__ int local_texel(int xx, int yy, int tx0,
                                           int ty0) {
  const int lx = xx - tx0, ly = yy - ty0;
  return (unsigned)lx < (unsigned)TILE && (unsigned)ly < (unsigned)TILE
             ? ly * TILE + lx : -1;
}

// One step of 32 list entries (p < 0: none) into the warp's copy, for
// channels c0 .. c0 + cg: tap by tap, the lanes of one texel combined.
// Lanes share a texel for every tap when they share the first tap's,
// except where a tap is clamped to the last row or column: then the
// lanes are grouped again for each tap.
__device__ __forceinline__ void sum_step(float* copy, int p, float x,
                                         float y, const float (&v)[SUM_CG],
                                         int cg, int tx0, int ty0,
                                         const Geo& g) {
  if (g.nearest) {
    const int xn = nearest_x(x, g.W);
    const int yn = clamp_int((int)rintf(y), 0, g.H - 1);
    const int local = p >= 0 ? local_texel(xn, yn, tx0, ty0) : -1;
    add_group(copy, local, __match_any_sync(FULL, local), v, cg);
    return;
  }
  const Taps tp = bilinear_taps(x, y, g.H, g.W);
  const float ax = 1.f - tp.wx, ay = 1.f - tp.wy;
  const int xs[4] = {tp.x0, tp.x1, tp.x0, tp.x1};
  const int ys[4] = {tp.y0, tp.y0, tp.y1, tp.y1};
  const float w1[4] = {ax, tp.wx, ax, tp.wx};
  const float w2[4] = {ay, ay, tp.wy, tp.wy};
  const bool clamped = p >= 0 && (tp.x0 == g.W - 1 || tp.y0 == g.H - 1);
  const unsigned first = __match_any_sync(
      FULL, p >= 0 ? (int)(tp.y0 * g.W + tp.x0) : -1);
  const bool regroup = __any_sync(FULL, clamped);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int local = p >= 0 ? local_texel(xs[k], ys[k], tx0, ty0) : -1;
    const unsigned grp = regroup ? __match_any_sync(FULL, local) : first;
    float term[SUM_CG];
#pragma unroll
    for (int c = 0; c < SUM_CG; ++c) term[c] = v[c] * w1[k] * w2[k];
    add_group(copy, local, grp, term, cg);
  }
}

// The point of list entry e, -1 past m.
__device__ __forceinline__ int list_point(const int* __restrict__ list,
                                          int e0, int e, int m) {
  return e < m ? list[e0 + e] : -1;
}

// A point's coordinates and channels c0 .. c0 + cg of its cotangent.
template <Coords M>
__device__ __forceinline__ void load_point(int p, int c0, int cg,
                                           const Src& src,
                                           const float* __restrict__ cot,
                                           const Geo& g, float& x, float& y,
                                           float (&v)[SUM_CG]) {
  const int C = g.C;
  x = y = 0.f;
  if (p >= 0) point_coords<M>(src, (size_t)p, g.P, g.H, g.W, x, y);
#pragma unroll
  for (int k = 0; k < SUM_CG; ++k)
    v[k] = p >= 0 && k < cg ? cot[(size_t)p * C + c0 + k] : 0.f;
}

// Step 4 for the m list entries from e0 of tile tt, chunk `slot - first`
// of `items` (its partial tile in `slot` when items > 1).
template <Coords M>
__device__ void sum_chunk(const int* __restrict__ list, int e0, int m,
                          int tt, int items, int first, int slot,
                          int* __restrict__ done, const Src& src,
                          const float* __restrict__ cot,
                          float* __restrict__ partials,
                          float* __restrict__ dmaps, const Geo& g,
                          float* s_copy, int* s_last) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = tt / g.T, t = tt - b * g.T;
  const int ty0 = (t / g.TX) * TILE, tx0 = (t % g.TX) * TILE;
  const int nsteps = (m + 31) / 32;
  const int cg_max = min(g.C, SUM_CG);
  float* mine = s_copy + (size_t)warp * cg_max * TILE_TEXELS;
  for (int c0 = 0; c0 < g.C; c0 += SUM_CG) {
    const int cg = min(SUM_CG, g.C - c0);
    for (int idx = lane; idx < cg * TILE_TEXELS; idx += 32) mine[idx] = 0.f;
    __syncwarp();
    // warp w takes the steps w, w + SUM_WARPS, ..., two at a time, the
    // list entries of the next two loaded ahead
    int na = list_point(list, e0, warp * 32 + lane, m);
    int nb = list_point(list, e0, (warp + SUM_WARPS) * 32 + lane, m);
    for (int q = warp; q < nsteps; q += 2 * SUM_WARPS) {
      const int pa = na, pb = nb;
      na = list_point(list, e0, (q + 2 * SUM_WARPS) * 32 + lane, m);
      nb = list_point(list, e0, (q + 3 * SUM_WARPS) * 32 + lane, m);
      float xa, ya, xb, yb, va[SUM_CG], vb[SUM_CG];
      load_point<M>(pa, c0, cg, src, cot, g, xa, ya, va);
      load_point<M>(pb, c0, cg, src, cot, g, xb, yb, vb);
      sum_step(mine, pa, xa, ya, va, cg, tx0, ty0, g);
      if (q + SUM_WARPS < nsteps)
        sum_step(mine, pb, xb, yb, vb, cg, tx0, ty0, g);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < cg * TILE_TEXELS; idx += blockDim.x) {
      float s = s_copy[idx];
      for (int w = 1; w < SUM_WARPS; ++w)
        s += s_copy[(size_t)w * cg_max * TILE_TEXELS + idx];
      const int c = c0 + idx / TILE_TEXELS, tx = idx % TILE_TEXELS;
      if (items > 1) {
        partials[((size_t)slot * g.C + c) * TILE_TEXELS + tx] = s;
        continue;
      }
      const int yy = ty0 + tx / TILE, xx = tx0 + tx % TILE;
      if (yy < g.H && xx < g.W)
        dmaps[(((size_t)b * g.C + c) * g.H + yy) * g.W + xx] = s;
    }
    __syncthreads();
  }
  if (items == 1) return;
  // the last chunk of the tile to finish adds the partials in chunk order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(done + tt, 1) == items - 1;
  __syncthreads();
  if (*s_last) {
    __threadfence();
    const float* part = partials + (size_t)first * g.C * TILE_TEXELS;
    for (int idx = threadIdx.x; idx < g.C * TILE_TEXELS; idx += blockDim.x) {
      const int c = idx / TILE_TEXELS, tx = idx % TILE_TEXELS;
      const int yy = ty0 + tx / TILE, xx = tx0 + tx % TILE;
      if (yy >= g.H || xx >= g.W) continue;
      float s = __ldcg(part + idx);
      for (int jj = 1; jj < items; ++jj)
        s += __ldcg(part + (size_t)jj * g.C * TILE_TEXELS + idx);
      dmaps[(((size_t)b * g.C + c) * g.H + yy) * g.W + xx] = s;
    }
  }
  __syncthreads();
}

// Step 3b, a thread a tile: the tile's plan (plan_tile), its chunks into
// tile_items, and the owner of each slot of its region (-1 past its
// chunks), so that the sum's blocks find their work with one load.
__global__ void __launch_bounds__(SCAN_THREADS)
gs_bwd_plan_kernel(const int* __restrict__ tile_start,
                   const int* __restrict__ tile_n,
                   const int* __restrict__ entries, int slots,
                   int* __restrict__ tile_items, int* __restrict__ owner,
                   int ntiles) {
  const int tt = blockIdx.x * SCAN_THREADS + threadIdx.x;
  if (tt >= ntiles) return;
  const int total = *entries, start = tile_start[tt];
  const Plan pl = plan_tile(start, tile_n[tt], total, slots);
  tile_items[tt] = pl.items;
  const int end = slot_of(start + tile_n[tt], total, slots);
  for (int s = pl.first; s < end; ++s)
    owner[s] = pl.items > 1 && s < pl.first + pl.items ? tt : -1;
}

// Step 4: blocks 0 .. ntiles - 1 sum the tiles of one chunk; block
// ntiles + s takes slot s, a chunk of a longer list, if it has an owner.
template <Coords M>
__global__ void __launch_bounds__(SUM_WARPS * 32)
gs_bwd_sum_kernel(const int* __restrict__ list,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_n,
                  const int* __restrict__ tile_items,
                  const int* __restrict__ owner,
                  const int* __restrict__ entries, int slots,
                  int* __restrict__ done, Src src,
                  const float* __restrict__ cot,
                  float* __restrict__ partials, float* __restrict__ dmaps,
                  Geo g, int ntiles) {
  extern __shared__ float s_copy[];
  __shared__ int s_last;
  if ((int)blockIdx.x < ntiles) {
    const int tt = blockIdx.x;
    if (tile_items[tt] == 1)
      sum_chunk<M>(list, tile_start[tt], tile_n[tt], tt, 1, 0, 0, done,
                   src, cot, partials, dmaps, g, s_copy, &s_last);
    return;
  }
  // With no entries no tile has a region, so gs_bwd_plan_kernel wrote no
  // owner and the slots hold whatever the scratch held; otherwise the
  // regions cover every slot and each has its owner or -1.
  const int total = *entries;
  if (total == 0) return;
  const int s = blockIdx.x - ntiles;
  const int tt = owner[s];
  if (tt < 0) return;
  const int start = tile_start[tt], n = tile_n[tt], items = tile_items[tt];
  const int first = slot_of(start, total, slots);
  const int j = s - first;
  const int len = (n + items - 1) / items;
  sum_chunk<M>(list, start + j * len, max(0, min(len, n - j * len)), tt,
               items, first, s, done, src, cot, partials, dmaps, g, s_copy,
               &s_last);
}

// The backward's scratch, by byte offsets, from the shapes alone.
struct Layout {
  Geo g;
  size_t status, done, ticket, cnt, zero_end, tile_start, tile_n,
      entries, rec, owner, tile_items, list, partials, tex, bytes;
  int slots;
};

size_t align_up(size_t v) { return (v + 255) & ~(size_t)255; }

Layout make_layout(int B, int C, int H, int W, int P, int nearest,
                   int need_tex) {
  Layout L;
  Geo& g = L.g;
  g.B = B; g.C = C; g.H = H; g.W = W; g.P = P; g.nearest = nearest;
  g.TX = (W + TILE - 1) / TILE;
  g.T = g.TX * ((H + TILE - 1) / TILE);
  g.G = (C + 3) / 4;
  const size_t bt = (size_t)B * g.T;
  // chunks of 128 points, longer where the (tile, chunk) table would
  // pass 2^21 entries
  g.PW = 128;
  while (bt * (((size_t)P + g.PW - 1) / g.PW) > ((size_t)1 << 21)
         && g.PW < (1 << 28))
    g.PW *= 2;
  g.NCH = (int)(((size_t)P + g.PW - 1) / g.PW);
  const size_t emax = (size_t)(nearest ? 1 : 4) * B * P;
  // slots of partial tiles for the lists of more than one chunk, no more
  // than the chunks there can be
  L.slots = (int)std::min({SLOTS_PER_TILE * bt + SLOTS_EXTRA,
                           (size_t)SLOTS_MAX, 2 * emax / LIST_CHUNK});
  size_t o = 0;
  L.status = o; o = align_up(o + bt * 8);
  L.done = o; o = align_up(o + bt * 4);
  L.ticket = o; o = align_up(o + 4);
  L.cnt = o; o = align_up(o + bt * g.NCH * 4);
  L.zero_end = o;
  L.tile_start = o; o = align_up(o + bt * 4);
  L.tile_n = o; o = align_up(o + bt * 4);
  L.entries = o; o = align_up(o + 4);
  L.rec = o; o = align_up(o + (size_t)B * P * 4);
  L.owner = o; o = align_up(o + (size_t)L.slots * 4);
  L.tile_items = o; o = align_up(o + bt * 4);
  L.list = o; o = align_up(o + emax * 4);
  L.partials = o;
  o = align_up(o + (size_t)L.slots * C * TILE_TEXELS * 4);
  L.tex = o;
  if (need_tex) o = align_up(o + (size_t)B * H * W * g.G * 16);
  L.bytes = o;
  return L;
}

// The forward: the interleaved copy, then the sampler.
template <Coords M>
int forward(const float* maps, Src src, float* tex, float* out, int B, int C,
            int H, int W, int P, int nearest, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || P == 0 || C == 0) return (int)cudaGetLastError();
  const int G = (C + 3) / 4;
  const cudaStream_t s = (cudaStream_t)stream;
  interleave_kernel<<<(unsigned)(((size_t)B * H * W + THREADS - 1)
                                 / THREADS), THREADS, 0, s>>>(
      maps, (float4*)tex, B, C, H * W, G);
  const size_t per_block = (size_t)THREADS * PTS;
  grid_sample_fwd_kernel<M><<<(unsigned)(((size_t)B * P + per_block - 1)
                                         / per_block), THREADS, 0, s>>>(
      (const float4*)tex, src, out, B, C, H, W, P, G, nearest);
  return (int)cudaGetLastError();
}

// The backward: the copy where tex is null (bilinear), a memset, then
// steps 1-4 (with 3b). d0, d1: dix and diy (Sampler) or duv and null (Uv).
template <Coords M>
int backward(const float* maps, const float* tex, Src src, const float* cot,
             float* dmaps, float* d0, float* d1, void* scratch, int B, int C,
             int H, int W, int P, int nearest, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const Layout L = make_layout(B, C, H, W, P, nearest,
                               !nearest && tex == nullptr);
  const Geo& g = L.g;
  char* base = (char*)scratch;
  if (!nearest && tex == nullptr && C > 0) {
    interleave_kernel<<<(unsigned)(((size_t)B * H * W + THREADS - 1)
                                   / THREADS), THREADS, 0, s>>>(
        maps, (float4*)(base + L.tex), B, C, H * W, g.G);
    tex = (const float*)(base + L.tex);
  }
  err = cudaMemsetAsync(base, 0, L.zero_end, s);
  if (err != cudaSuccess) return (int)err;
  int* cnt = (int*)(base + L.cnt);
  int* rec = (int*)(base + L.rec);
  int* list = (int*)(base + L.list);
  const int ntiles = B * g.T;
  const size_t points = (size_t)B * P;
  if (points > 0)
    gs_bwd_point_kernel<M><<<(unsigned)((points + POINT_THREADS - 1)
                                        / POINT_THREADS), POINT_THREADS, 0,
                             s>>>((const float4*)tex, src, cot, d0, d1, rec,
                                  cnt, g);
  const unsigned bin_blocks =
      (unsigned)(((size_t)B * g.NCH * 32 + BIN_THREADS - 1) / BIN_THREADS);
  gs_bwd_scan_kernel<<<ntiles, SCAN_THREADS, 0, s>>>(
      cnt, (int*)(base + L.tile_start), (int*)(base + L.tile_n),
      (int*)(base + L.entries), (int*)(base + L.ticket),
      (unsigned long long*)(base + L.status), ntiles, g.NCH);
  if (bin_blocks > 0)
    gs_bwd_place_kernel<<<bin_blocks, BIN_THREADS, 0, s>>>(rec, cnt, list,
                                                            g);
  const size_t smem = (size_t)SUM_WARPS * min(C, SUM_CG) * TILE_TEXELS * 4;
  // the copies take 96 KB at C >= 3, past the default
  err = cudaFuncSetAttribute(gs_bwd_sum_kernel<M>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  gs_bwd_plan_kernel<<<(ntiles + SCAN_THREADS - 1) / SCAN_THREADS,
                       SCAN_THREADS, 0, s>>>(
      (int*)(base + L.tile_start), (int*)(base + L.tile_n),
      (int*)(base + L.entries), L.slots, (int*)(base + L.tile_items),
      (int*)(base + L.owner), ntiles);
  gs_bwd_sum_kernel<M><<<ntiles + L.slots, SUM_WARPS * 32, smem, s>>>(
      list, (int*)(base + L.tile_start), (int*)(base + L.tile_n),
      (int*)(base + L.tile_items), (int*)(base + L.owner),
      (int*)(base + L.entries), L.slots, (int*)(base + L.done), src, cot,
      (float*)(base + L.partials), dmaps, g, ntiles);
  return (int)cudaGetLastError();
}

Src sampler_src(const float* ix, const float* iy) {
  return Src{ix, iy, nullptr, 0, 0};
}

Src uv_src(const float* uv, long long sb, long long sp) {
  return Src{nullptr, nullptr, uv, sb, sp};
}

}  // namespace

extern "C" {

// tex (B, H, W, C4) float scratch, C4 = C rounded up to a multiple of 4;
// out (B, P, C), every entry written. Two launches on the stream: the
// interleaved copy, then the sampler.
int grid_sample_forward(const float* maps, const float* ix, const float* iy,
                        float* tex, float* out, int B, int C, int H, int W,
                        int P, int nearest, int device, void* stream) {
  return forward<Coords::Sampler>(maps, sampler_src(ix, iy), tex, out, B, C,
                                  H, W, P, nearest, device, stream);
}

// grid_sample_forward at OpenGL UVs: u of point (b, p) at uv[b * sb + p *
// sp], v at the next float (the header's Uv mode); B * P < 2^29, as the
// backward takes.
int grid_sample_uv_forward(const float* maps, const float* uv, long long sb,
                           long long sp, float* tex, float* out, int B, int C,
                           int H, int W, int P, int nearest, int device,
                           void* stream) {
  return forward<Coords::Uv>(maps, uv_src(uv, sb, sp), tex, out, B, C, H, W,
                             P, nearest, device, stream);
}

// grid_sample_backward's scratch for these shapes (have_tex: the caller
// passes the forward's interleaved copy), in either mode: out[0] its
// bytes, out[1..3] the byte offsets of the tiles' list starts and lengths
// (B * T ints each) and of the lists (point indices b * P + p), out[4] the
// tiles T of a batch element (TILE x TILE texels, row-major), out[5] the
// slots of partial tiles.
int grid_sample_backward_layout(int B, int C, int H, int W, int P,
                                int nearest, int have_tex, long long* out) {
  const Layout L = make_layout(B, C, H, W, P, nearest,
                               !nearest && !have_tex);
  out[0] = (long long)L.bytes;
  out[1] = (long long)L.tile_start;
  out[2] = (long long)L.tile_n;
  out[3] = (long long)L.list;
  out[4] = L.g.T;
  out[5] = L.slots;
  return 0;
}

// dmaps (B, C, H, W), dix and diy (B, P): every entry written. tex: the
// forward's interleaved copy (B, H, W, C4), or null to make it here in the
// scratch (bilinear only); scratch: grid_sample_backward_layout's bytes.
// Seven launches at most: the copy, a memset, then steps 1-4 (with 3b).
int grid_sample_backward(const float* maps, const float* tex,
                         const float* ix, const float* iy, const float* cot,
                         float* dmaps, float* dix, float* diy, void* scratch,
                         int B, int C, int H, int W, int P, int nearest,
                         int device, void* stream) {
  return backward<Coords::Sampler>(maps, tex, sampler_src(ix, iy), cot,
                                   dmaps, dix, diy, scratch, B, C, H, W, P,
                                   nearest, device, stream);
}

// grid_sample_backward at OpenGL UVs (as grid_sample_uv_forward takes
// them): dmaps and duv (B, P, 2), every entry written.
int grid_sample_uv_backward(const float* maps, const float* tex,
                            const float* uv, long long sb, long long sp,
                            const float* cot, float* dmaps, float* duv,
                            void* scratch, int B, int C, int H, int W, int P,
                            int nearest, int device, void* stream) {
  return backward<Coords::Uv>(maps, tex, uv_src(uv, sb, sp), cot, dmaps, duv,
                              nullptr, scratch, B, C, H, W, P, nearest,
                              device, stream);
}

}  // extern "C"
