// Bilinear / nearest texture sampling with border padding, forward and
// backward, one thread per (batch, point).
//
// Replaces the TPU kernels kaolin_tpu/kernels/texture.py grid_sample_pallas
// (forward) and _grid_sample_bwd_pallas (backward). Those build one-hot
// weight matrices and sample with MXU products, because the TPU has no
// gather. The H100 has one, so these kernels follow the JAX package's XLA
// gather path instead (kaolin_tpu/render/mesh/utils.py grid_sample_2d):
// the four taps (x0, y0), (x1, y0), (x0, y1), (x1, y1) with
// c0 = floor(c), c1 = min(c0 + 1, size - 1), w = c - floor(c), and
//   v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx
// in that order; nearest mode takes the texel at rintf(c) (half to even,
// as jnp.round and torch.round). Any texture size is taken; the Pallas
// kernel takes at most 128 x 128.
//
// The coordinates are the sampler's: unnormalised and already clipped to
// [0, size - 1] by the caller. The tap indices are clamped to the texture
// as well, which changes nothing on such inputs and keeps every read and
// write inside the buffers whatever the caller passes.
//
// Forward: the texture arrives planar, (B, C, H, W), so a tap's C channels
// lie a plane apart and a bilinear point would make 4 x C scattered
// 4-byte reads. A first kernel therefore interleaves the texture into a
// scratch (B, H, W, C4) copy, C4 = C rounded up to a multiple of 4 and the
// padding zeroed, one thread per texel (planar reads and 16-byte writes,
// both coalesced). The sampler then reads each tap's channels as C4 / 4
// 16-byte loads: 4 loads a point at C = 3 instead of 12. The texture
// changes at every step of a fit, so the copy is made at every call, on
// the same stream, inside one entry point. No hardware texture filtering:
// its 8-bit fixed-point weights would break the bit-equality below.
//
// Backward: per point, the coordinate gradients
//   dix = sum_c g_c * ((v01 - v00)*(1-wy) + (v11 - v10)*wy)
//   diy = sum_c g_c * ((v10 - v00)*(1-wx) + (v11 - v01)*wx)
// summed over channels in order by the point's own thread (no reduction
// across threads, so every launch gives the same bits; exactly 0 in
// nearest mode), and the texture gradient, a scatter: each point adds
// g_c times its tap weight into 4 texels per channel with atomicAdd on a
// zeroed buffer, as PyTorch's own grid-sampler backward does. The order of
// those adds changes from launch to launch, so dtex is not bit-stable. An
// add whose term is exactly 0 is skipped: on the DIB-R textured step every
// uncovered pixel samples the same texel (UV 0) with a zero cotangent, and
// without the skip those adds would pile onto one address per batch
// element.
//
// What bounds it on an H100: bytes. Forward: ix, iy (8 bytes per point) in,
// C floats per point out, the texture read once (it fits in the 50 MB L2);
// the interleaved copy adds one more read of the texture and a write of
// C4 floats a texel. Backward: also the cotangent in, dix, diy and dtex
// out. The arithmetic is under 20 operations per point and channel.
//
// Arithmetic follows the plain PyTorch version
// (kaolin_tpu_torch/kernels/texture.py) operation for operation:
// --fmad=false, the same products in the same order, so the forward and
// dix/diy agree with it bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// points per thread of the sampler; 1, 2 and 4 took the same time within
// 5% at config 2's step on the H100 (PERF.md)
constexpr int PTS = 2;

struct Taps {
  size_t i00, i01, i10, i11;  // texel offsets y * W + x
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
  const int x0 = clamp_int((int)x0f, 0, W - 1);
  const int y0 = clamp_int((int)y0f, 0, H - 1);
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  t.i00 = (size_t)y0 * W + x0;
  t.i01 = (size_t)y0 * W + x1;
  t.i10 = (size_t)y1 * W + x0;
  t.i11 = (size_t)y1 * W + x1;
  return t;
}

__device__ __forceinline__ size_t nearest_tap(float x, float y, int H,
                                              int W) {
  const int xn = clamp_int((int)rintf(x), 0, W - 1);
  const int yn = clamp_int((int)rintf(y), 0, H - 1);
  return (size_t)yn * W + xn;
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

// tex (B, H, W, C4) interleaved; ix, iy (B, P); out (B, P, C). A thread
// samples PTS points THREADS apart, their coordinates loaded first, so
// that more loads are in flight per thread.
__global__ void __launch_bounds__(THREADS)
grid_sample_fwd_kernel(const float4* __restrict__ tex,
                       const float* __restrict__ ix,
                       const float* __restrict__ iy,
                       float* __restrict__ out, int B, int C, int H, int W,
                       int P, int G, int nearest) {
  const size_t first = (size_t)blockIdx.x * THREADS * PTS + threadIdx.x;
  const size_t total = (size_t)B * P;
  float x[PTS], y[PTS];
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    const size_t i = first + (size_t)j * THREADS;
    x[j] = i < total ? ix[i] : 0.f;
    y[j] = i < total ? iy[i] : 0.f;
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

__device__ __forceinline__ void add_nonzero(float* dst, float v) {
  if (v != 0.f) atomicAdd(dst, v);
}

// cot (B, P, C); dmaps (B, C, H, W) zeroed by the caller; dix, diy (B, P)
__global__ void __launch_bounds__(THREADS)
grid_sample_bwd_kernel(const float* __restrict__ maps,
                       const float* __restrict__ ix,
                       const float* __restrict__ iy,
                       const float* __restrict__ cot,
                       float* __restrict__ dmaps, float* __restrict__ dix,
                       float* __restrict__ diy, int B, int C, int H, int W,
                       int P, int nearest) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)B * P) return;
  const int b = (int)(i / P);
  const size_t plane = (size_t)H * W;
  const float* tex = maps + (size_t)b * C * plane;
  float* dtex = dmaps + (size_t)b * C * plane;
  const float* g = cot + i * C;
  const float x = ix[i], y = iy[i];
  if (nearest) {
    const size_t k = nearest_tap(x, y, H, W);
    for (int c = 0; c < C; ++c) add_nonzero(dtex + c * plane + k, g[c]);
    dix[i] = 0.f;
    diy[i] = 0.f;
    return;
  }
  const Taps t = bilinear_taps(x, y, H, W);
  const float ax = 1.f - t.wx, ay = 1.f - t.wy;
  float gx = 0.f, gy = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* tc = tex + c * plane;
    const float v00 = __ldg(tc + t.i00), v01 = __ldg(tc + t.i01);
    const float v10 = __ldg(tc + t.i10), v11 = __ldg(tc + t.i11);
    const float gc = g[c];
    gx += gc * ((v01 - v00) * ay + (v11 - v10) * t.wy);
    gy += gc * ((v10 - v00) * ax + (v11 - v01) * t.wx);
    float* dc = dtex + c * plane;
    add_nonzero(dc + t.i00, gc * ax * ay);
    add_nonzero(dc + t.i01, gc * t.wx * ay);
    add_nonzero(dc + t.i10, gc * ax * t.wy);
    add_nonzero(dc + t.i11, gc * t.wx * t.wy);
  }
  dix[i] = gx;
  diy[i] = gy;
}

int blocks_for(int B, int P) {
  return (int)(((size_t)B * P + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

// tex (B, H, W, C4) float scratch, C4 = C rounded up to a multiple of 4;
// out (B, P, C), every entry written. Two launches on the stream: the
// interleaved copy, then the sampler.
int grid_sample_forward(const float* maps, const float* ix, const float* iy,
                        float* tex, float* out, int B, int C, int H, int W,
                        int P, int nearest, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || P == 0 || C == 0) return (int)cudaGetLastError();
  const int G = (C + 3) / 4;
  const cudaStream_t s = (cudaStream_t)stream;
  interleave_kernel<<<blocks_for(B, H * W), THREADS, 0, s>>>(
      maps, (float4*)tex, B, C, H * W, G);
  const size_t per_block = (size_t)THREADS * PTS;
  grid_sample_fwd_kernel<<<(unsigned)(((size_t)B * P + per_block - 1)
                                      / per_block), THREADS, 0, s>>>(
      (const float4*)tex, ix, iy, out, B, C, H, W, P, G, nearest);
  return (int)cudaGetLastError();
}

// dmaps (B, C, H, W) must hold zeros; dix and diy (B, P) are written.
int grid_sample_backward(const float* maps, const float* ix,
                         const float* iy, const float* cot, float* dmaps,
                         float* dix, float* diy, int B, int C, int H, int W,
                         int P, int nearest, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || P == 0) return (int)cudaGetLastError();
  grid_sample_bwd_kernel<<<blocks_for(B, P), THREADS, 0,
                           (cudaStream_t)stream>>>(
      maps, ix, iy, cot, dmaps, dix, diy, B, C, H, W, P, nearest);
  return (int)cudaGetLastError();
}

}  // extern "C"
