// DefTet's per-pixel top-knum face selection, one thread per pixel.
//
// Replaces the TPU kernel kaolin_tpu/kernels/deftet_topk.py
// deftet_topk_pallas. For each pixel: the ids of the first knum faces by
// (depth descending, face id ascending) among the faces whose half-open
// bbox holds the pixel, whose barycentric inside test holds and whose
// depth lies in the pixel's open range; -1 in the slots past the last.
//
// Scoring repeats the XLA path's operations in their order
// (kaolin_tpu/render/mesh/deftet.py _select_topk): the differences to the
// pixel, w0 = bx*cy - by*cx (and w1, w2 likewise), norm = (w0 + w1) + w2,
// norm + eps*sign(norm), three IEEE divisions, depth = (w0*z0 + w1*z1) +
// w2*z2, compiled with --fmad=false so that no product is fused into a
// sum. The order is lax.top_k's: depths compare by the float's total
// order (+0.0 ranks above -0.0, which the Pallas kernel's `>` treats as
// equal), and equal keys keep the lower face id, because faces arrive in
// id order and an insertion moves past only strictly smaller keys.
//
// Design: faces are staged through shared memory CHUNK at a time, in id
// order, each with its bbox, image coords and z. Each thread keeps its
// running top-knum list in its own output row (ids) and a row of the
// scratch (total-order keys), so any knum works; the key of the list's
// last entry stays in a register and rejects most faces after the list
// fills.
//
// What bounds it on an H100: operations. About 40 float operations per
// (pixel, face) pair whose bbox holds the pixel, and 4 compares for every
// other pair; the bytes (13 floats per face, 4 per pixel in, knum ids per
// pixel out) are well under a megabyte at config 4 (4,096 pixels, 10,000
// faces). 4,096 pixels at one thread each fill only 32 blocks of 128
// threads, under a quarter of the card's 132 SMs: splitting the faces
// across blocks and merging the lists is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // pixels per block
constexpr int CHUNK = 256;     // faces staged per pass

// A signed integer that orders floats as their total order does: -0.0
// below +0.0, -inf below every finite value.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// pc, rr (B, P, 2); z (B, F, 3); img (B, F, 6); bbox (B, F, 4) as (xmin,
// ymin, xmax, ymax), invalid faces with xmin = +inf; out (B, P, knum)
// int32 ids and keys (B, P, knum) int32 scratch.
__global__ void __launch_bounds__(THREADS)
deftet_topk_kernel(const float* __restrict__ pc, const float* __restrict__ rr,
                   const float* __restrict__ z, const float* __restrict__ img,
                   const float* __restrict__ bbox, int* __restrict__ out,
                   int* __restrict__ keys, int P, int F, int knum,
                   float eps) {
  __shared__ float s_bb[4][CHUNK];
  __shared__ float s_img[6][CHUNK];
  __shared__ float s_z[3][CHUNK];
  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < P;
  // threads past P read the last pixel and write nothing, so that every
  // thread reaches the barriers
  const size_t pix = (size_t)b * P + (live ? i : P - 1);
  const float px = pc[pix * 2], py = pc[pix * 2 + 1];
  const float rmin = rr[pix * 2], rmax = rr[pix * 2 + 1];
  int* row = out + pix * knum;
  int* krow = keys + pix * knum;
  int n = 0;            // entries in the list
  int kth = INT32_MIN;  // key of the list's last entry once it is full
  const float* zb = z + (size_t)b * F * 3;
  const float* ib = img + (size_t)b * F * 6;
  const float* bb = bbox + (size_t)b * F * 4;
  for (int base = 0; base < F; base += CHUNK) {
    const int m = min(CHUNK, F - base);
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += THREADS) {
      const size_t f = (size_t)(base + k);
      for (int c = 0; c < 4; ++c) s_bb[c][k] = bb[f * 4 + c];
      for (int c = 0; c < 6; ++c) s_img[c][k] = ib[f * 6 + c];
      for (int c = 0; c < 3; ++c) s_z[c][k] = zb[f * 3 + c];
    }
    __syncthreads();
    if (!live || knum <= 0) continue;
    for (int k = 0; k < m; ++k) {
      if (!(px >= s_bb[0][k] && px < s_bb[2][k] && py >= s_bb[1][k]
            && py < s_bb[3][k]))
        continue;
      const float ax = s_img[0][k] - px, ay = s_img[1][k] - py;
      const float bx = s_img[2][k] - px, by = s_img[3][k] - py;
      const float cx = s_img[4][k] - px, cy = s_img[5][k] - py;
      float w0 = bx * cy - by * cx;
      float w1 = cx * ay - cy * ax;
      float w2 = ax * by - ay * bx;
      float norm = (w0 + w1) + w2;
      const float sgn = norm > 0.f ? 1.f : (norm < 0.f ? -1.f : 0.f);
      norm = norm + eps * sgn;
      w0 = w0 / norm;
      w1 = w1 / norm;
      w2 = w2 / norm;
      if (!(w0 >= 0.f && w1 >= 0.f && w2 >= 0.f)) continue;
      const float depth = (w0 * s_z[0][k] + w1 * s_z[1][k]) + w2 * s_z[2][k];
      if (!(depth > rmin && depth < rmax)) continue;
      const int key = order_key(depth);
      if (n == knum && key <= kth) continue;
      int pos = n < knum ? n : knum - 1;
      while (pos > 0 && krow[pos - 1] < key) {
        krow[pos] = krow[pos - 1];
        row[pos] = row[pos - 1];
        --pos;
      }
      krow[pos] = key;
      row[pos] = base + k;
      if (n < knum) ++n;
      if (n == knum) kth = krow[knum - 1];
    }
  }
  if (live)
    for (int s = n; s < knum; ++s) row[s] = -1;
}

}  // namespace

extern "C" {

// out (B, P, knum) int32, every entry written; keys (B, P, knum) int32
// scratch.
int deftet_topk_forward(const float* pc, const float* rr, const float* z,
                        const float* img, const float* bbox, int* out,
                        int* keys, int B, int P, int F, int knum, float eps,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || P == 0) return (int)cudaGetLastError();
  const dim3 grid((P + THREADS - 1) / THREADS, B);
  deftet_topk_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      pc, rr, z, img, bbox, out, keys, P, F, knum, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
