// DefTet's per-pixel top-knum face selection.
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
// equal), then the lower face id first. Each hit gets a 64-bit key, the
// depth's total-order key in the high word and the complemented face id
// in the low word: keys are unique, and a larger key comes first.
//
// What bounds it on an H100: operations. About 40 float operations per
// (pixel, face) pair whose bbox holds the pixel, and 4 compares for every
// other pair; the bytes (13 floats per face, 4 per pixel in, knum ids per
// pixel out) are well under a megabyte at config 4 (4,096 pixels, 10,000
// faces, a 0.0072 ms bound). One thread per pixel, as before, gives only
// 128 warps there, each walking every face with its running list in
// device memory.
//
// The design, three kernels on one stream:
// 1. deftet_prepare_kernel forms each face's record once: 4 float4 of
//    bbox (xmin = +inf on an invalid face, so that no pixel passes it),
//    image coords and z.
// 2. deftet_scan_kernel: a block of THREADS threads, one pixel a lane,
//    takes one tile of THREADS pixels and one of `splits` contiguous
//    ranges of the faces (the grid is 1-D, the split its fastest part), so
//    that a small image still fills the card. splits_for picks the ranges:
//    enough for about SPLIT_BLOCKS blocks, at most MAX_SPLITS, at most one
//    per staged chunk of faces, and at most MAX_KEYS / knum, so that a
//    pixel's lists never hold more than MAX_KEYS keys (75 KB) whatever
//    knum is. Fewer splits cost time where the lists lie in device memory
//    (each insertion shifts up to a list's length, and a list holds more
//    hits), so the cap binds only above knum 300. The block stages the
//    records in chunks of CHUNK faces in shared memory with cp.async,
//    double-buffered and in id order. Each warp culls the chunk 32 faces
//    at a time, one a lane: a face passes when its bbox meets the box of
//    the warp's pixels (at config 4 a warp is half a pixel column). The
//    ballot of the faces that pass is the warp's queue, taken lowest face
//    first (__ffs), so the lanes score their own pixels against those
//    faces only. Each (pixel, split) keeps
//    its own list of its first knum keys, sorted, in shared memory (knum
//    <= SMEM_KNUM; layout [slot][pixel], so the lanes of a warp touch 32
//    neighbouring words), else in the device-memory scratch that the merge
//    reads: one kernel, instantiated for each of the two places and chosen
//    by size, so that the lists in shared memory take shared loads and
//    stores, not generic ones. The list's last key, kept in a register,
//    rejects a hit as soon as the list is full and the hit ranks below it.
//    At the end a list in shared memory is copied to the scratch, and an
//    EMPTY key closes a list that is not full.
// 3. deftet_merge_kernel: one warp per pixel, one lane per split, takes
//    the first knum keys of the splits' sorted lists (the largest head
//    each time) and writes the face ids, -1 past the last key.
// No atomics: two launches give the same bits. Any knum and any number of
// faces work.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;     // pixels per scan block
constexpr int CHUNK = 64;        // faces staged per pass
constexpr int MAX_SPLITS = 32;   // face ranges, the most a call takes
constexpr int SPLIT_BLOCKS = 1024;  // scan blocks a call aims at (~8 an SM)
constexpr int SMEM_KNUM = 64;    // lists in shared memory up to this knum
// the most keys a pixel's lists hold: knum 300, deftet_sparse_render's
// default, keeps every split
constexpr int MAX_KEYS = MAX_SPLITS * 300;
constexpr long long EMPTY = LLONG_MIN;  // below every key
constexpr unsigned FULL = 0xffffffffu;

// A signed integer that orders floats as their total order does: -0.0
// below +0.0, -inf below every finite value.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(f);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// z (B, F, 3); img (B, F, 6); valid (B, F) bytes; rec (B, F, 4) float4:
// (xmin, ymin, xmax, ymax), (ax, ay, bx, by), (cx, cy, z0, z1), (z2, 0,
// 0, 0)
__global__ void __launch_bounds__(256)
deftet_prepare_kernel(const float* __restrict__ z,
                      const float* __restrict__ img,
                      const unsigned char* __restrict__ valid,
                      float4* __restrict__ rec, long long total) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const float* v = img + i * 6;
  const float* zz = z + i * 3;
  const float xmin = fminf(fminf(v[0], v[2]), v[4]);
  float4* r = rec + i * 4;
  r[0] = make_float4(valid[i] ? xmin : INFINITY,
                     fminf(fminf(v[1], v[3]), v[5]),
                     fmaxf(fmaxf(v[0], v[2]), v[4]),
                     fmaxf(fmaxf(v[1], v[3]), v[5]));
  r[1] = make_float4(v[0], v[1], v[2], v[3]);
  r[2] = make_float4(v[4], v[5], zz[0], zz[1]);
  r[3] = make_float4(zz[2], 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void stage(float4* dst, const float4* src, int n) {
  for (int k = threadIdx.x; k < n * 4; k += THREADS) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + k));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// pc, rr (B, P, 2); rec (B, F, 4) float4; lists (B, splits, knum, P)
// 64-bit keys: each (pixel, split)'s sorted keys, then EMPTY if fewer than
// knum. kSmem: the running lists in shared
// memory ([knum][THREADS]), else in `lists` itself.
template <bool kSmem>
__global__ void __launch_bounds__(THREADS)
deftet_scan_kernel(const float* __restrict__ pc, const float* __restrict__ rr,
                   const float4* __restrict__ rec,
                   long long* __restrict__ lists, int P, int F, int knum,
                   int splits, int tiles, float eps) {
  extern __shared__ long long s_list[];
  __shared__ float4 buf[2][CHUNK * 4];
  const int split = (int)(blockIdx.x % splits);
  const int tile = (int)(blockIdx.x / splits % tiles);
  const int b = (int)(blockIdx.x / splits / tiles);
  const int f0 = (int)((long long)F * split / splits);
  const int f1 = (int)((long long)F * (split + 1) / splits);
  const int lane = threadIdx.x & 31;
  const int i = tile * THREADS + threadIdx.x;
  const bool live = i < P;
  const size_t pix = (size_t)b * P + (live ? i : P - 1);
  const float px = pc[pix * 2], py = pc[pix * 2 + 1];
  const float rmin = rr[pix * 2], rmax = rr[pix * 2 + 1];
  // the box of the warp's live pixels (empty for a warp past P)
  const float bx0 = warp_min(live ? px : INFINITY);
  const float bx1 = warp_max(live ? px : -INFINITY);
  const float by0 = warp_min(live ? py : INFINITY);
  const float by1 = warp_max(live ? py : -INFINITY);
  // this (pixel, split)'s list: in shared memory, or in the scratch
  long long* out = lists + ((size_t)b * splits + split) * knum * P + i;
  long long* list = kSmem ? s_list + threadIdx.x : out;
  const size_t stride = kSmem ? THREADS : (size_t)P;
  int n = 0;                // entries in the list
  long long kth = EMPTY;    // key of the list's last entry once it is full
  const float4* recb = rec + ((size_t)b * F) * 4;

  const int chunks = (f1 - f0 + CHUNK - 1) / CHUNK;
  if (chunks > 0) stage(buf[0], recb + (size_t)f0 * 4, min(CHUNK, f1 - f0));
  for (int c = 0; c < chunks; ++c) {
    const int base = f0 + c * CHUNK;
    const int next = base + CHUNK;
    if (next < f1) {
      stage(buf[(c + 1) & 1], recb + (size_t)next * 4, min(CHUNK, f1 - next));
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float4* t = buf[c & 1];
    const int m = min(CHUNK, f1 - base);
    for (int k0 = 0; k0 < m; k0 += 32) {
      const int kf = k0 + lane;
      bool meets = false;
      if (kf < m) {
        const float4 bb = t[kf * 4];
        meets = bb.x <= bx1 && bb.z > bx0 && bb.y <= by1 && bb.w > by0;
      }
      unsigned queue = __ballot_sync(FULL, meets);
      while (queue) {
        const int k = k0 + __ffs(queue) - 1;
        queue &= queue - 1;
        const float4 bb = t[k * 4];
        if (!(live && px >= bb.x && px < bb.z && py >= bb.y && py < bb.w))
          continue;
        const float4 ab = t[k * 4 + 1], cz = t[k * 4 + 2];
        const float z2 = t[k * 4 + 3].x;
        const float ax = ab.x - px, ay = ab.y - py;
        const float bx = ab.z - px, by = ab.w - py;
        const float cx = cz.x - px, cy = cz.y - py;
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
        const float depth = (w0 * cz.z + w1 * cz.w) + w2 * z2;
        if (!(depth > rmin && depth < rmax)) continue;
        const long long key = (long long)(
            ((unsigned long long)(unsigned)order_key(depth) << 32)
            | (unsigned)~(base + k));
        if (n == knum && key <= kth) continue;
        int pos = n < knum ? n : knum - 1;
        while (pos > 0) {
          const long long prev = list[(pos - 1) * stride];
          if (prev > key) break;
          list[pos * stride] = prev;
          --pos;
        }
        list[pos * stride] = key;
        if (n < knum) ++n;
        if (n == knum) kth = list[(knum - 1) * stride];
      }
    }
    __syncthreads();
  }
  if (!live) return;
  if (kSmem)
    for (int s = 0; s < n; ++s) out[s * (size_t)P] = list[s * stride];
  if (n < knum) out[n * (size_t)P] = EMPTY;
}

// lists (B, splits, knum, P) -> out (B, P, knum) face ids, -1 past the
// last key. One warp per pixel, one lane per split: each step the warp
// takes the largest of its lanes' heads (keys are unique, so one lane
// holds it), and that lane moves on, its next key already loaded. A lane
// reads no slot past its list's EMPTY.
__global__ void __launch_bounds__(256)
deftet_merge_kernel(const long long* __restrict__ lists, int* __restrict__ out,
                    int P, int knum, int splits, long long pixels) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= pixels) return;
  const long long b = i / P, p = i % P;
  const bool mine = lane < splits;
  const long long* l = lists + (b * splits + lane) * (long long)knum * P + p;
  int pos = 0;
  long long head = mine ? l[0] : EMPTY;
  long long next = head != EMPTY && knum > 1 ? l[P] : EMPTY;
  int* o = out + i * knum;
  for (int k = 0; k < knum; ++k) {
    long long top = head;
    for (int off = 16; off > 0; off >>= 1) {
      const long long other = __shfl_xor_sync(FULL, top, off);
      top = other > top ? other : top;
    }
    if (top == EMPTY) {
      for (int j = k + lane; j < knum; j += 32) o[j] = -1;
      break;
    }
    if (lane == 0) o[k] = (int)~(unsigned)top;
    if (head == top) {
      head = next;
      ++pos;
      next = head != EMPTY && pos + 1 < knum ? l[(long long)(pos + 1) * P]
                                             : EMPTY;
    }
  }
}

// The face ranges of a call (see the design above).
int splits_for(int B, int P, int F, int knum) {
  const long long tiles = (long long)B * ((P + THREADS - 1) / THREADS);
  long long s = (SPLIT_BLOCKS + tiles - 1) / (tiles > 0 ? tiles : 1);
  s = s < MAX_SPLITS ? s : MAX_SPLITS;
  s = s < (F + CHUNK - 1) / CHUNK ? s : (F + CHUNK - 1) / CHUNK;
  s = s < MAX_KEYS / knum ? s : MAX_KEYS / knum;
  return s > 1 ? (int)s : 1;
}

// The scratch's bytes: the face records (B, F, 16) float, then the lists
// (B, splits, knum, P) 64-bit.
long long scratch_bytes(int B, int P, int F, int knum) {
  return (long long)B * F * 16 * sizeof(float)
         + (long long)B * splits_for(B, P, F, knum) * knum * P
           * sizeof(long long);
}

}  // namespace

extern "C" {

// The bytes of deftet_topk_forward's scratch, into *bytes (a host
// int64). knum >= 1.
int deftet_topk_scratch(int B, int P, int F, int knum, void* bytes) {
  if (knum < 1 || B < 0 || P < 0 || F < 0) return (int)cudaErrorInvalidValue;
  *(long long*)bytes = scratch_bytes(B, P, F, knum);
  return 0;
}

// pc, rr (B, P, 2), z (B, F, 3), img (B, F, 6) float; valid (B, F) bytes;
// scratch of deftet_topk_scratch's bytes; out (B, P, knum) int32, every
// entry written. knum >= 1.
int deftet_topk_forward(const float* pc, const float* rr, const float* z,
                        const float* img, const void* valid, void* scratch,
                        int* out, int B, int P, int F, int knum, float eps,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (knum < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || P == 0) return (int)cudaGetLastError();
  const int splits = splits_for(B, P, F, knum);
  float* rec = (float*)scratch;
  long long* lists = (long long*)(rec + (size_t)B * F * 16);
  const cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (P + THREADS - 1) / THREADS;
  const long long blocks = (long long)splits * tiles * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool in_smem = knum <= SMEM_KNUM;
  const size_t smem = in_smem ? (size_t)knum * THREADS * sizeof(long long) : 0;
  // the lists and the stage past the 48 KB a block gets unasked
  if (smem + 2 * CHUNK * 4 * sizeof(float4) > 48 * 1024) {
    err = cudaFuncSetAttribute(deftet_scan_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long faces = (long long)B * F, pixels = (long long)B * P;
  if (faces > 0)
    deftet_prepare_kernel<<<(unsigned)((faces + 255) / 256), 256, 0, s>>>(
        z, img, (const unsigned char*)valid, (float4*)rec, faces);
  if (in_smem) {
    deftet_scan_kernel<true><<<(unsigned)blocks, THREADS, smem, s>>>(
        pc, rr, (const float4*)rec, lists, P, F, knum, splits, tiles, eps);
  } else {
    deftet_scan_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        pc, rr, (const float4*)rec, lists, P, F, knum, splits, tiles, eps);
  }
  deftet_merge_kernel<<<(unsigned)((pixels * 32 + 255) / 256), 256, 0, s>>>(
      lists, out, P, knum, splits, pixels);
  return (int)cudaGetLastError();
}

}  // extern "C"
