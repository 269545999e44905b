// Nearest-neighbour indices, brute force and pruned, one thread per query.
//
// Replaces the TPU kernels kaolin_tpu/kernels/nn_distance.py
// nearest_idx_pallas (brute force) and the range scan of
// nearest_idx_pruned. The pruned prepass (Morton sort, chunk boxes, lower
// and upper bounds, chunk ranges and the flags of the chunks they keep)
// stays in PyTorch on the card, in kaolin_tpu_torch/kernels/nn_distance.py;
// this file takes its output and skips a chunk whose flag is 0.
// The Pallas kernels hold the whole reference cloud in VMEM (at most 640k
// points); these stage it through shared memory a chunk at a time and
// take any size.
//
// Distance and ties, as the plain PyTorch version (nearest_idx_plain) and
// the JAX package's XLA scan: d = p - q, then (dx*dx + dy*dy) + dz*dz,
// compiled with --fmad=false so that no product is fused into a sum.
// Brute force scans the references in index order and takes a distance
// only when it is strictly smaller, so ties keep the lowest index, and the
// index is 0 until a distance is taken (every distance inf or NaN). The
// pruned scan sees the references in Morton order, so it breaks ties on
// the original index: (d < best) | (d == best & orig < best_orig). Pads
// repeat the last sorted point with an original index of at least N2, so a
// real point always wins their ties; a winner still at the sentinel (every
// distance inf or NaN) is written as 0, as brute force gives.
//
// What bounds it on an H100: operations. 9 float operations per (query,
// reference) pair (3 subtractions, 3 products, 2 sums, 1 compare), 10^10
// pairs at config 3's 100k x 100k: 1.34 ms at 67 TFLOP/s; the bytes (12 per
// point in, 4 per query out) are a few megabytes. The design keeps each
// thread's query and its running (best, index) in registers and reads the
// references from shared memory, where the whole warp reads one address at
// a time (a broadcast). Nothing more yet: register blocking over several
// queries per thread and splitting the references across blocks are later
// work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // queries per block = the pruned query tile
constexpr int CHUNK = 1024;    // references staged per pass, brute force
constexpr int PCHUNK = 512;    // references per pruned chunk

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float rx, float ry, float rz) {
  const float dx = qx - rx, dy = qy - ry, dz = qz - rz;
  return (dx * dx + dy * dy) + dz * dz;
}

// p1 (B, N1, 3), p2 (B, N2, 3); idx (B, N1)
__global__ void __launch_bounds__(THREADS)
nn_brute_kernel(const float* __restrict__ p1, const float* __restrict__ p2,
                int* __restrict__ idx, int N1, int N2) {
  __shared__ float sx[CHUNK], sy[CHUNK], sz[CHUNK];
  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  // threads past N1 load the last query and write nothing, so that every
  // thread reaches the barriers
  const float* q = p1 + ((size_t)b * N1 + min(i, N1 - 1)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  const float* ref = p2 + (size_t)b * N2 * 3;
  float best = INFINITY;
  int best_i = 0;
  for (int base = 0; base < N2; base += CHUNK) {
    const int n = min(CHUNK, N2 - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += THREADS) {
      const float* r = ref + (size_t)(base + k) * 3;
      sx[k] = r[0];
      sy[k] = r[1];
      sz[k] = r[2];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float d = sq_dist(qx, qy, qz, sx[k], sy[k], sz[k]);
      if (d < best) {
        best = d;
        best_i = base + k;
      }
    }
  }
  if (i < N1) idx[(size_t)b * N1 + i] = best_i;
}

// One block per tile of THREADS Morton-sorted queries.
// p1s (B, C1 * THREADS, 3) sorted queries and q_orig (B, C1 * THREADS) their
// original indices (pads >= N1); p2s (B, C2 * PCHUNK, 3) sorted references
// and r_orig (B, C2 * PCHUNK) theirs (pads >= N2); starts, nums (B, C1) the
// chunk range of each tile and keep (B, C1, C2) its chunks' flags; out
// (B, N1), written at each query's original index.
__global__ void __launch_bounds__(THREADS)
nn_pruned_kernel(const float* __restrict__ p1s, const int* __restrict__ q_orig,
                 const float* __restrict__ p2s,
                 const int* __restrict__ r_orig,
                 const int* __restrict__ starts, const int* __restrict__ nums,
                 const unsigned char* __restrict__ keep,
                 int* __restrict__ out, int N1, int N2, int C1, int C2) {
  __shared__ float sx[PCHUNK], sy[PCHUNK], sz[PCHUNK];
  __shared__ int so[PCHUNK];
  const int b = blockIdx.y, tile = blockIdx.x;
  const size_t qi = (size_t)b * C1 * THREADS + (size_t)tile * THREADS
                    + threadIdx.x;
  const float qx = p1s[qi * 3], qy = p1s[qi * 3 + 1], qz = p1s[qi * 3 + 2];
  const int start = starts[(size_t)b * C1 + tile];
  const int stop = min(start + nums[(size_t)b * C1 + tile], C2);
  const float* ref = p2s + (size_t)b * C2 * PCHUNK * 3;
  const int* orig = r_orig + (size_t)b * C2 * PCHUNK;
  const unsigned char* flags = keep + ((size_t)b * C1 + tile) * C2;
  float best = INFINITY;
  int best_o = INT32_MAX;
  for (int c = max(start, 0); c < stop; ++c) {
    if (!flags[c]) continue;   // the same for every thread of the block
    __syncthreads();
    for (int k = threadIdx.x; k < PCHUNK; k += THREADS) {
      const size_t r = (size_t)c * PCHUNK + k;
      sx[k] = ref[r * 3];
      sy[k] = ref[r * 3 + 1];
      sz[k] = ref[r * 3 + 2];
      so[k] = orig[r];
    }
    __syncthreads();
    for (int k = 0; k < PCHUNK; ++k) {
      const float d = sq_dist(qx, qy, qz, sx[k], sy[k], sz[k]);
      const int o = so[k];
      if (d < best || (d == best && o < best_o)) {
        best = d;
        best_o = o;
      }
    }
  }
  const int o = q_orig[qi];
  if (o >= 0 && o < N1) out[(size_t)b * N1 + o] = best_o < N2 ? best_o : 0;
}

}  // namespace

extern "C" {

// idx (B, N1) int32, every entry written.
int nearest_idx_forward(const float* p1, const float* p2, int* idx, int B,
                        int N1, int N2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || N1 == 0) return (int)cudaGetLastError();
  const dim3 grid((N1 + THREADS - 1) / THREADS, B);
  nn_brute_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p1, p2, idx, N1,
                                                              N2);
  return (int)cudaGetLastError();
}

// tile and chunk must be the THREADS and PCHUNK above (the prepass's
// sizes); out (B, N1) int32, every entry written once.
int nearest_idx_pruned_forward(const float* p1s, const int* q_orig,
                               const float* p2s, const int* r_orig,
                               const int* starts, const int* nums,
                               const unsigned char* keep, int* out, int B,
                               int N1, int N2, int C1, int C2, int tile,
                               int chunk, int device, void* stream) {
  if (tile != THREADS || chunk != PCHUNK) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || C1 == 0) return (int)cudaGetLastError();
  const dim3 grid(C1, B);
  nn_pruned_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      p1s, q_orig, p2s, r_orig, starts, nums, keep, out, N1, N2, C1, C2);
  return (int)cudaGetLastError();
}

}  // extern "C"
