// SPC ray traversal: every (ray, leaf point) hit of an octree at a target
// level, ray-major and near to far, with entry (and exit) depths.
//
// Replaces the TPU kernels kaolin_tpu/kernels/spc_traverse.py
// traverse_banded_cc (its _cc_level_call) and traverse_banded (its
// make_level_call): both meet one contract, and this traversal meets it.
// The design is the level-synchronous breadth-first one of the reference
// CUDA (kaolin/csrc/render/spc/raytrace_cuda.cu). The frontier is a list
// of (ray, node) nuggets; per level:
//   1. spc_decide_kernel, one thread per nugget: reads the node's byte,
//      its exsum and its coords (from the point hierarchy) and the ray,
//      forms the ray origin's octant code (raytrace.py:396-398), tests the
//      node's existing children in VOXEL_ORDER rank with the slab test
//      (raytrace.py _ray_aabb), and writes a hit mask (bits 0-7 by rank,
//      the code in bits 8-10) and the number of hits;
//   2. an exclusive scan of the counts, written here: a scan of each
//      block of SCAN_BLOCK counts, a scan of the block sums, then an add;
//      its last entry is the level's total, which the host reads once per
//      level to size the next buffers (as the reference CUDA does);
//   3. spc_emit_kernel: writes each hit at its offset in rank order, its
//      ray and child id exsum[node] + popcount(bits & ((2 << octant) - 1))
//      and, at the last level, its entry (and exit) depth.
// Parents stay ray-major and near to far, so the output takes the XLA
// path's order (kaolin_tpu/render/spc/raytrace.py
// unbatched_raytrace_fixed) with no final sort. The TPU kernels' banded
// windows, one-hot matmul gathers and per-level sorts exist because the
// TPU has no fast gather and no dynamic buffer sizes; neither limit holds
// here.
//
// Hit rules, as the XLA path: before the last level a child counts when
// its entry is not 0 (an origin inside the cell counts); at the last level
// when its entry is > 0, and with exit depths also its exit. Level 0 is
// the root cell alone (raytrace.py:312-336). The slab test repeats the
// XLA path's operations in their order (signbit for the sign, 1/d in IEEE)
// and is compiled with --fmad=false, so that no product is fused into a
// sum.
//
// What bounds it on an H100: bytes and latency. Per nugget and level it
// reads a ray (24 bytes), a node byte, its exsum and coords (11 bytes) and
// writes 8 bytes per child hit; about 120 float operations per tested
// child. The host read per level and the ~4 launches per level bound a
// trace at small frontiers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_BLOCK = SCAN_THREADS * SCAN_ITEMS;
constexpr int SUM_THREADS = 1024;

// VOXEL_ORDER[code][rank]: octants sorted by (popcount(o ^ code), o)
// (raytrace_cuda.cu:48-57)
__constant__ unsigned char c_order[64] = {
    0, 1, 2, 4, 3, 5, 6, 7,
    1, 0, 3, 5, 2, 4, 7, 6,
    2, 0, 3, 6, 1, 4, 7, 5,
    3, 1, 2, 7, 0, 5, 6, 4,
    4, 0, 5, 6, 1, 2, 7, 3,
    5, 1, 4, 7, 0, 3, 6, 2,
    6, 2, 4, 7, 0, 3, 5, 1,
    7, 3, 5, 6, 1, 2, 4, 0,
};

struct Ray {
  float o[3], d[3], inv[3], sgn[3];
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin,
                                        const float* __restrict__ dir,
                                        int r) {
  Ray ray;
  for (int a = 0; a < 3; ++a) {
    ray.o[a] = origin[(size_t)r * 3 + a];
    ray.d[a] = dir[(size_t)r * 3 + a];
    ray.inv[a] = 1.0f / ray.d[a];
    ray.sgn[a] = signbit(ray.d[a]) ? 1.f : -1.f;
  }
  return ray;
}

// The slab test (spc_render_utils.cuh ray_aabb; raytrace.py _ray_aabb) of
// the cell centred at c with half-size r: 0 = miss, > 0 = entry distance,
// < 0 = the origin inside. s = +1 for the entry, -1 for the exit (the sign
// of -d).
__device__ __forceinline__ float ray_aabb(const Ray& ray, float s, float cx,
                                          float cy, float cz, float r) {
  const float ocx = ray.o[0] - cx, ocy = ray.o[1] - cy, ocz = ray.o[2] - cz;
  // max(|oc|) < r, false on NaN as the max would propagate it
  const bool inside = fabsf(ocx) < r && fabsf(ocy) < r && fabsf(ocz) < r;
  const float w = inside ? -r : r;
  const float d0 = (w * (s * ray.sgn[0]) - ocx) * ray.inv[0];
  const float d1 = (w * (s * ray.sgn[1]) - ocy) * ray.inv[1];
  const float d2 = (w * (s * ray.sgn[2]) - ocz) * ray.inv[2];
  const float ltxy = ray.d[1] * d0 + ocy;
  const float ltxz = ray.d[2] * d0 + ocz;
  const float ltyx = ray.d[0] * d1 + ocx;
  const float ltyz = ray.d[2] * d1 + ocz;
  const float ltzx = ray.d[0] * d2 + ocx;
  const float ltzy = ray.d[1] * d2 + ocy;
  const bool t0 = d0 >= 0.f && fabsf(ltxy) <= r && fabsf(ltxz) <= r;
  const bool t1 = d1 >= 0.f && fabsf(ltyx) <= r && fabsf(ltyz) <= r;
  const bool t2 = d2 >= 0.f && fabsf(ltzx) <= r && fabsf(ltzy) <= r;
  const float dist = t0 ? d0 : (t1 ? d1 : (t2 ? d2 : 0.f));
  return inside ? w : dist;
}

// A node's cell at level l: centre, the children's half-size and the
// corner offset of child octant 0 (vc - rc).
struct Cell {
  float lo[3];
  float r, rc;
  int code;
};

__device__ __forceinline__ Cell load_cell(const short* __restrict__ ph,
                                          int node, int l, const Ray& ray) {
  Cell c;
  c.r = ldexpf(1.f, -l);
  c.rc = c.r * 0.5f;
  int code = 0;
  for (int a = 0; a < 3; ++a) {
    const float p = (float)ph[(size_t)node * 3 + a];
    const float vc = c.r * (2.f * p + 1.f) - 1.f;
    c.lo[a] = vc - c.rc;
    const float frac = (0.5f * ray.o[a] + 0.5f) - c.r * (p + 0.5f);
    code = code * 2 + (frac > 0.f ? 1 : 0);
  }
  c.code = code;
  return c;
}

// entry (s = +1) or exit (s = -1) of the child in octant oct
__device__ __forceinline__ float child_aabb(const Ray& ray, const Cell& c,
                                            int oct, float s) {
  return ray_aabb(ray, s, c.lo[0] + c.r * (float)((oct >> 2) & 1),
                  c.lo[1] + c.r * (float)((oct >> 1) & 1),
                  c.lo[2] + c.r * (float)(oct & 1), c.rc);
}

// Does a ray hit the cell under the level's rule? (root: the root cell
// itself at level 0)
__device__ __forceinline__ bool last_hit(float entry, const Ray& ray,
                                         const Cell* c, int oct,
                                         int with_exit) {
  if (!(entry > 0.f)) return false;
  if (!with_exit) return true;
  const float ex = c ? child_aabb(ray, *c, oct, -1.f)
                     : ray_aabb(ray, -1.f, 0.f, 0.f, 0.f, 1.f);
  return ex > 0.f;
}

__global__ void __launch_bounds__(THREADS)
spc_decide_kernel(const unsigned char* __restrict__ octree,
                  const short* __restrict__ ph,
                  const float* __restrict__ origin,
                  const float* __restrict__ dir,
                  const int* __restrict__ ridx, const int* __restrict__ pidx,
                  int n, int l, int last, int with_exit, int root,
                  int* __restrict__ counts,
                  unsigned short* __restrict__ hits) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const Ray ray = load_ray(origin, dir, ridx[i]);
  if (root) {
    const bool hit = last_hit(ray_aabb(ray, 1.f, 0.f, 0.f, 0.f, 1.f), ray,
                              nullptr, 0, with_exit);
    counts[i] = hit ? 1 : 0;
    hits[i] = hit ? 1 : 0;
    return;
  }
  const int node = pidx[i];
  const unsigned bits = octree[node];
  const Cell c = load_cell(ph, node, l, ray);
  unsigned m = 0;
  int cnt = 0;
  for (int rank = 0; rank < 8; ++rank) {
    const int oct = c_order[c.code * 8 + rank];
    if (!((bits >> oct) & 1u)) continue;
    const float e = child_aabb(ray, c, oct, 1.f);
    const bool hit = last ? last_hit(e, ray, &c, oct, with_exit) : e != 0.f;
    if (hit) {
      m |= 1u << rank;
      ++cnt;
    }
  }
  counts[i] = cnt;
  hits[i] = (unsigned short)(m | ((unsigned)c.code << 8));
}

__global__ void __launch_bounds__(THREADS)
spc_emit_kernel(const unsigned char* __restrict__ octree,
                const int* __restrict__ exsum, const short* __restrict__ ph,
                const float* __restrict__ origin,
                const float* __restrict__ dir, const int* __restrict__ ridx,
                const int* __restrict__ pidx, int n, int l, int last,
                int with_exit, int root,
                const unsigned short* __restrict__ hits,
                const int* __restrict__ offsets, int* __restrict__ out_ridx,
                int* __restrict__ out_pidx, float* __restrict__ out_depth,
                int cap) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const unsigned h = hits[i];
  const unsigned m = h & 0xffu;
  int pos = offsets[i];
  if (!m || pos >= cap) return;
  const int r = ridx[i];
  const int ncols = with_exit ? 2 : 1;
  if (root) {
    const Ray ray = load_ray(origin, dir, r);
    out_ridx[pos] = r;
    out_pidx[pos] = 0;
    out_depth[(size_t)pos * ncols] = ray_aabb(ray, 1.f, 0.f, 0.f, 0.f, 1.f);
    if (with_exit)
      out_depth[(size_t)pos * ncols + 1] =
          ray_aabb(ray, -1.f, 0.f, 0.f, 0.f, 1.f);
    return;
  }
  const int node = pidx[i];
  const unsigned bits = octree[node];
  const int base = exsum[node];
  const int code = (int)(h >> 8);
  Ray ray;
  Cell c;
  if (last) {
    ray = load_ray(origin, dir, r);
    c = load_cell(ph, node, l, ray);
  }
  for (int rank = 0; rank < 8 && pos < cap; ++rank) {
    if (!((m >> rank) & 1u)) continue;
    const int oct = c_order[code * 8 + rank];
    out_ridx[pos] = r;
    out_pidx[pos] = base + __popc(bits & ((2u << oct) - 1u));
    if (last) {
      out_depth[(size_t)pos * ncols] = child_aabb(ray, c, oct, 1.f);
      if (with_exit)
        out_depth[(size_t)pos * ncols + 1] = child_aabb(ray, c, oct, -1.f);
    }
    ++pos;
  }
}

// Exclusive scan of v over the block (blockDim.x a multiple of 32, at
// most 1024); *total gets the block's sum. s_warp holds 32 ints.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_warp,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();   // s_warp may still be read from a previous call
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nwarps) s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[nwarps - 1];
  return (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
}

// out[e] = sum of in[0 .. e) within this block of SCAN_BLOCK entries, for
// e in [0, n] (in[n] reads as 0); sums[block] = the block's total.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_blocks_kernel(const int* __restrict__ in, int* __restrict__ out, int n,
                   int* __restrict__ sums) {
  __shared__ int s_warp[32];
  const int base = blockIdx.x * SCAN_BLOCK + threadIdx.x * SCAN_ITEMS;
  int v[SCAN_ITEMS];
  int s = 0;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const int e = base + j;
    v[j] = e < n ? in[e] : 0;
    s += v[j];
  }
  int total;
  int ex = block_exclusive_scan(s, s_warp, &total);
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const int e = base + j;
    if (e <= n) out[e] = ex;
    ex += v[j];
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// Exclusive scan of the nb block sums in place, by one block.
__global__ void __launch_bounds__(SUM_THREADS)
scan_sums_kernel(int* __restrict__ sums, int nb) {
  __shared__ int s_warp[32];
  int carry = 0;
  for (int base = 0; base < nb; base += SUM_THREADS) {
    const int e = base + threadIdx.x;
    const int v = e < nb ? sums[e] : 0;
    int total;
    const int ex = block_exclusive_scan(v, s_warp, &total);
    if (e < nb) sums[e] = carry + ex;
    carry += total;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_add_kernel(int* __restrict__ out, int n, const int* __restrict__ sums) {
  const int add = sums[blockIdx.x];
  const int base = blockIdx.x * SCAN_BLOCK + threadIdx.x * SCAN_ITEMS;
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    const int e = base + j;
    if (e <= n) out[e] += add;
  }
}

}  // namespace

extern "C" {

// Decides one level over the n nuggets (ridx, pidx) and scans the counts:
// counts (n,) and hits (n,) uint16 per nugget, offsets (n + 1,) with
// offsets[n] the level's total; sums holds (n + SCAN_BLOCK) / SCAN_BLOCK
// ints of scratch. root: the target level is 0 (the root cell alone).
int spc_traverse_decide(const unsigned char* octree, const short* ph,
                        const float* origin, const float* dir,
                        const int* ridx, const int* pidx, int n, int l,
                        int last, int with_exit, int root, int* counts,
                        unsigned short* hits, int* offsets, int* sums,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    spc_decide_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        octree, ph, origin, dir, ridx, pidx, n, l, last, with_exit, root,
        counts, hits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int nb = n / SCAN_BLOCK + 1;   // blocks over the n + 1 entries
  scan_blocks_kernel<<<nb, SCAN_THREADS, 0, s>>>(counts, offsets, n, sums);
  err = cudaGetLastError();
  if (err != cudaSuccess || nb == 1) return (int)err;
  scan_sums_kernel<<<1, SUM_THREADS, 0, s>>>(sums, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_add_kernel<<<nb, SCAN_THREADS, 0, s>>>(offsets, n, sums);
  return (int)cudaGetLastError();
}

// Writes each hit of the n nuggets at its offset, in rank order: out_ridx
// and out_pidx (cap,), and at the last level out_depth (cap, 1 or 2);
// hits past cap are not written.
int spc_traverse_emit(const unsigned char* octree, const int* exsum,
                      const short* ph, const float* origin, const float* dir,
                      const int* ridx, const int* pidx, int n, int l,
                      int last, int with_exit, int root,
                      const unsigned short* hits, const int* offsets,
                      int* out_ridx, int* out_pidx, float* out_depth,
                      int cap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || cap == 0) return (int)cudaGetLastError();
  spc_emit_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                    (cudaStream_t)stream>>>(
      octree, exsum, ph, origin, dir, ridx, pidx, n, l, last, with_exit,
      root, hits, offsets, out_ridx, out_pidx, out_depth, cap);
  return (int)cudaGetLastError();
}

}  // extern "C"
