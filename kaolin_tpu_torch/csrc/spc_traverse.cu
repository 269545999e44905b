// SPC ray traversal: every (ray, leaf point) hit of an octree at a target
// level, ray-major and near to far, with entry (and exit) depths.
//
// Replaces the TPU kernels kaolin_tpu/kernels/spc_traverse.py
// traverse_banded_cc (its _cc_level_call) and traverse_banded (its
// make_level_call): both meet one contract, and this traversal meets it.
// The TPU kernels' banded windows, one-hot matmul gathers and per-level
// sorts exist because the TPU has no fast gather; they also run on
// buffers of fixed size, planned ahead (plan_raytrace,
// schedule_from_counts). The H100 gathers, so the traversal is the
// level-synchronous breadth-first one of the reference CUDA
// (kaolin/csrc/render/spc/raytrace_cuda.cu): the frontier is a list of
// (ray, node) nuggets, and each level tests every nugget's existing
// children and compacts the hits, in (nugget, near-to-far rank) order,
// into the next level's frontier.
//
// What bounds it on an H100: latency and the host, not bytes. Per nugget
// and level it reads a ray (24 bytes), a node byte, its exsum and coords
// (11 bytes) and writes 8 bytes a hit; about 120 float operations a
// tested child: at config 5 (65,536 rays, level 8, 65,536-101,496 nuggets
// a level) the card's bound is 2 us a trace. A design that sizes each
// level from its total, read on the host (the reference's, and this
// port's first), pays a host sync and about 8 launches and fills a level:
// a 1 ms trace for 0.15 ms of card time.
//
// This design runs each level as one kernel, spc_level_kernel, with no
// host read between levels. A persistent grid takes tiles of TILE
// nuggets in ticket order; a block tests its nuggets' children (the
// origin's octant code picks the rank order, raytrace.py:396-398; the
// slab test as raytrace.py _ray_aabb), scans its counts in shared memory,
// takes its output offset by a decoupled look-back over the tiles in
// nugget order (lookback.cuh), and writes its hits there at once: each
// hit's ray, child id exsum[node] + popcount(bits & ((2 << octant) - 1))
// and, at the last level, its entry (and exit) depth. So the output keeps
// the XLA path's order (ray-major, near to far in VOXEL_ORDER) with no
// sort. The frontier's size stays on the card: the kernel reads it from
// the count the previous level's last tile wrote, and blocks past it
// stop. The last tile writes the level's true total, hits past the
// capacity included.
//
// The buffers come from the shapes. Level l's frontier holds at most
// C_l = min(8 C_{l-1}, R (3 * 2^l - 2), budget) nuggets (C_0 = R rays; a
// ray crosses at most 3 * 2^k - 2 cells of a 2^k grid), and the last
// level at most cap rows where the caller gives one; hits past a
// capacity are not written. After the last level the host reads the
// totals once: a level whose total passed its capacity (only the budget
// can bind) makes the wrapper run the trace again with each level sized
// exactly from its total (kernels/spc_traverse.py), with the same kernel.
// At the last level with a cap, the blocks write -1 / 0 past the count
// once the last tile has published it; nothing else is filled.
//
// Hit rules, as the XLA path: before the last level a child counts when
// its entry is not 0 (an origin inside the cell counts); at the last level
// when its entry is > 0, and with exit depths also its exit. Level 0 is
// the root cell alone (raytrace.py:312-336). The slab test repeats the
// XLA path's operations in their order (signbit for the sign, 1/d in IEEE)
// and is compiled with --fmad=false, so that no product is fused into a
// sum.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

// nuggets a tile, one a thread
constexpr int TILE = 256;

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

// One level over the frontier (in_r, in_p): n nuggets, n_host where the
// caller knows it, else min(*n_dev, cap_in). Writes the hits at most
// cap_out of them into (out_r, out_p) and, at the last level, out_depth
// (cap_out, 1 or 2); *total gets the level's true total. pad: at the last
// level, rows past min(total, cap_out) get -1 / 0. root: the target level
// is 0, the root cell alone. in_r null: the frontier is the rays 0 .. n-1
// at the root node (level 0).
__global__ void __launch_bounds__(TILE)
spc_level_kernel(const unsigned char* __restrict__ octree,
                 const int* __restrict__ exsum, const short* __restrict__ ph,
                 const float* __restrict__ origin,
                 const float* __restrict__ dir,
                 const int* __restrict__ in_r, const int* __restrict__ in_p,
                 const int* __restrict__ n_dev, int n_host, int cap_in,
                 int l, int last, int with_exit, int root,
                 int* __restrict__ total, int* __restrict__ ticket,
                 unsigned long long* __restrict__ status,
                 int* __restrict__ out_r, int* __restrict__ out_p,
                 float* __restrict__ out_depth, int cap_out, int pad) {
  __shared__ int s_tile;
  __shared__ int s_warp[32];
  __shared__ int s_base;
  const int n = n_dev ? min(*n_dev, cap_in) : n_host;
  const int ntiles = (n + TILE - 1) / TILE;
  const int ncols = with_exit ? 2 : 1;
  while (true) {
    const int tile = lookback::take_ticket(ticket, &s_tile);
    if (tile >= ntiles) break;
    const int i = tile * TILE + threadIdx.x;
    int r = 0, node = 0, cnt = 0, base = 0;
    unsigned m = 0, bits = 0;
    Ray ray;
    Cell c;
    if (i < n) {
      r = in_r ? in_r[i] : i;
      ray = load_ray(origin, dir, r);
      if (root) {
        m = last_hit(ray_aabb(ray, 1.f, 0.f, 0.f, 0.f, 1.f), ray, nullptr,
                     0, with_exit) ? 1u : 0u;
        cnt = (int)m;
      } else {
        node = in_p ? in_p[i] : 0;
        bits = octree[node];
        base = exsum[node];   // loaded now, used after the look-back
        c = load_cell(ph, node, l, ray);
        for (int rank = 0; rank < 8; ++rank) {
          const int oct = c_order[c.code * 8 + rank];
          if (!((bits >> oct) & 1u)) continue;
          const float e = child_aabb(ray, c, oct, 1.f);
          if (last ? last_hit(e, ray, &c, oct, with_exit) : e != 0.f) {
            m |= 1u << rank;
            ++cnt;
          }
        }
      }
    }
    int agg;
    const int ex = lookback::block_exclusive_scan(cnt, s_warp, &agg);
    if (threadIdx.x < 32) {
      const int before = (int)lookback::exclusive_prefix(
          status, tile, (unsigned long long)agg);
      if (threadIdx.x == 0) {
        s_base = before;
        if (tile == ntiles - 1) *total = before + agg;
      }
    }
    __syncthreads();
    int pos = s_base + ex;
    if (m && pos < cap_out) {
      if (root) {
        out_r[pos] = r;
        out_p[pos] = 0;
        out_depth[(size_t)pos * ncols] =
            ray_aabb(ray, 1.f, 0.f, 0.f, 0.f, 1.f);
        if (with_exit)
          out_depth[(size_t)pos * ncols + 1] =
              ray_aabb(ray, -1.f, 0.f, 0.f, 0.f, 1.f);
      } else {
        for (int rank = 0; rank < 8 && pos < cap_out; ++rank) {
          if (!((m >> rank) & 1u)) continue;
          const int oct = c_order[c.code * 8 + rank];
          out_r[pos] = r;
          out_p[pos] = base + __popc(bits & ((2u << oct) - 1u));
          if (last) {
            out_depth[(size_t)pos * ncols] = child_aabb(ray, c, oct, 1.f);
            if (with_exit)
              out_depth[(size_t)pos * ncols + 1] =
                  child_aabb(ray, c, oct, -1.f);
          }
          ++pos;
        }
      }
    }
    __syncthreads();   // s_tile and s_base are written again
  }
  if (!pad) return;
  // past the count: -1 / 0, once the last tile has published the total
  if (threadIdx.x == 0)
    s_base = ntiles ? (int)lookback::wait_prefix(status, ntiles - 1) : 0;
  __syncthreads();
  const size_t stride = (size_t)gridDim.x * TILE;
  for (size_t k = min(s_base, cap_out) + (size_t)blockIdx.x * TILE
                  + threadIdx.x;
       k < (size_t)cap_out; k += stride) {
    out_r[k] = -1;
    out_p[k] = -1;
    for (int col = 0; col < ncols; ++col) out_depth[k * ncols + col] = 0.f;
  }
}

// Launches one level (see spc_level_kernel) on a persistent grid of as
// many blocks as fit on the card at once. state: the look-back's, zeroed:
// a ticket (8 bytes), then a status word a tile of TILE nuggets of cap_in.
cudaError_t launch_level(const unsigned char* octree, const int* exsum,
                         const short* ph, const float* origin,
                         const float* dir, const int* in_r, const int* in_p,
                         const int* n_dev, int n_host, int cap_in, int l,
                         int last, int with_exit, int root, int* total,
                         void* state, int* out_r, int* out_p,
                         float* out_depth, int cap_out, int pad, int device,
                         cudaStream_t stream) {
  static int max_blocks[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (max_blocks[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, spc_level_kernel, TILE, 0);
    if (err != cudaSuccess) return err;
    max_blocks[device] = max(1, sms * per_sm);
  }
  const int tiles = (cap_in + TILE - 1) / TILE;
  const int blocks = max(1, min(tiles, max_blocks[device]));
  spc_level_kernel<<<blocks, TILE, 0, stream>>>(
      octree, exsum, ph, origin, dir, in_r, in_p, n_dev, n_host, cap_in, l,
      last, with_exit, root, total, (int*)state,
      (unsigned long long*)((char*)state + 8), out_r, out_p, out_depth,
      cap_out, pad);
  return cudaGetLastError();
}

// int32 words of one level's look-back state over cap_in nuggets
size_t state_ints(int cap_in) {
  return 2 + 2 * (size_t)((cap_in + TILE - 1) / TILE);
}

}  // namespace

extern "C" {

// One level (see spc_level_kernel) with the caller's buffers; state:
// state_words int32 words, zeroed, at least 2 + 2 * ceil(cap_in / TILE)
// (cudaErrorInvalidValue, and no launch, where fewer).
int spc_traverse_level(const unsigned char* octree, const int* exsum,
                       const short* ph, const float* origin,
                       const float* dir, const int* in_r, const int* in_p,
                       const int* n_dev, int n_host, int cap_in, int l,
                       int last, int with_exit, int root, int* total,
                       void* state, int state_words, int* out_r,
                       int* out_p, float* out_depth, int cap_out, int pad,
                       int device, void* stream) {
  if (state_ints(cap_in) > (size_t)state_words)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_level(octree, exsum, ph, origin, dir, in_r, in_p,
                           n_dev, n_host, cap_in, l, last, with_exit, root,
                           total, state, out_r, out_p, out_depth, cap_out,
                           pad, device, (cudaStream_t)stream);
}

// A whole trace of nlev levels in one call: caps (host, nlev + 1 ints) the
// frontiers' rows, caps[0] the rays. meta (meta_words int32 words):
// `head` words, the levels' totals at 1 .. nlev, then each level's state
// (state_ints(caps[l]) words); zeroed here, cudaErrorInvalidValue and no
// launch where it is shorter. front: two frontiers of `inner` nuggets, each a
// row of ray ids then a row of node ids; out: the last level's ray ids,
// then its point ids (caps[nlev] each); depth (caps[nlev], 1 or 2). pad:
// -1 / 0 past the count at the last level. One memset and nlev launches.
int spc_traverse_levels(const unsigned char* octree, const int* exsum,
                        const short* ph, const float* origin,
                        const float* dir, int nlev, int with_exit, int root,
                        const int* caps, int* meta, int meta_words,
                        int head, int* front, int inner, int* out,
                        float* depth, int pad, int device, void* stream) {
  size_t words = head;
  for (int l = 0; l < nlev; ++l) words += state_ints(caps[l]);
  if (words > (size_t)meta_words) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(meta, 0, words * 4, s);
  if (err != cudaSuccess) return (int)err;
  size_t off = head;
  for (int l = 0; l < nlev; ++l) {
    const bool last = l == nlev - 1;
    int* src = l == 0 ? nullptr : front + (size_t)((l - 1) % 2) * 2 * inner;
    int* dst = last ? out : front + (size_t)(l % 2) * 2 * inner;
    err = launch_level(octree, exsum, ph, origin, dir, src,
                       src ? src + inner : nullptr,
                       l == 0 ? nullptr : meta + l, caps[0], caps[l], l,
                       last, with_exit, root, meta + l + 1, meta + off, dst,
                       last ? out + caps[nlev] : dst + inner,
                       last ? depth : nullptr, caps[l + 1], last && pad,
                       device, s);
    if (err != cudaSuccess) return (int)err;
    off += state_ints(caps[l]);
  }
  return 0;
}

}  // extern "C"
