// Point-to-mesh closest face and distance type.
//
// Replaces the TPU kernel kaolin_tpu/kernels/p2m_distance.py
// p2m_select_pallas. That kernel reads a (40, F) table of per-face
// constants held in VMEM (at most 65,536 faces) and multiplies by
// reciprocal edge lengths; it agrees with the JAX package's XLA scan only
// up to float ties. These kernels follow the XLA path instead
// (kaolin_tpu/metrics/trianglemesh.py _classify_and_distance and
// _select_faces), operation for operation as the plain PyTorch version
// (kaolin_tpu_torch/kernels/p2m_distance.py p2m_select_plain) writes it,
// under --fmad=false, so that face indices and types equal the plain
// version's, ties included. They take any number of faces.
//
// Per (point, face) pair, with v1, v2, v3 the face's vertices:
//   e21 = v2 - v1, e32 = v3 - v2, e13 = v1 - v3, n = -cross(e21, e13)
//   uab = dot(p - v1, e21) / dot(e21, e21)      (a division, as XLA)
//   ubc = dot(p - v2, e32) / dot(e32, e32)
//   uca = dot(p - v3, e13) / dot(e13, e13)
//   flags 1-3 (vertex regions) and 4-6 (edge regions, with
//   dot(cross(n, e), p - v) <= 0); the type is the SUM of the raised
//   flags' numbers (4 + 6 = 10 where two edge regions overlap);
//   the closest point is the first raised flag's (v1, v2, v3, then the
//   three edge points v + e * u), else the plane point
//   p - n/|n| * dot(p - v1, n/|n|);
//   dist = dot(closest - p, closest - p), and a NaN distance (a degenerate
//   face) counts as inf.
// dot(a, b) = (a.x*b.x + a.y*b.y) + a.z*b.z and cross(a, b) =
// (a.y*b.z - a.z*b.y, a.z*b.x - a.x*b.z, a.x*b.y - a.y*b.x), in jnp.cross's
// order. The winner is the face of the smallest distance, the lowest id
// among equal ones (the plain version's scan in index order, taking only
// strictly smaller distances); with every distance inf it is face 0, type
// 0.
//
// What bounds it on an H100: operations, about 75 float operations per
// pair (3 of them divisions) over 10^9 pairs at config 3's 100k points and
// 10k faces: 1.1 ms at 67 TFLOP/s; the bytes are a few megabytes. The
// three IEEE divisions per pair cost the most instructions; the XLA form
// needs them, since a reciprocal product rounds differently.
//
// The design, three kernels on one stream:
// 1. p2m_prepare_kernel forms each face's 33 constants once, with the
//    arithmetic above, into a (B, F, 9) float4 record (36 floats: the
//    constants, the cull margin tau below and 2 pads), and sets each
//    point's 64-bit key to all ones.
// 2. p2m_scan_kernel: a block of THREADS threads takes THREADS * R points
//    (R per thread, so that one face record read from shared memory serves
//    R pairs) and one of S contiguous ranges of the faces. The grid is 1-D,
//    the split its fastest part, so that a tile's S splits run side by
//    side, then the point tile, then the batch entry: any B * N is taken.
//    It stages the records in chunks of CHUNK faces into shared memory
//    with cp.async, double-buffered, scanning one chunk while the next
//    arrives. Each pair first meets the plane cull below, about 13
//    operations. Where the pair passes in every lane of the warp (early in
//    the scan, or on a flat mesh, whose one plane rules nothing out), each
//    lane evaluates its own pair in full. Otherwise the pairs that pass go
//    into a queue of the warp (a ballot and a prefix count), and each time
//    32 are queued the warp evaluates them in full, one a lane, so that
//    the few pairs that pass do not idle the other lanes. Either way the
//    key goes into the point's slot in shared memory (by a 64-bit
//    atomicMin from the queue) and sharpens the point's cut. A pair's key
//    is (float_as_uint(distance) << 32) | face: distances are >= 0 or
//    +inf, whose bits order as the floats, so the smallest key is the
//    smallest distance with the lowest face on ties -- the plain version's
//    rule -- whatever the order in which pairs are evaluated. After chunks
//    0, 1, 3, 7, ... and the last, a point's slot goes into its key in
//    device memory by atomicMin, whose returned minimum (the other splits'
//    best so far) sharpens the cull. The result is the same bits at every
//    launch. R = 2 and S = 4 were measured at config 3 on the H100 against
//    R = 1, 4 and S = 1, 2, 8 (PERF.md).
// 3. p2m_finish_kernel writes face_idx from the key and recomputes the
//    winner's type with the same arithmetic; face 0 and type 0 where the
//    key's distance is inf.
//
// The plane cull. The distance to a triangle is at least the distance to
// its plane, so a pair whose plane distance exceeds the running best can
// never be the winner (the winner's distance is the smallest). The scan
// skips the full evaluation of a pair when
//   A = |s| - (tau_f + tau_p) > 2^-60  and  fl(A * A) > cut,
// s = fl(dot(fl(p - v1), un)) being the kernel's own plane distance (un =
// n/|n| as formed above) and cut = fl(best * (1 + 2^-17)), best the
// smallest distance the point's keys hold so far. Why the
// computed distance d of a skipped pair is then > best, with u = 2^-24,
// M = the largest |coordinate| of p, v1, v2, v3, and P the plane through v1
// of normal un (exact, of the float vector un; |un| = 1 within 3.5u):
// - the computed closest point q is at most h + 53uM off P, h the larger
//   of the computed |dot(e21, un)| and |dot(e13, un)|: a vertex is at
//   most h_true <= h + 24uM off (v1 on P; the rest is rounding); an edge
//   point v + e*u (0 <= u <= 1) lies on the triangle within 9uM of
//   rounding, so within h_true + 9uM; the plane point p - un*s within
//   53uM (s within 14uM of dot(p - v1, un), |un|^2 within 7u of 1, the
//   product's and the difference's rounding);
// - p is at least (|s| - 14uM)(1 - 3.5u) >= |s| - 27uM off P;
// - so |q - p| >= A_true = |s| - h - 104uM, and d = fl(|fl(q - p)|^2) >=
//   (1 - 5.01u) A_true^2 (three nonnegative squares and two sums,
//   relative roundings);
// - tau_f = h + 2^-16 M_f and tau_p = 2^-16 m_p (M_f, m_p the largest
//   |coordinate| of the face and of the point) exceed h + 104uM with room
//   for their own rounding (2^-16 = 256u), so A (rounded) <= A_true(1+u)
//   and fl(A*A) <= A_true^2 (1 + 3u); fl(A*A) > cut >= best (1 + 127u)
//   gives A_true^2 > best (1 + 124u) and d > best.
// The absolute part of the margin is needed: the computed closest point
// lies off the plane by ulps of the coordinates, not of the distance.
// A > 2^-60 keeps A * A a normal float, where relative rounding holds; a
// face or point with a coordinate of 2^58 or more gets tau = NaN, so that
// A * A cannot overflow. A NaN anywhere (a degenerate face: un = 0/0)
// makes A NaN, and a NaN never skips; best = inf gives cut = inf, which no
// product exceeds. A skipped face is never the winner, so the result is
// the unskipped scan's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // threads per scan block
constexpr int R = 2;          // points per thread
constexpr int S = 4;          // splits of the faces
constexpr int TILE = THREADS * R;  // points per scan block
constexpr int CHUNK = 64;     // faces per staged chunk
constexpr int REC = 9;        // float4 per face record
constexpr unsigned long long NO_KEY = ~0ull;

// record layout, float4 by float4:
//   0: v1, tau      1: un, ee21     2: v2, ee32     3: v3, ee13
//   4: e21, en1.x   5: e32, en1.y   6: e13, en1.z   7: en2, en3.x
//   8: en3.y, en3.z, 0, 0

struct V3f {
  float x, y, z;
};

__device__ __forceinline__ V3f sub(V3f a, V3f b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ float dot(V3f a, V3f b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}

__device__ __forceinline__ V3f cross(V3f a, V3f b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3f xyz(float4 a) { return {a.x, a.y, a.z}; }

__device__ __forceinline__ float max_abs(V3f a) {
  return fmaxf(fabsf(a.x), fmaxf(fabsf(a.y), fabsf(a.z)));
}

// 2^-16 * m, or NaN (never skip) where m reaches 2^58
__device__ __forceinline__ float margin(float m) {
  return m < 0x1p58f ? m * 0x1p-16f : NAN;
}

// One face's constants. The same expressions, in the same order, as the
// plain version's, so the values are its bits.
struct Face {
  V3f v1, v2, v3, e21, e32, e13, en1, en2, en3, un;
  float ee21, ee32, ee13;
};

__device__ __forceinline__ Face load_face(const float4* r) {
  const float4 r0 = r[0], r1 = r[1], r2 = r[2], r3 = r[3], r4 = r[4],
               r5 = r[5], r6 = r[6], r7 = r[7], r8 = r[8];
  Face f;
  f.v1 = xyz(r0);
  f.un = xyz(r1);
  f.ee21 = r1.w;
  f.v2 = xyz(r2);
  f.ee32 = r2.w;
  f.v3 = xyz(r3);
  f.ee13 = r3.w;
  f.e21 = xyz(r4);
  f.e32 = xyz(r5);
  f.e13 = xyz(r6);
  f.en1 = {r4.w, r5.w, r6.w};
  f.en2 = xyz(r7);
  f.en3 = {r7.w, r8.x, r8.y};
  return f;
}

struct Regions {
  bool is1, is2, is3, is4, is5, is6;
  float uab, ubc, uca;
};

__device__ __forceinline__ Regions regions(const Face& f, V3f d1, V3f d2,
                                           V3f d3) {
  Regions g;
  g.uab = dot(d1, f.e21) / f.ee21;
  g.ubc = dot(d2, f.e32) / f.ee32;
  g.uca = dot(d3, f.e13) / f.ee13;
  g.is1 = (g.uca > 1.f) & (g.uab < 0.f);
  g.is2 = (g.uab > 1.f) & (g.ubc < 0.f);
  g.is3 = (g.ubc > 1.f) & (g.uca < 0.f);
  g.is4 = (g.uab >= 0.f) & (g.uab <= 1.f) & (dot(f.en1, d1) <= 0.f);
  g.is5 = (g.ubc >= 0.f) & (g.ubc <= 1.f) & (dot(f.en2, d2) <= 0.f);
  g.is6 = (g.uca >= 0.f) & (g.uca <= 1.f) & (dot(f.en3, d3) <= 0.f);
  return g;
}

// the squared distance of the pair, NaN counted as inf; d1 = p - v1 and
// s = dot(d1, un) come from the cull
__device__ __forceinline__ float distance(const Face& f, V3f p, V3f d1,
                                          float s) {
  const V3f d2 = sub(p, f.v2), d3 = sub(p, f.v3);
  const Regions g = regions(f, d1, d2, d3);
  V3f q;
  if (g.is1) {
    q = f.v1;
  } else if (g.is2) {
    q = f.v2;
  } else if (g.is3) {
    q = f.v3;
  } else if (g.is4) {
    q = {f.v1.x + f.e21.x * g.uab, f.v1.y + f.e21.y * g.uab,
         f.v1.z + f.e21.z * g.uab};
  } else if (g.is5) {
    q = {f.v2.x + f.e32.x * g.ubc, f.v2.y + f.e32.y * g.ubc,
         f.v2.z + f.e32.z * g.ubc};
  } else if (g.is6) {
    q = {f.v3.x + f.e13.x * g.uca, f.v3.y + f.e13.y * g.uca,
         f.v3.z + f.e13.z * g.uca};
  } else {
    q = {p.x - f.un.x * s, p.y - f.un.y * s, p.z - f.un.z * s};
  }
  const V3f gq = sub(q, p);
  const float d = dot(gq, gq);
  return isnan(d) ? INFINITY : d;
}

__device__ __forceinline__ unsigned long long make_key(float d, int f) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)f;
}

// threads [0, B*F) form face records, threads [0, B*N) reset keys
__global__ void __launch_bounds__(256)
p2m_prepare_kernel(const float* __restrict__ face_vertices,
                   float4* __restrict__ rec,
                   unsigned long long* __restrict__ keys, size_t faces,
                   size_t points) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i < points) keys[i] = NO_KEY;
  if (i >= faces) return;
  const float* fv = face_vertices + i * 9;
  const V3f v1 = {fv[0], fv[1], fv[2]}, v2 = {fv[3], fv[4], fv[5]},
            v3 = {fv[6], fv[7], fv[8]};
  const V3f e21 = sub(v2, v1), e32 = sub(v3, v2), e13 = sub(v1, v3);
  const V3f c = cross(e21, e13);
  const V3f nrm = {-c.x, -c.y, -c.z};
  const float len = sqrtf(dot(nrm, nrm));
  const V3f un = {nrm.x / len, nrm.y / len, nrm.z / len};
  const V3f en1 = cross(nrm, e21), en2 = cross(nrm, e32),
            en3 = cross(nrm, e13);
  // the vertices' distances from the plane through v1 along un (above)
  const float h = fmaxf(fabsf(dot(e21, un)), fabsf(dot(e13, un)));
  const float tau =
      h + margin(fmaxf(max_abs(v1), fmaxf(max_abs(v2), max_abs(v3))));
  float4* r = rec + i * REC;
  r[0] = make_float4(v1.x, v1.y, v1.z, tau);
  r[1] = make_float4(un.x, un.y, un.z, dot(e21, e21));
  r[2] = make_float4(v2.x, v2.y, v2.z, dot(e32, e32));
  r[3] = make_float4(v3.x, v3.y, v3.z, dot(e13, e13));
  r[4] = make_float4(e21.x, e21.y, e21.z, en1.x);
  r[5] = make_float4(e32.x, e32.y, e32.z, en1.y);
  r[6] = make_float4(e13.x, e13.y, e13.z, en1.z);
  r[7] = make_float4(en2.x, en2.y, en2.z, en3.x);
  r[8] = make_float4(en3.y, en3.z, 0.f, 0.f);
}

__device__ __forceinline__ void stage(float4* dst, const float4* src,
                                      int n) {
  for (int k = threadIdx.x; k < n * REC; k += THREADS) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src + k));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Evaluates one queued pair in full: item = (face in the chunk << 16) |
// point slot; folds its key into the slot's.
__device__ __forceinline__ void score(int item, const float4* t, int base,
                                      const float4* spt,
                                      unsigned long long* skey) {
  const int k = item >> 16, slot = item & 0xffff;
  const float4* r = t + k * REC;
  const V3f p = xyz(spt[slot]);
  const V3f d1 = sub(p, xyz(r[0]));
  const float s = dot(d1, xyz(r[1]));
  atomicMin(skey + slot, make_key(distance(load_face(r), p, d1, s),
                                  base + k));
}

// points (B, N, 3); rec (B, F, 9) float4; keys (B, N); scored: optional
// count of the pairs evaluated in full
__global__ void __launch_bounds__(THREADS)
p2m_scan_kernel(const float* __restrict__ points,
                const float4* __restrict__ rec,
                unsigned long long* __restrict__ keys, int N, int F,
                int tiles, unsigned long long* __restrict__ scored) {
  constexpr int QCAP = 32 * (R + 1);
  __shared__ float4 buf[2][CHUNK * REC];
  __shared__ float4 spt[TILE];              // point, tau_p
  __shared__ unsigned long long skey[TILE]; // the split's best key
  __shared__ int queue[THREADS / 32][QCAP];
  const int split = (int)(blockIdx.x % S);
  const int tile = (int)(blockIdx.x / S % tiles);
  const int b = (int)(blockIdx.x / S / tiles);
  const int f0 = (int)((long long)F * split / S);
  const int f1 = (int)((long long)F * (split + 1) / S);
  const float4* recb = rec + (size_t)b * F * REC;
  unsigned long long* keyb = keys + (size_t)b * N;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int* q = queue[threadIdx.x >> 5];

  int pt[R];
  V3f p[R];
  float tau_p[R], cut[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    pt[r] = tile * TILE + r * THREADS + threadIdx.x;
    const float* pp = points + ((size_t)b * N + min(pt[r], N - 1)) * 3;
    p[r] = {pp[0], pp[1], pp[2]};
    tau_p[r] = margin(max_abs(p[r]));
    cut[r] = INFINITY;
    spt[r * THREADS + threadIdx.x] = make_float4(p[r].x, p[r].y, p[r].z,
                                                 tau_p[r]);
    skey[r * THREADS + threadIdx.x] = NO_KEY;
  }
  __syncwarp();
  int queued = 0;  // the same in every lane of the warp
  unsigned long long count = 0;

  // the cuts from the slots' keys (NaN bits of NO_KEY leave a cut as it is)
  auto refresh = [&]() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float g = __uint_as_float(
          (unsigned)(skey[r * THREADS + threadIdx.x] >> 32));
      cut[r] = fminf(cut[r], g * (1.f + 0x1p-17f));
    }
  };

  const int chunks = (f1 - f0 + CHUNK - 1) / CHUNK;
  if (chunks > 0) stage(buf[0], recb + (size_t)f0 * REC, min(CHUNK, f1 - f0));
  for (int c = 0; c < chunks; ++c) {
    const int base = f0 + c * CHUNK;
    const int next = base + CHUNK;
    if (next < f1) {
      stage(buf[(c + 1) & 1], recb + (size_t)next * REC,
            min(CHUNK, f1 - next));
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float4* t = buf[c & 1];
    const int n = min(CHUNK, f1 - base);
    for (int k = 0; k < n; ++k) {
      const float4 r0 = t[k * REC], r1 = t[k * REC + 1];
      const V3f v1 = xyz(r0), un = xyz(r1);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const V3f d1 = sub(p[r], v1);
        const float s = dot(d1, un);
        const float a = fabsf(s) - (r0.w + tau_p[r]);
        const bool need = pt[r] < N && !(a > 0x1p-60f && a * a > cut[r]);
        const unsigned mask = __ballot_sync(~0u, need);
        if (mask == ~0u) {
          // every lane needs its pair: evaluate it here, no queue. Only
          // this lane writes its slots outside a flush of the queue, so
          // no atomic is needed.
          const float d = distance(load_face(t + k * REC), p[r], d1, s);
          const unsigned long long key = make_key(d, base + k);
          unsigned long long* own = skey + r * THREADS + threadIdx.x;
          if (key < *own) *own = key;
          cut[r] = fminf(cut[r], d * (1.f + 0x1p-17f));
          ++count;
          continue;
        }
        if (need) {
          q[queued + __popc(mask & below)] = (k << 16)
                                             | (r * THREADS + threadIdx.x);
          ++count;
        }
        queued += __popc(mask);
      }
      // a full warp of queued pairs: score the newest 32, one a lane
      if (queued >= 32) {
        __syncwarp();
        do {
          queued -= 32;
          score(q[queued + lane], t, base, spt, skey);
        } while (queued >= 32);
        __syncwarp();
        refresh();
      }
    }
    // the rest of the chunk's queue, before its records are overwritten
    __syncwarp();
    if (lane < queued) score(q[lane], t, base, spt, skey);
    queued = 0;
    __syncwarp();
    refresh();
    // merge into the keys after chunks 0, 1, 3, 7, ... and the last: the
    // returned minimum sharpens the cut, most of all early in the scan
    if ((c & (c + 1)) == 0 || c == chunks - 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (pt[r] >= N) continue;
        const unsigned long long old =
            atomicMin(keyb + pt[r], skey[r * THREADS + threadIdx.x]);
        const float g = __uint_as_float((unsigned)(old >> 32));
        cut[r] = fminf(cut[r], g * (1.f + 0x1p-17f));
      }
    }
    __syncthreads();
  }
  if (scored != nullptr) atomicAdd(scored, count);
}

// keys (B, N) -> face_idx, dist_type (B, N)
__global__ void __launch_bounds__(256)
p2m_finish_kernel(const float* __restrict__ points,
                  const float4* __restrict__ rec,
                  const unsigned long long* __restrict__ keys,
                  int* __restrict__ face_idx, int* __restrict__ dist_type,
                  int N, int F, size_t total) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const unsigned long long key = keys[i];
  // inf (every distance inf), or no key (no face)
  if ((unsigned)(key >> 32) >= 0x7f800000u) {
    face_idx[i] = 0;
    dist_type[i] = 0;
    return;
  }
  const int f = (int)(unsigned)key;
  const size_t b = i / N;
  const float* pp = points + i * 3;
  const V3f p = {pp[0], pp[1], pp[2]};
  const Face fc = load_face(rec + (b * F + f) * REC);
  const Regions g =
      regions(fc, sub(p, fc.v1), sub(p, fc.v2), sub(p, fc.v3));
  face_idx[i] = f;
  dist_type[i] = g.is1 * 1 + g.is2 * 2 + g.is3 * 3 + g.is4 * 4 + g.is5 * 5
                 + g.is6 * 6;
}

}  // namespace

extern "C" {

// points (B, N, 3), face_vertices (B, F, 3, 3); rec (B, F, 36) float and
// keys (B, N) 64-bit scratch; face_idx and dist_type (B, N) int32, every
// entry written. scored, if not null, a zeroed 64-bit count that gains
// the pairs evaluated in full.
int p2m_select_forward(const float* points, const float* face_vertices,
                       float* rec, void* keys, int* face_idx, int* dist_type,
                       int B, int N, int F, void* scored, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || N == 0) return (int)cudaGetLastError();
  const int tiles = (N + TILE - 1) / TILE;
  const size_t blocks = (size_t)S * tiles * B;
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t faces = (size_t)B * F, pts = (size_t)B * N;
  const size_t most = faces > pts ? faces : pts;
  unsigned long long* k = (unsigned long long*)keys;
  float4* r4 = (float4*)rec;
  p2m_prepare_kernel<<<(unsigned)((most + 255) / 256), 256, 0, s>>>(
      face_vertices, r4, k, faces, pts);
  if (F > 0) {
    p2m_scan_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
        points, r4, k, N, F, tiles, (unsigned long long*)scored);
  }
  p2m_finish_kernel<<<(unsigned)((pts + 255) / 256), 256, 0, s>>>(
      points, r4, k, face_idx, dist_type, N, F, pts);
  return (int)cudaGetLastError();
}

}  // extern "C"
