// Point-to-mesh closest face and distance type, one thread per point.
//
// Replaces the TPU kernel kaolin_tpu/kernels/p2m_distance.py
// p2m_select_pallas. That kernel reads a (40, F) table of per-face
// constants held in VMEM (at most 65,536 faces) and multiplies by
// reciprocal edge lengths; it agrees with the JAX package's XLA scan only
// up to float ties. This kernel follows the XLA path instead
// (kaolin_tpu/metrics/trianglemesh.py _classify_and_distance and
// _select_faces), operation for operation as the plain PyTorch version
// (kaolin_tpu_torch/kernels/p2m_distance.py p2m_select_plain) writes it,
// under --fmad=false, so that face indices and types equal the plain
// version's, ties included. It takes any number of faces.
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
// order. Faces are scanned in index order and a distance is taken only when
// strictly smaller: ties keep the lowest face, and with every distance inf
// the result is face 0, type 0.
//
// The per-face values (vertices, edges, dot(e, e), cross(n, e) and the unit
// normal) are the same bits however often they are formed: each block forms
// them once per staged chunk of faces, one face per thread, into shared
// memory.
//
// What bounds it on an H100: operations, about 75 float operations per
// pair (3 of them divisions) over 10^9 pairs at config 3's 100k points and
// 10k faces: 1.1 ms at 67 TFLOP/s; the bytes are a few megabytes. The
// three IEEE divisions per pair cost the most instructions; the XLA form
// needs them, since a reciprocal product rounds differently.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // points per block, faces per staged chunk

// per-face rows of the shared table
enum {
  V1 = 0, V2 = 3, V3 = 6, E21 = 9, E32 = 12, E13 = 15, EE21 = 18, EE32 = 19,
  EE13 = 20, EN1 = 21, EN2 = 24, EN3 = 27, UN = 30, ROWS = 33
};

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

__device__ __forceinline__ V3f row(const float (*t)[THREADS], int r, int f) {
  return {t[r][f], t[r + 1][f], t[r + 2][f]};
}

__device__ __forceinline__ void put(float (*t)[THREADS], int r, int f,
                                    V3f v) {
  t[r][f] = v.x;
  t[r + 1][f] = v.y;
  t[r + 2][f] = v.z;
}

// points (B, N, 3), face_vertices (B, F, 3, 3); face_idx, dist_type (B, N)
__global__ void __launch_bounds__(THREADS)
p2m_select_kernel(const float* __restrict__ points,
                  const float* __restrict__ face_vertices,
                  int* __restrict__ face_idx, int* __restrict__ dist_type,
                  int N, int F) {
  __shared__ float t[ROWS][THREADS];
  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const float* pp = points + ((size_t)b * N + min(i, N - 1)) * 3;
  const V3f p = {pp[0], pp[1], pp[2]};
  const float* fvb = face_vertices + (size_t)b * F * 9;
  float best = INFINITY;
  int best_f = 0, best_t = 0;
  for (int base = 0; base < F; base += THREADS) {
    const int n = min(THREADS, F - base);
    __syncthreads();
    if (threadIdx.x < n) {
      const int f = threadIdx.x;
      const float* fv = fvb + (size_t)(base + f) * 9;
      const V3f v1 = {fv[0], fv[1], fv[2]}, v2 = {fv[3], fv[4], fv[5]},
                v3 = {fv[6], fv[7], fv[8]};
      const V3f e21 = sub(v2, v1), e32 = sub(v3, v2), e13 = sub(v1, v3);
      const V3f c = cross(e21, e13);
      const V3f nrm = {-c.x, -c.y, -c.z};
      const float len = sqrtf(dot(nrm, nrm));
      put(t, V1, f, v1);
      put(t, V2, f, v2);
      put(t, V3, f, v3);
      put(t, E21, f, e21);
      put(t, E32, f, e32);
      put(t, E13, f, e13);
      t[EE21][f] = dot(e21, e21);
      t[EE32][f] = dot(e32, e32);
      t[EE13][f] = dot(e13, e13);
      put(t, EN1, f, cross(nrm, e21));
      put(t, EN2, f, cross(nrm, e32));
      put(t, EN3, f, cross(nrm, e13));
      put(t, UN, f, V3f{nrm.x / len, nrm.y / len, nrm.z / len});
    }
    __syncthreads();
    for (int f = 0; f < n; ++f) {
      const V3f v1 = row(t, V1, f), v2 = row(t, V2, f), v3 = row(t, V3, f);
      const V3f e21 = row(t, E21, f), e32 = row(t, E32, f),
                e13 = row(t, E13, f);
      const V3f d1 = sub(p, v1), d2 = sub(p, v2), d3 = sub(p, v3);
      const float uab = dot(d1, e21) / t[EE21][f];
      const float ubc = dot(d2, e32) / t[EE32][f];
      const float uca = dot(d3, e13) / t[EE13][f];
      const bool is1 = (uca > 1.f) & (uab < 0.f);
      const bool is2 = (uab > 1.f) & (ubc < 0.f);
      const bool is3 = (ubc > 1.f) & (uca < 0.f);
      const bool is4 = (uab >= 0.f) & (uab <= 1.f)
                       & (dot(row(t, EN1, f), d1) <= 0.f);
      const bool is5 = (ubc >= 0.f) & (ubc <= 1.f)
                       & (dot(row(t, EN2, f), d2) <= 0.f);
      const bool is6 = (uca >= 0.f) & (uca <= 1.f)
                       & (dot(row(t, EN3, f), d3) <= 0.f);
      const int type = is1 * 1 + is2 * 2 + is3 * 3 + is4 * 4 + is5 * 5
                       + is6 * 6;
      V3f q;
      if (is1) {
        q = v1;
      } else if (is2) {
        q = v2;
      } else if (is3) {
        q = v3;
      } else if (is4) {
        q = {v1.x + e21.x * uab, v1.y + e21.y * uab, v1.z + e21.z * uab};
      } else if (is5) {
        q = {v2.x + e32.x * ubc, v2.y + e32.y * ubc, v2.z + e32.z * ubc};
      } else if (is6) {
        q = {v3.x + e13.x * uca, v3.y + e13.y * uca, v3.z + e13.z * uca};
      } else {
        const V3f un = row(t, UN, f);
        const float s = dot(d1, un);
        q = {p.x - un.x * s, p.y - un.y * s, p.z - un.z * s};
      }
      const V3f g = sub(q, p);
      float d = dot(g, g);
      if (isnan(d)) d = INFINITY;
      if (d < best) {
        best = d;
        best_f = base + f;
        best_t = type;
      }
    }
  }
  if (i < N) {
    face_idx[(size_t)b * N + i] = best_f;
    dist_type[(size_t)b * N + i] = best_t;
  }
}

}  // namespace

extern "C" {

// face_idx and dist_type (B, N) int32, every entry written.
int p2m_select_forward(const float* points, const float* face_vertices,
                       int* face_idx, int* dist_type, int B, int N, int F,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || N == 0) return (int)cudaGetLastError();
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  p2m_select_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      points, face_vertices, face_idx, dist_type, N, F);
  return (int)cudaGetLastError();
}

}  // extern "C"
