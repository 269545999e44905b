// Native host-side preprocessing for kaolin_tpu_torch: OBJ parsing, Morton
// codes, the octree byte stream and conservative triangle voxelization.
//
// Scene preprocessing with data-dependent output sizes is CPU-bound, so it
// runs natively on the host. Exposed as a plain C ABI loaded with ctypes
// (kaolin_tpu_torch/native.py), built with the host compiler by
// kaolin_tpu_torch/kernels/_build.py at first use. The numpy versions of
// the same functions (ops/spc/points.py _octree_bytes and _morton_np,
// ops/conversions/mesh.py _voxelize_triangles_np) are the plain versions
// the tests hold it against.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ parsing: two-pass (count, then fill). Handles 'v x y z' and
// 'f a[/..] b[/..] c[/..] ...' lines; faces are triangulated with a fan,
// negative indices resolved relative to the current vertex count.
// Returns 0 on success.
// ---------------------------------------------------------------------------

int obj_count(const char* path, int64_t* num_vertices, int64_t* num_tris) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  char line[8192];
  int64_t nv = 0, nt = 0;
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      nv++;
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      // count face corners
      int corners = 0;
      char* p = line + 1;
      while (*p) {
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        corners++;
        while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
          p++;
      }
      if (corners >= 3) nt += corners - 2;
    }
  }
  fclose(f);
  *num_vertices = nv;
  *num_tris = nt;
  return 0;
}

int obj_parse(const char* path, float* vertices, int64_t* faces,
              int64_t* face_sizes_homogeneous) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  char line[8192];
  int64_t vi = 0, fi = 0;
  int64_t seen_vertices = 0;
  int homogeneous = 1;
  int first_size = -1;
  std::vector<int64_t> corner_buf;
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      float x, y, z;
      if (sscanf(line + 1, "%f %f %f", &x, &y, &z) == 3) {
        vertices[vi * 3 + 0] = x;
        vertices[vi * 3 + 1] = y;
        vertices[vi * 3 + 2] = z;
        vi++;
        seen_vertices++;
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      corner_buf.clear();
      char* p = line + 1;
      while (*p) {
        while (*p == ' ' || *p == '\t') p++;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        long idx = strtol(p, &p, 10);
        if (idx < 0) idx = seen_vertices + idx + 1;
        corner_buf.push_back(idx - 1);
        while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
          p++;
      }
      int sz = (int)corner_buf.size();
      if (sz >= 3) {
        if (first_size < 0) first_size = sz;
        else if (sz != first_size) homogeneous = 0;
        for (int c = 1; c + 1 < sz; c++) {
          faces[fi * 3 + 0] = corner_buf[0];
          faces[fi * 3 + 1] = corner_buf[c];
          faces[fi * 3 + 2] = corner_buf[c + 1];
          fi++;
        }
      }
    }
  }
  fclose(f);
  *face_sizes_homogeneous = homogeneous ? first_size : -1;
  return 0;
}

// ---------------------------------------------------------------------------
// Morton codes (x<<2 | y<<1 | z interleave, matching spc_math.h)
// ---------------------------------------------------------------------------

static inline uint64_t spread3(uint64_t v) {
  v &= 0xFFFF;
  v = (v | (v << 16)) & 0x0000FF0000FFull;
  v = (v | (v << 8)) & 0x00F00F00F00Full;
  v = (v | (v << 4)) & 0x0C30C30C30C3ull;
  v = (v | (v << 2)) & 0x249249249249ull;
  return v;
}

static inline uint64_t compact3(uint64_t v) {
  v &= 0x249249249249ull;
  v = (v | (v >> 2)) & 0x0C30C30C30C3ull;
  v = (v | (v >> 4)) & 0x00F00F00F00Full;
  v = (v | (v >> 8)) & 0x0000FF0000FFull;
  v = (v | (v >> 16)) & 0xFFFFull;
  return v;
}

void points_to_morton(const int16_t* points, int64_t n, int64_t* morton) {
  for (int64_t i = 0; i < n; i++) {
    morton[i] = (int64_t)((spread3((uint64_t)(uint16_t)points[i * 3]) << 2)
                          | (spread3((uint64_t)(uint16_t)points[i * 3 + 1])
                             << 1)
                          | spread3((uint64_t)(uint16_t)points[i * 3 + 2]));
  }
}

void morton_to_points(const int64_t* morton, int64_t n, int16_t* points) {
  for (int64_t i = 0; i < n; i++) {
    uint64_t m = (uint64_t)morton[i];
    points[i * 3] = (int16_t)compact3(m >> 2);
    points[i * 3 + 1] = (int16_t)compact3(m >> 1);
    points[i * 3 + 2] = (int16_t)compact3(m);
  }
}

// ---------------------------------------------------------------------------
// Octree build: sorts + dedups morton codes, then builds the
// breadth-first byte stream bottom-up (matching
// kaolin/csrc/ops/spc/point_utils_cuda.cu points_to_octree semantics).
// Returns the total byte count, or -1 if out_capacity is too small.
// ---------------------------------------------------------------------------

int64_t points_to_octree(const int16_t* points, int64_t n, int level,
                         uint8_t* out, int64_t out_capacity) {
  std::vector<uint64_t> morton(n);
  for (int64_t i = 0; i < n; i++) {
    morton[i] = (spread3((uint64_t)(uint16_t)points[i * 3]) << 2)
        | (spread3((uint64_t)(uint16_t)points[i * 3 + 1]) << 1)
        | spread3((uint64_t)(uint16_t)points[i * 3 + 2]);
  }
  std::sort(morton.begin(), morton.end());
  morton.erase(std::unique(morton.begin(), morton.end()), morton.end());

  std::vector<std::vector<uint8_t>> levels(level);
  std::vector<uint64_t> cur(morton);
  for (int l = level; l > 0; l--) {
    std::vector<uint8_t>& bytes = levels[l - 1];
    std::vector<uint64_t> parents;
    parents.reserve(cur.size());
    uint64_t prev_parent = ~0ull;
    for (uint64_t m : cur) {
      uint64_t parent = m >> 3;
      int child = (int)(m & 7);
      if (parent != prev_parent) {
        parents.push_back(parent);
        bytes.push_back(0);
        prev_parent = parent;
      }
      bytes.back() |= (uint8_t)(1 << child);
    }
    cur.swap(parents);
  }
  int64_t total = 0;
  for (int l = 0; l < level; l++) total += (int64_t)levels[l].size();
  if (total > out_capacity) return -1;
  int64_t off = 0;
  for (int l = 0; l < level; l++) {
    memcpy(out + off, levels[l].data(), levels[l].size());
    off += (int64_t)levels[l].size();
  }
  return total;
}

// ---------------------------------------------------------------------------
// Conservative triangle voxelization, matching the semantics of the
// reference kernels (kaolin/csrc/ops/conversions/mesh_to_spc/
// mesh_to_spc_cuda.cu:79-333 d_ProcessTriangles/d_ProcessVoxels):
//  1. snap vertices (already in grid coordinates) to the integer lattice;
//  2. spanning plane from the snapped vertices; degenerate (collinear /
//     point) triangles fall back to a segment/point rasterization;
//  3. project onto the dominant-normal-axis plane; three homogeneous edge
//     lines, each dilated by the half-pixel L1 bound (conservative);
//  4. every lattice pixel of the 2D bbox with all edge tests < 0 emits one
//     voxel whose third coordinate comes from the plane at the pixel
//     center (round-to-nearest) — a 26-connected surface band.
// Out-of-grid voxels are dropped; output is sorted + deduplicated.
// Returns the voxel count, or -1 if out_capacity is too small.
// ---------------------------------------------------------------------------

static inline void cross3(const double a[3], const double b[3], double o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

int64_t voxelize_triangles(const float* verts, int64_t nv,
                           const int64_t* tris, int64_t nt, int level,
                           int16_t* out, int64_t out_capacity) {
  (void)nv;
  const int64_t res = (int64_t)1 << level;
  std::vector<uint64_t> morton;
  for (int64_t t = 0; t < nt; t++) {
    double p[3][3];
    for (int c = 0; c < 3; c++) {
      const float* h = verts + tris[t * 3 + c] * 3;
      for (int a = 0; a < 3; a++)
        p[c][a] = (double)(int)(h[a] + 0.5f);
    }
    // spanning plane n.x*X + n.y*Y + n.z*Z + w = 0; the plane is oriented
    // as the reference's crs4 (spc_math.h:130-137), whose normal is the
    // NEGATED (p1-p0)x(p2-p0) — the edge-test sign below depends on it
    double e1[3] = {p[1][0] - p[0][0], p[1][1] - p[0][1], p[1][2] - p[0][2]};
    double e2[3] = {p[2][0] - p[0][0], p[2][1] - p[0][1], p[2][2] - p[0][2]};
    double n[3];
    cross3(e1, e2, n);
    for (int a = 0; a < 3; a++) n[a] = -n[a];
    double w = -(n[0] * p[0][0] + n[1] * p[0][1] + n[2] * p[0][2]);

    int axis;
    double q[3][3];      // projected homogeneous 2D verts (x, y, 1)
    double l[3][3];      // edge lines
    double F[3];         // third-coordinate interpolation: z = dot((x,y,1),F)
    if (n[0] == 0.0 && n[1] == 0.0 && n[2] == 0.0) {
      // degenerate: collinear or repeated vertices
      double mn[3], mx[3];
      for (int a = 0; a < 3; a++) {
        mn[a] = std::min(p[0][a], std::min(p[1][a], p[2][a]));
        mx[a] = std::max(p[0][a], std::max(p[1][a], p[2][a]));
      }
      double diff[3] = {mx[0] - mn[0], mx[1] - mn[1], mx[2] - mn[2]};
      if (diff[0] == 0.0 && diff[1] == 0.0 && diff[2] == 0.0) {
        // single point
        axis = 2;
        for (int c = 0; c < 3; c++)
          for (int a = 0; a < 3; a++) q[c][a] = mn[a];
        for (int c = 0; c < 3; c++)
          for (int a = 0; a < 3; a++) l[c][a] = -mn[a];
        F[0] = 0.0; F[1] = 0.0; F[2] = mn[2];
      } else {
        // segment: rasterize along the two largest-extent axes
        if (diff[0] < diff[1])
          axis = (diff[0] < diff[2]) ? 0 : 2;
        else
          axis = (diff[1] < diff[2]) ? 1 : 2;
        // (u, v) = the two kept axes in the reference's cyclic order
        const int U[3] = {1, 2, 0}, V[3] = {2, 0, 1};
        int u = U[axis], v = V[axis];
        q[0][0] = mn[u]; q[0][1] = mn[v]; q[0][2] = 1.0;
        q[1][0] = mx[u]; q[1][1] = mx[v]; q[1][2] = 1.0;
        for (int a = 0; a < 3; a++) q[2][a] = q[1][a];
        if (diff[u] != 0.0) {
          F[0] = diff[axis] / diff[u];
          F[1] = 0.0;
          F[2] = (mn[axis] * mx[u] - mn[u] * mx[axis]) / diff[u];
        } else {
          F[0] = 0.0;
          F[1] = diff[axis] / diff[v];
          F[2] = (mn[axis] * mx[v] - mn[v] * mx[axis]) / diff[v];
        }
        cross3(q[0], q[1], l[1]);
        for (int a = 0; a < 3; a++) {
          l[1][a] = -l[1][a];
          l[0][a] = -l[1][a];
          l[2][a] = l[1][a];
        }
      }
    } else {
      if (std::fabs(n[0]) > std::fabs(n[1]))
        axis = (std::fabs(n[0]) > std::fabs(n[2])) ? 0 : 2;
      else
        axis = (std::fabs(n[1]) > std::fabs(n[2])) ? 1 : 2;
      double sign = n[axis] > 0.0 ? 1.0 : -1.0;
      // cyclic projections: x -> (y, z), y -> (z, x), z -> (x, y)
      const int U[3] = {1, 2, 0}, V[3] = {2, 0, 1};
      int u = U[axis], v = V[axis];
      for (int c = 0; c < 3; c++) {
        q[c][0] = p[c][u];
        q[c][1] = p[c][v];
        q[c][2] = 1.0;
      }
      F[0] = -n[u] / n[axis];
      F[1] = -n[v] / n[axis];
      F[2] = -w / n[axis];
      cross3(q[1], q[2], l[0]);
      cross3(q[2], q[0], l[1]);
      cross3(q[0], q[1], l[2]);
      for (int c = 0; c < 3; c++)
        for (int a = 0; a < 3; a++) l[c][a] *= sign;
    }
    // conservative dilation by the half-pixel box
    for (int c = 0; c < 3; c++)
      l[c][2] -= 0.5 * (std::fabs(l[c][0]) + std::fabs(l[c][1]));

    int64_t xmin = (int64_t)std::min(q[0][0], std::min(q[1][0], q[2][0]));
    int64_t xmax = (int64_t)std::max(q[0][0], std::max(q[1][0], q[2][0]));
    int64_t ymin = (int64_t)std::min(q[0][1], std::min(q[1][1], q[2][1]));
    int64_t ymax = (int64_t)std::max(q[0][1], std::max(q[1][1], q[2][1]));
    for (int64_t y = ymin; y <= ymax; y++) {
      for (int64_t x = xmin; x <= xmax; x++) {
        double px = (double)x, py = (double)y;
        bool in0 = px * l[0][0] + py * l[0][1] + l[0][2] < 0.0;
        bool in1 = px * l[1][0] + py * l[1][1] + l[1][2] < 0.0;
        bool in2 = px * l[2][0] + py * l[2][1] + l[2][2] < 0.0;
        if (!(in0 && in1 && in2)) continue;
        int64_t z = (int64_t)(px * F[0] + py * F[1] + F[2] + 0.5);
        int64_t vx[3];
        // undo the cyclic projection: pixel (x, y) + plane depth z
        if (axis == 0) { vx[0] = z; vx[1] = x; vx[2] = y; }
        else if (axis == 1) { vx[0] = y; vx[1] = z; vx[2] = x; }
        else { vx[0] = x; vx[1] = y; vx[2] = z; }
        if (vx[0] < 0 || vx[0] >= res || vx[1] < 0 || vx[1] >= res ||
            vx[2] < 0 || vx[2] >= res)
          continue;
        morton.push_back((spread3((uint64_t)vx[0]) << 2)
                         | (spread3((uint64_t)vx[1]) << 1)
                         | spread3((uint64_t)vx[2]));
      }
    }
  }
  std::sort(morton.begin(), morton.end());
  morton.erase(std::unique(morton.begin(), morton.end()), morton.end());
  if ((int64_t)morton.size() > out_capacity) return -1;
  for (size_t i = 0; i < morton.size(); i++) {
    out[i * 3 + 0] = (int16_t)compact3(morton[i] >> 2);
    out[i * 3 + 1] = (int16_t)compact3(morton[i] >> 1);
    out[i * 3 + 2] = (int16_t)compact3(morton[i]);
  }
  return (int64_t)morton.size();
}

}  // extern "C"
