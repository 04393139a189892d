// Marching-tetrahedra isosurface extraction for occupancy submaps.
//
// Native counterpart of supereight2's map->mesh() marching cubes used by the
// reference (okvis_multisensor_processing/src/SubmappingInterface.cpp:935) —
// mesh extraction is host-side, latency-insensitive work that doesn't belong
// on the accelerator, so it lives in C++ like the reference's.
//
// Marching tetrahedra (6 tets per cube) trades ~2x triangle count for
// table-free correctness.  C ABI for ctypes.
//
// Build: g++ -O2 -shared -fPIC -o libmesh_mt.so mesh_mt.cpp

#include <cstdint>
#include <cstddef>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 lerp(const V3& a, const V3& b, float va, float vb, float iso) {
  float t = (iso - va) / (vb - va);
  if (t < 0.f) t = 0.f;
  if (t > 1.f) t = 1.f;
  return V3{a.x + t * (b.x - a.x), a.y + t * (b.y - a.y),
            a.z + t * (b.z - a.z)};
}

// The 6 tetrahedra of a cube, as corner indices (corner i has offsets
// ((i>>0)&1, (i>>1)&1, (i>>2)&1)).
const int kTets[6][4] = {
    {0, 5, 1, 3}, {0, 5, 3, 7}, {0, 5, 7, 4},
    {0, 7, 3, 2}, {0, 7, 2, 6}, {0, 7, 6, 4},
};

void emit_tet(const V3 p[4], const float v[4], float iso,
              std::vector<float>* out) {
  // classify corners above the iso level
  int code = 0;
  for (int i = 0; i < 4; ++i)
    if (v[i] > iso) code |= 1 << i;
  if (code == 0 || code == 15) return;

  auto push = [&](const V3& a) {
    out->push_back(a.x);
    out->push_back(a.y);
    out->push_back(a.z);
  };
  auto edge = [&](int a, int b) { return lerp(p[a], p[b], v[a], v[b], iso); };

  // one or two triangles depending on the 1-vs-3 / 2-vs-2 split
  switch (code) {
    case 1: case 14: {
      int i = (code == 1) ? 0 : 0;  // corner 0 isolated
      (void)i;
      push(edge(0, 1)); push(edge(0, 2)); push(edge(0, 3));
      break;
    }
    case 2: case 13:
      push(edge(1, 0)); push(edge(1, 3)); push(edge(1, 2));
      break;
    case 4: case 11:
      push(edge(2, 0)); push(edge(2, 1)); push(edge(2, 3));
      break;
    case 8: case 7:
      push(edge(3, 0)); push(edge(3, 2)); push(edge(3, 1));
      break;
    case 3: case 12: {  // corners {0,1} vs {2,3}
      V3 a = edge(0, 2), b = edge(0, 3), c = edge(1, 3), d = edge(1, 2);
      push(a); push(b); push(c);
      push(a); push(c); push(d);
      break;
    }
    case 5: case 10: {  // corners {0,2} vs {1,3}
      V3 a = edge(0, 1), b = edge(0, 3), c = edge(2, 3), d = edge(2, 1);
      push(a); push(b); push(c);
      push(a); push(c); push(d);
      break;
    }
    case 6: case 9: {  // corners {1,2} vs {0,3}
      V3 a = edge(1, 0), b = edge(1, 3), c = edge(2, 3), d = edge(2, 0);
      push(a); push(b); push(c);
      push(a); push(c); push(d);
      break;
    }
    default:
      break;
  }
}

}  // namespace

extern "C" {

// Extract the iso-surface of a dense nx*ny*nz field (row-major, x fastest
// varying last index: field[(ix*ny + iy)*nz + iz]).  Vertex coordinates are
// voxel units (caller scales/offsets).  Returns the number of floats written
// to out_verts (3 per vertex, 9 per triangle); writes at most max_floats.
// A negative return value means the buffer was too small; call again with
// at least -return_value floats of space.
int64_t mesh_marching_tetrahedra(const float* field, int nx, int ny, int nz,
                                 float iso, float* out_verts,
                                 int64_t max_floats) {
  std::vector<float> out;
  out.reserve(1 << 16);
  for (int ix = 0; ix + 1 < nx; ++ix) {
    for (int iy = 0; iy + 1 < ny; ++iy) {
      for (int iz = 0; iz + 1 < nz; ++iz) {
        float cv[8];
        V3 cp[8];
        bool all_lo = true, all_hi = true;
        for (int c = 0; c < 8; ++c) {
          int dx = c & 1, dy = (c >> 1) & 1, dz = (c >> 2) & 1;
          cv[c] = field[((size_t)(ix + dx) * ny + (iy + dy)) * nz + (iz + dz)];
          cp[c] = V3{float(ix + dx), float(iy + dy), float(iz + dz)};
          if (cv[c] > iso) all_lo = false; else all_hi = false;
        }
        if (all_lo || all_hi) continue;
        for (const auto& tet : kTets) {
          V3 p[4];
          float v[4];
          for (int i = 0; i < 4; ++i) {
            p[i] = cp[tet[i]];
            v[i] = cv[tet[i]];
          }
          emit_tet(p, v, iso, &out);
        }
      }
    }
  }
  int64_t n = (int64_t)out.size();
  if (n > max_floats) return -n;
  for (int64_t i = 0; i < n; ++i) out_verts[i] = out[i];
  return n;
}

}  // extern "C"
