// Native host-side components for the path tracer.
//
// 1. BVH builder: binned-SAH construction emitted directly as the flattened
//    DFS skip-link arrays consumed by device traversal (ops/bvh.py docs the
//    layout). Replaces the reference's pointer-tree midpoint builder
//    (reference src/BVH.cpp:15-54) with a higher-quality SAH split and a
//    cache-friendly array output; million-triangle scenes build in ~1s vs
//    tens of seconds in numpy.
//
// 2. OBJ parser: single-pass v/vn/vt/f/usemtl scanner (the reference's
//    hand-rolled parser, src/model.cpp:44-156, in native form). Returns
//    malloc'd SoA buffers; Python remaps material slots by name.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Vec3 {
  double x = 0, y = 0, z = 0;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
  Vec3 lo{DBL_MAX, DBL_MAX, DBL_MAX};
  Vec3 hi{-DBL_MAX, -DBL_MAX, -DBL_MAX};
  void grow(const Box& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
  void grow(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  double half_area() const {
    double dx = std::max(hi.x - lo.x, 0.0);
    double dy = std::max(hi.y - lo.y, 0.0);
    double dz = std::max(hi.z - lo.z, 0.0);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Builder {
  const double *v0, *e1, *e2;
  int64_t T;
  int leaf_size;
  std::vector<Box> tri_box;
  std::vector<Vec3> centroid;
  std::vector<int64_t> order;

  std::vector<float> lo, hi;
  std::vector<int32_t> first, count, skip_end;  // skip_end = preorder end

  void prepare() {
    tri_box.resize(T);
    centroid.resize(T);
    order.resize(T);
    for (int64_t i = 0; i < T; i++) {
      Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
      Vec3 b{a.x + e1[3 * i], a.y + e1[3 * i + 1], a.z + e1[3 * i + 2]};
      Vec3 c{a.x + e2[3 * i], a.y + e2[3 * i + 1], a.z + e2[3 * i + 2]};
      Box bb;
      bb.grow(a);
      bb.grow(b);
      bb.grow(c);
      tri_box[i] = bb;
      centroid[i] = {(a.x + b.x + c.x) / 3.0, (a.y + b.y + c.y) / 3.0,
                     (a.z + b.z + c.z) / 3.0};
      order[i] = i;
    }
  }

  int32_t emit_node(const Box& bb) {
    lo.push_back((float)bb.lo.x);
    lo.push_back((float)bb.lo.y);
    lo.push_back((float)bb.lo.z);
    hi.push_back((float)bb.hi.x);
    hi.push_back((float)bb.hi.y);
    hi.push_back((float)bb.hi.z);
    first.push_back(0);
    count.push_back(0);
    skip_end.push_back(0);
    return (int32_t)(first.size() - 1);
  }

  // Binned SAH split of order[l:r); returns split point m, or -1 for leaf.
  int64_t find_split(int64_t l, int64_t r, const Box& node_box) {
    const int NBINS = 16;
    Box cb;
    for (int64_t i = l; i < r; i++) cb.grow(centroid[order[i]]);
    double ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = ext[1] > ext[0] ? 1 : 0;
    if (ext[2] > ext[axis]) axis = 2;
    if (ext[axis] <= 0.0) return (l + r) / 2;  // all centroids equal: median

    auto caxis = [&](int64_t t) {
      const Vec3& c = centroid[t];
      return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
    };
    double c_lo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
    double scale = NBINS / ext[axis];

    Box bin_box[NBINS];
    int64_t bin_cnt[NBINS] = {0};
    for (int64_t i = l; i < r; i++) {
      int64_t t = order[i];
      int bidx = (int)((caxis(t) - c_lo) * scale);
      bidx = std::min(std::max(bidx, 0), NBINS - 1);
      bin_box[bidx].grow(tri_box[t]);
      bin_cnt[bidx]++;
    }
    // sweep for best SAH cost
    Box left_acc[NBINS];
    int64_t left_cnt[NBINS];
    Box acc;
    int64_t cnt = 0;
    for (int i = 0; i < NBINS; i++) {
      acc.grow(bin_box[i]);
      cnt += bin_cnt[i];
      left_acc[i] = acc;
      left_cnt[i] = cnt;
    }
    Box racc;
    double best = DBL_MAX;
    int best_bin = -1;
    for (int i = NBINS - 1; i >= 1; i--) {
      racc.grow(bin_box[i]);
      int64_t rc = (r - l) - left_cnt[i - 1];
      if (left_cnt[i - 1] == 0 || rc == 0) continue;
      double cost = left_acc[i - 1].half_area() * left_cnt[i - 1] +
                    racc.half_area() * rc;
      if (cost < best) {
        best = cost;
        best_bin = i;
      }
    }
    double leaf_cost = node_box.half_area() * (r - l);
    if (best_bin < 0 || ((r - l) <= leaf_size && best >= leaf_cost))
      return (l + r) / 2;

    double split_val = c_lo + best_bin / scale;
    int64_t m = l;
    for (int64_t i = l; i < r; i++) {
      if (caxis(order[i]) < split_val) std::swap(order[i], order[m++]);
    }
    if (m == l || m == r) m = (l + r) / 2;
    return m;
  }

  void build() {
    // iterative DFS: frame = (l, r, phase, node, m)
    struct Frame {
      int64_t l, r, m;
      int32_t node;
      int phase;
    };
    std::vector<Frame> st;
    st.push_back({0, T, 0, -1, 0});
    while (!st.empty()) {
      Frame& f = st.back();
      if (f.phase == 0) {
        Box bb;
        for (int64_t i = f.l; i < f.r; i++) bb.grow(tri_box[order[i]]);
        f.node = emit_node(bb);
        if (f.r - f.l <= leaf_size) {
          first[f.node] = (int32_t)f.l;
          count[f.node] = (int32_t)(f.r - f.l);
          skip_end[f.node] = f.node + 1;
          st.pop_back();
          continue;
        }
        f.m = find_split(f.l, f.r, bb);
        f.phase = 1;
        st.push_back({f.l, f.m, 0, -1, 0});
      } else if (f.phase == 1) {
        f.phase = 2;
        st.push_back({f.m, f.r, 0, -1, 0});
      } else {
        skip_end[f.node] = (int32_t)first.size();
        st.pop_back();
      }
    }
  }
};

}  // namespace

extern "C" {

// Build a flattened skip-link BVH. Caller passes output buffers sized for
// 2*T nodes (worst case). Returns the node count, or -1 on error.
int64_t mcpt_build_bvh(const double* v0, const double* e1, const double* e2,
                       int64_t T, int32_t leaf_size, float* out_lo,
                       float* out_hi, int32_t* out_first, int32_t* out_count,
                       int32_t* out_skip, int64_t* out_perm) {
  if (T <= 0) return -1;
  Builder b;
  b.v0 = v0;
  b.e1 = e1;
  b.e2 = e2;
  b.T = T;
  b.leaf_size = leaf_size;
  b.prepare();
  b.build();
  int64_t n = (int64_t)b.first.size();
  if (n > 2 * T) return -1;
  std::memcpy(out_lo, b.lo.data(), n * 3 * sizeof(float));
  std::memcpy(out_hi, b.hi.data(), n * 3 * sizeof(float));
  std::memcpy(out_first, b.first.data(), n * sizeof(int32_t));
  std::memcpy(out_count, b.count.data(), n * sizeof(int32_t));
  for (int64_t i = 0; i < n; i++)
    out_skip[i] = (b.skip_end[i] >= n) ? -1 : b.skip_end[i];
  std::memcpy(out_perm, b.order.data(), T * sizeof(int64_t));
  return n;
}

// ---------------------------------------------------------------------------
// OBJ parser
// ---------------------------------------------------------------------------

struct ObjResult {
  std::vector<double> verts, norms, uvs;
  std::vector<int32_t> faces;  // [nf][3][4] (v, vn, vt, mat_slot)
  std::string names;           // '\n'-joined usemtl names, slot order
};

static bool parse_double3(const char* p, double* out, int n) {
  char* end;
  for (int i = 0; i < n; i++) {
    out[i] = strtod(p, &end);
    if (end == p) return false;
    p = end;
  }
  return true;
}

// Parse "v/vt/vn", "v//vn", "v/vt", "v" into indices (1-based -> 0-based;
// negative OBJ indices are resolved by the caller-side counts we track).
static void parse_corner(const char*& p, int64_t nv, int64_t nt, int64_t nn,
                         int32_t* v, int32_t* vt, int32_t* vn) {
  char* end;
  long a = strtol(p, &end, 10);
  p = end;
  *v = (int32_t)(a > 0 ? a - 1 : (a < 0 ? nv + a : 0));
  *vt = 0;
  *vn = 0;
  if (*p == '/') {
    p++;
    if (*p != '/') {
      long b = strtol(p, &end, 10);
      p = end;
      *vt = (int32_t)(b > 0 ? b - 1 : (b < 0 ? nt + b : 0));
    }
    if (*p == '/') {
      p++;
      long c = strtol(p, &end, 10);
      p = end;
      *vn = (int32_t)(c > 0 ? c - 1 : (c < 0 ? nn + c : 0));
    }
  }
}

int mcpt_parse_obj(const char* path, double** out_verts, int64_t* nv,
                   double** out_norms, int64_t* nn, double** out_uvs,
                   int64_t* nt, int32_t** out_faces, int64_t* nf,
                   char** out_names, int64_t* names_len) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  ObjResult r;
  std::vector<std::string> slot_names;
  int32_t cur_mat = 0;
  char line[8192];
  while (fgets(line, sizeof(line), f)) {
    const char* p = line;
    while (*p == ' ' || *p == '\t') p++;
    if (p[0] == 'v' && p[1] == ' ') {
      double d[3];
      if (parse_double3(p + 2, d, 3)) r.verts.insert(r.verts.end(), d, d + 3);
    } else if (p[0] == 'v' && p[1] == 'n' && p[2] == ' ') {
      double d[3];
      if (parse_double3(p + 3, d, 3)) r.norms.insert(r.norms.end(), d, d + 3);
    } else if (p[0] == 'v' && p[1] == 't' && p[2] == ' ') {
      double d[2];
      if (parse_double3(p + 3, d, 2)) r.uvs.insert(r.uvs.end(), d, d + 2);
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      const char* q = p + 2;
      int32_t c[64][3];
      int ncorner = 0;
      int64_t cnv = (int64_t)r.verts.size() / 3;
      int64_t cnt = (int64_t)r.uvs.size() / 2;
      int64_t cnn = (int64_t)r.norms.size() / 3;
      while (ncorner < 64) {
        while (*q == ' ' || *q == '\t') q++;
        if (*q == '\0' || *q == '\n' || *q == '\r' || *q == '#') break;
        parse_corner(q, cnv, cnt, cnn, &c[ncorner][0], &c[ncorner][1],
                     &c[ncorner][2]);
        ncorner++;
      }
      // triangle fan (the reference reads only 3 corners; fan generalizes)
      for (int k = 1; k + 1 < ncorner; k++) {
        int idxs[3] = {0, k, k + 1};
        for (int j = 0; j < 3; j++) {
          int i = idxs[j];
          r.faces.push_back(c[i][0]);  // v
          r.faces.push_back(c[i][2]);  // vn
          r.faces.push_back(c[i][1]);  // vt
          r.faces.push_back(cur_mat);
        }
      }
    } else if (!strncmp(p, "usemtl", 6)) {
      const char* q = p + 6;
      while (*q == ' ' || *q == '\t') q++;
      std::string name;
      while (*q && *q != ' ' && *q != '\n' && *q != '\r') name.push_back(*q++);
      int32_t slot = -1;
      for (size_t i = 0; i < slot_names.size(); i++)
        if (slot_names[i] == name) {
          slot = (int32_t)i;
          break;
        }
      if (slot < 0) {
        slot = (int32_t)slot_names.size();
        slot_names.push_back(name);
      }
      cur_mat = slot;
    }
  }
  fclose(f);

  for (size_t i = 0; i < slot_names.size(); i++) {
    if (i) r.names.push_back('\n');
    r.names += slot_names[i];
  }

  auto copy_out = [](const void* src, size_t bytes) {
    void* p = malloc(bytes ? bytes : 1);
    memcpy(p, src, bytes);
    return p;
  };
  *nv = (int64_t)r.verts.size() / 3;
  *nn = (int64_t)r.norms.size() / 3;
  *nt = (int64_t)r.uvs.size() / 2;
  *nf = (int64_t)r.faces.size() / 12;
  *out_verts = (double*)copy_out(r.verts.data(), r.verts.size() * 8);
  *out_norms = (double*)copy_out(r.norms.data(), r.norms.size() * 8);
  *out_uvs = (double*)copy_out(r.uvs.data(), r.uvs.size() * 8);
  *out_faces = (int32_t*)copy_out(r.faces.data(), r.faces.size() * 4);
  *names_len = (int64_t)r.names.size();
  *out_names = (char*)copy_out(r.names.data(), r.names.size());
  return 0;
}

void mcpt_free(void* p) { free(p); }

}  // extern "C"
