// Native SAH BVH + MTBVH builder.
//
// C++ twin of restir_tpu_torch/scene/bvh.py::_build_bvh_numpy (same
// algorithm family as the CUDA original's BVHBuilder::build + buildMTBVH,
// bvh.cpp:10-202, re-implemented from the Python spec). Produces the
// exact same flattened preorder layout and 6 direction-ordered stackless
// tables as the NumPy builder; the tests assert bitwise tree equality
// between the two.
//
// The builder is the renderer's heaviest host-side step for large
// scenes; this native path is O(20x) the NumPy builder's speed on big
// meshes.
//
// restir_tpu_torch's copy differs from restir_tpu/native/bvh.cpp only in
// `half_area`, which rounds as the NumPy builder does (see there).
//
// Build: g++ -O3 -ffp-contract=off -shared -fPIC (native/bvh_native.py):
// no FMA contraction, so the float math is the NumPy builder's on any host.
// ABI: plain C, NumPy arrays passed as raw pointers (ctypes).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kNumBuckets = 16;
constexpr int32_t kNullPrimitive = -1;

struct V3 {
  float x, y, z;
};

inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float get(const V3& v, int axis) {
  return axis == 0 ? v.x : (axis == 1 ? v.y : v.z);
}

inline double half_area(const V3& lo, const V3& hi) {
  // doubled surface area, rounded as the NumPy builder's `area` helper
  // rounds it: float32 products and sums, widened only for the SAH's
  // float64 lerp. Summed in double, equal SAH costs of boxes that share
  // a face (axis-aligned scenes) can round apart and move a split.
  float dx = std::max(0.0f, hi.x - lo.x);
  float dy = std::max(0.0f, hi.y - lo.y);
  float dz = std::max(0.0f, hi.z - lo.z);
  return (double)(2.0f * (dx * dy + dy * dz + dz * dx));
}

struct Builder {
  int64_t n;
  std::vector<V3> prim_lo, prim_hi, centers;
  float* bounds_lo;  // [2n-1, 3]
  float* bounds_hi;
  std::vector<uint8_t> leaf_flag;  // [2n-1]
  std::vector<int64_t> payload;    // prim id (leaf) | subtree size (inner)
  std::vector<int64_t> order;

  void build_node(int64_t offset, int64_t start, int64_t end) {
    int64_t m = end - start + 1;
    V3 lo = prim_lo[order[start]];
    V3 hi = prim_hi[order[start]];
    for (int64_t i = start; i <= end; ++i) {
      lo = vmin(lo, prim_lo[order[i]]);
      hi = vmax(hi, prim_hi[order[i]]);
    }
    bounds_lo[offset * 3 + 0] = lo.x;
    bounds_lo[offset * 3 + 1] = lo.y;
    bounds_lo[offset * 3 + 2] = lo.z;
    bounds_hi[offset * 3 + 0] = hi.x;
    bounds_hi[offset * 3 + 1] = hi.y;
    bounds_hi[offset * 3 + 2] = hi.z;

    if (m == 1) {
      leaf_flag[offset] = 1;
      payload[offset] = order[start];
      return;
    }
    leaf_flag[offset] = 0;
    payload[offset] = 2 * m - 1;

    V3 c_lo = centers[order[start]];
    V3 c_hi = centers[order[start]];
    for (int64_t i = start; i <= end; ++i) {
      c_lo = vmin(c_lo, centers[order[i]]);
      c_hi = vmax(c_hi, centers[order[i]]);
    }
    int axis = 0;
    float ext_x = c_hi.x - c_lo.x, ext_y = c_hi.y - c_lo.y,
          ext_z = c_hi.z - c_lo.z;
    // argmax over (x, y, z), first max wins (NumPy argmax semantics)
    float best_ext = ext_x;
    if (ext_y > best_ext) { axis = 1; best_ext = ext_y; }
    if (ext_z > best_ext) { axis = 2; best_ext = ext_z; }
    float extent = get(c_hi, axis) - get(c_lo, axis);

    int64_t div_local;
    if (!(extent > 0.0f) || !std::isfinite(extent)) {
      // all centroids identical: stable median split
      std::stable_sort(order.begin() + start, order.begin() + end + 1,
                       [&](int64_t a, int64_t b) {
                         return get(centers[a], axis) < get(centers[b], axis);
                       });
      div_local = m / 2 - 1;
    } else {
      // 16-bucket binned SAH, same float math as the NumPy builder
      std::vector<int> bucket(m);
      int64_t counts[kNumBuckets] = {0};
      V3 blo[kNumBuckets], bhi[kNumBuckets];
      for (int k = 0; k < kNumBuckets; ++k) {
        blo[k] = {INFINITY, INFINITY, INFINITY};
        bhi[k] = {-INFINITY, -INFINITY, -INFINITY};
      }
      for (int64_t i = 0; i < m; ++i) {
        int64_t id = order[start + i];
        float rel =
            (get(centers[id], axis) - get(c_lo, axis)) / extent * kNumBuckets;
        int bk = (int)rel;  // trunc toward zero like astype(int64)
        bk = std::min(std::max(bk, 0), kNumBuckets - 1);
        bucket[i] = bk;
        counts[bk]++;
        blo[bk] = vmin(blo[bk], prim_lo[id]);
        bhi[bk] = vmax(bhi[bk], prim_hi[id]);
      }
      // prefix/suffix unions
      V3 llo[kNumBuckets], lhi[kNumBuckets], rlo[kNumBuckets], rhi[kNumBuckets];
      llo[0] = blo[0];
      lhi[0] = bhi[0];
      for (int k = 1; k < kNumBuckets; ++k) {
        llo[k] = vmin(llo[k - 1], blo[k]);
        lhi[k] = vmax(lhi[k - 1], bhi[k]);
      }
      rlo[kNumBuckets - 1] = blo[kNumBuckets - 1];
      rhi[kNumBuckets - 1] = bhi[kNumBuckets - 1];
      for (int k = kNumBuckets - 2; k >= 0; --k) {
        rlo[k] = vmin(rlo[k + 1], blo[k]);
        rhi[k] = vmax(rhi[k + 1], bhi[k]);
      }
      int64_t cprefix = 0;
      double best_sah = std::numeric_limits<double>::infinity();
      int div_bucket = 0;
      for (int k = 0; k < kNumBuckets - 1; ++k) {
        cprefix += counts[k];
        double frac = (double)cprefix / (double)m;
        double sah = half_area(llo[k], lhi[k]) * (1.0 - frac) +
                     half_area(rlo[k + 1], rhi[k + 1]) * frac;
        if (sah < best_sah) {  // first min wins (argmin semantics)
          best_sah = sah;
          div_bucket = k;
        }
      }
      // stable partition by bucket <= div_bucket
      std::vector<int64_t> left, right;
      left.reserve(m);
      right.reserve(m);
      for (int64_t i = 0; i < m; ++i) {
        (bucket[i] <= div_bucket ? left : right).push_back(order[start + i]);
      }
      div_local = (int64_t)left.size() - 1;
      div_local = std::min(std::max(div_local, (int64_t)0), m - 2);
      if ((int64_t)left.size() == 0 || (int64_t)left.size() == m) {
        // degenerate partition clamped — rebuild split lists to match
        // the NumPy clamp (div_local forced into [0, m-2])
        std::vector<int64_t> merged = left;
        merged.insert(merged.end(), right.begin(), right.end());
        std::copy(merged.begin(), merged.end(), order.begin() + start);
      } else {
        std::copy(left.begin(), left.end(), order.begin() + start);
        std::copy(right.begin(), right.end(),
                  order.begin() + start + left.size());
      }
    }

    int64_t div = start + div_local;
    int64_t l_size = 2 * (div - start + 1) - 1;
    build_node(offset + 1, start, div);
    build_node(offset + 1 + l_size, div + 1, end);
  }
};

}  // namespace

extern "C" {

// vertices: [3n, 3] float32; outputs preallocated by the caller:
// bounds_lo/hi [2n-1, 3] f32; prim/box/miss [6, 2n-1] int32.
int build_bvh_native(const float* vertices, int64_t n_prims,
                     float* bounds_lo, float* bounds_hi, int32_t* mt_prim,
                     int32_t* mt_box, int32_t* mt_miss) {
  if (n_prims < 1) return -1;
  int64_t size = 2 * n_prims - 1;

  Builder b;
  b.n = n_prims;
  b.prim_lo.resize(n_prims);
  b.prim_hi.resize(n_prims);
  b.centers.resize(n_prims);
  for (int64_t i = 0; i < n_prims; ++i) {
    V3 v0 = {vertices[i * 9 + 0], vertices[i * 9 + 1], vertices[i * 9 + 2]};
    V3 v1 = {vertices[i * 9 + 3], vertices[i * 9 + 4], vertices[i * 9 + 5]};
    V3 v2 = {vertices[i * 9 + 6], vertices[i * 9 + 7], vertices[i * 9 + 8]};
    b.prim_lo[i] = vmin(v0, vmin(v1, v2));
    b.prim_hi[i] = vmax(v0, vmax(v1, v2));
    b.centers[i] = {(b.prim_lo[i].x + b.prim_hi[i].x) * 0.5f,
                    (b.prim_lo[i].y + b.prim_hi[i].y) * 0.5f,
                    (b.prim_lo[i].z + b.prim_hi[i].z) * 0.5f};
  }
  b.bounds_lo = bounds_lo;
  b.bounds_hi = bounds_hi;
  b.leaf_flag.assign(size, 0);
  b.payload.assign(size, 0);
  b.order.resize(n_prims);
  for (int64_t i = 0; i < n_prims; ++i) b.order[i] = i;

  if (n_prims == 1) {
    // degenerate single-leaf tree (matches the NumPy special case)
    bounds_lo[0] = b.prim_lo[0].x;
    bounds_lo[1] = b.prim_lo[0].y;
    bounds_lo[2] = b.prim_lo[0].z;
    bounds_hi[0] = b.prim_hi[0].x;
    bounds_hi[1] = b.prim_hi[0].y;
    bounds_hi[2] = b.prim_hi[0].z;
    for (int d = 0; d < 6; ++d) {
      mt_prim[d] = 0;
      mt_box[d] = 0;
      mt_miss[d] = 1;
    }
    return 0;
  }

  b.build_node(0, 0, n_prims - 1);

  // node centers for the direction ordering
  std::vector<V3> node_center(size);
  for (int64_t i = 0; i < size; ++i) {
    node_center[i] = {(bounds_lo[i * 3 + 0] + bounds_hi[i * 3 + 0]) * 0.5f,
                      (bounds_lo[i * 3 + 1] + bounds_hi[i * 3 + 1]) * 0.5f,
                      (bounds_lo[i * 3 + 2] + bounds_hi[i * 3 + 2]) * 0.5f};
  }

  // 6 direction-ordered stackless tables — bvh.cpp:133-193 semantics
  std::vector<int64_t> stack;
  for (int d = 0; d < 6; ++d) {
    int dim = d / 2;
    bool lesser = d & 1;
    int32_t* prim = mt_prim + (int64_t)d * size;
    int32_t* box = mt_box + (int64_t)d * size;
    int32_t* miss = mt_miss + (int64_t)d * size;

    stack.clear();
    stack.push_back(0);
    int64_t new_id = 0;
    while (!stack.empty()) {
      int64_t orig = stack.back();
      stack.pop_back();
      bool is_leaf = b.leaf_flag[orig];
      int64_t node_size = is_leaf ? 1 : b.payload[orig];

      prim[new_id] = is_leaf ? (int32_t)b.payload[orig] : kNullPrimitive;
      box[new_id] = (int32_t)orig;
      miss[new_id] = (int32_t)(new_id + node_size);
      new_id++;

      if (is_leaf) continue;
      int64_t left = orig + 1;
      int64_t left_size = b.leaf_flag[left] ? 1 : b.payload[left];
      int64_t right = left + left_size;
      if ((get(node_center[left], dim) < get(node_center[right], dim)) !=
          lesser) {
        std::swap(left, right);
      }
      stack.push_back(right);
      stack.push_back(left);
    }
  }
  return 0;
}

}  // extern "C"
