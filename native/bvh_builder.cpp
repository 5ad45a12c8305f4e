// Native BVH builder for raytrace2.
//
// Reimplements the reference's build algorithm (median split on the span
// bounds' longest axis, children sorted by AABB min on that axis —
// the reference's src/cpu_raytrace/BVH.cpp:10-48) over flat arrays, with
// pre-order node numbering identical to the NumPy builder in
// raytrace2/scene/bvh.py (the two are cross-checked by
// tests/test_bvh.py). Exposed via a C ABI for ctypes.
//
// Build: make -C native     (produces libbvh.so)

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct Span {
  int start;
  int end;
  int node;
};

}  // namespace

extern "C" {

// Returns the number of nodes written (2n-1) or -1 on error.
// mins/maxs: [n,3] row-major primitive AABBs.
// out_min/out_max: [2n-1,3]; left/right/prim: [2n-1].
int bvh_build(int n, const float* mins, const float* maxs, float* out_min,
              float* out_max, int32_t* left, int32_t* right, int32_t* prim) {
  if (n <= 0) return -1;
  const int m = 2 * n - 1;
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);

  std::vector<Span> stack;
  stack.reserve(64);
  stack.push_back({0, n, 0});

  while (!stack.empty()) {
    Span s = stack.back();
    stack.pop_back();
    // Span bounds.
    float mn[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float mx[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    for (int i = s.start; i < s.end; ++i) {
      const int p = order[i];
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::min(mn[a], mins[p * 3 + a]);
        mx[a] = std::max(mx[a], maxs[p * 3 + a]);
      }
    }
    for (int a = 0; a < 3; ++a) {
      out_min[s.node * 3 + a] = mn[a];
      out_max[s.node * 3 + a] = mx[a];
    }
    const int count = s.end - s.start;
    if (count == 1) {
      left[s.node] = -1;
      right[s.node] = -1;
      prim[s.node] = order[s.start];
      continue;
    }
    // Longest axis of the span bounds; stable sort by child min.
    int axis = 0;
    float best = mx[0] - mn[0];
    for (int a = 1; a < 3; ++a) {
      const float e = mx[a] - mn[a];
      if (e > best) {
        best = e;
        axis = a;
      }
    }
    std::stable_sort(order.begin() + s.start, order.begin() + s.end,
                     [&](int a, int b) { return mins[a * 3 + axis] < mins[b * 3 + axis]; });
    // Pre-order layout: node over c prims occupies [id, id + 2c - 1);
    // left child at id+1 (mid prims), right child at id + 2*mid.
    const int mid = count / 2;
    const int l_id = s.node + 1;
    const int r_id = s.node + 2 * mid;
    left[s.node] = l_id;
    right[s.node] = r_id;
    prim[s.node] = -1;
    stack.push_back({s.start + mid, s.end, r_id});
    stack.push_back({s.start, s.start + mid, l_id});
  }
  return m;
}

}  // extern "C"
