// Native LBVH builder — the BLAS/TLAS build analog as a host component.
//
// The reference builds acceleration structures natively through the
// Vulkan driver (Model.cpp:114-186, Scene.cpp:323-440). Here the build
// is plain C++: Morton codes, stable sort, Karras-2012 binary radix
// tree, and a post-order AABB pass. Semantics match ops/bvh.py
// build_bvh EXACTLY (same f32 quantization, same index tie-break delta,
// same stable ordering) so the two builders are interchangeable; the
// native one exists because the jitted device build costs an XLA
// compile per new triangle count, while this runs in milliseconds for
// any size.
//
// Node indexing for T triangles (ops/bvh.py:11-13):
//   internal 0..T-2; leaf k = node (T-1)+k holding sorted triangle k.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

inline uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

inline int clz32(uint32_t x) { return x == 0 ? 32 : __builtin_clz(x); }

struct Builder {
  int64_t T;
  const float *v0, *v1, *v2;
  std::vector<uint32_t> codes;   // sorted
  std::vector<int32_t> order;    // sorted pos -> original tri
  std::vector<int32_t> left, right;

  // longest-common-prefix metric with index tie-break (Karras §4;
  // matches ops/bvh.py _delta bit-for-bit)
  inline int delta(int64_t i, int64_t j) const {
    if (j < 0 || j >= T) return -1;
    uint32_t ci = codes[i], cj = codes[j];
    if (ci != cj) return clz32(ci ^ cj);
    return 32 + clz32(uint32_t(i) ^ uint32_t(j));
  }

  void build_tree() {
    left.assign(std::max<int64_t>(T - 1, 0), 0);
    right.assign(std::max<int64_t>(T - 1, 0), 0);
    for (int64_t i = 0; i < T - 1; ++i) {
      int d = (delta(i, i + 1) > delta(i, i - 1)) ? 1 :
              (delta(i, i + 1) < delta(i, i - 1)) ? -1 : 1;
      int dmin = delta(i, i - d);
      int64_t lmax = 2;
      while (delta(i, i + lmax * d) > dmin) lmax *= 2;
      int64_t l = 0;
      for (int64_t t = lmax / 2; t > 0; t /= 2)
        if (delta(i, i + (l + t) * d) > dmin) l += t;
      int64_t j = i + l * d;
      int dnode = delta(i, j);
      // fixed 32-iteration split search with repeating t=1 tail —
      // EXACTLY the jnp builder's loop (ops/bvh.py split_body), so the
      // two builders produce identical trees
      int64_t s = 0, div = 2;
      for (int it = 0; it < 32; ++it) {
        int64_t t = (l + div - 1) / div;
        if (t > 0 && delta(i, i + (s + t) * d) > dnode) s += t;
        div = std::min<int64_t>(div * 2, int64_t(1) << 30);
      }
      int64_t gamma = i + s * d + std::min(d, 0);
      int64_t lo = std::min(i, j), hi = std::max(i, j);
      left[i] = (lo == gamma) ? int32_t((T - 1) + gamma) : int32_t(gamma);
      right[i] = (hi == gamma + 1) ? int32_t((T - 1) + gamma + 1)
                                   : int32_t(gamma + 1);
    }
  }
};

}  // namespace

extern "C" {

// Outputs must be caller-allocated:
//   node_min/node_max: (2T-1)*3 floats; left/right/tri: (2T-1) int32.
// Returns 0 on success.
int hr_build_lbvh(const float* v0, const float* v1, const float* v2,
                     int64_t T, float* node_min, float* node_max,
                     int32_t* left_out, int32_t* right_out,
                     int32_t* tri_out) {
  if (T <= 0) return 1;
  const int64_t N = 2 * T - 1;
  if (T == 1) {
    for (int a = 0; a < 3; ++a) {
      node_min[a] = std::min(std::min(v0[a], v1[a]), v2[a]);
      node_max[a] = std::max(std::max(v0[a], v1[a]), v2[a]);
    }
    left_out[0] = -1; right_out[0] = -1; tri_out[0] = 0;
    return 0;
  }

  // scene bounds + centroids (f32 arithmetic, matching the jnp builder)
  float smin[3] = {3e38f, 3e38f, 3e38f}, smax[3] = {-3e38f, -3e38f, -3e38f};
  for (int64_t i = 0; i < T; ++i)
    for (int a = 0; a < 3; ++a) {
      float mn = std::min(std::min(v0[3 * i + a], v1[3 * i + a]),
                          v2[3 * i + a]);
      float mx = std::max(std::max(v0[3 * i + a], v1[3 * i + a]),
                          v2[3 * i + a]);
      smin[a] = std::min(smin[a], mn);
      smax[a] = std::max(smax[a], mx);
    }
  float extent[3];
  for (int a = 0; a < 3; ++a) extent[a] = std::max(smax[a] - smin[a], 1e-9f);

  std::vector<uint32_t> codes(T);
  for (int64_t i = 0; i < T; ++i) {
    uint32_t xyz[3];
    for (int a = 0; a < 3; ++a) {
      float c = (v0[3 * i + a] + v1[3 * i + a] + v2[3 * i + a]) / 3.0f;
      float q = (c - smin[a]) / extent[a];
      q = std::min(std::max(q, 0.0f), 0.99999994f);  // 1 - 1e-7 in f32
      xyz[a] = uint32_t(q * 1024.0f);
    }
    codes[i] = expand_bits(xyz[0]) * 4 + expand_bits(xyz[1]) * 2
             + expand_bits(xyz[2]);
  }

  Builder b;
  b.T = T; b.v0 = v0; b.v1 = v1; b.v2 = v2;
  b.order.resize(T);
  std::iota(b.order.begin(), b.order.end(), 0);
  std::stable_sort(b.order.begin(), b.order.end(),
                   [&](int32_t x, int32_t y) { return codes[x] < codes[y]; });
  b.codes.resize(T);
  for (int64_t i = 0; i < T; ++i) b.codes[i] = codes[b.order[i]];
  b.build_tree();

  for (int64_t i = 0; i < T - 1; ++i) {
    left_out[i] = b.left[i];
    right_out[i] = b.right[i];
    tri_out[i] = -1;
  }
  for (int64_t k = 0; k < T; ++k) {
    left_out[T - 1 + k] = -1;
    right_out[T - 1 + k] = -1;
    tri_out[T - 1 + k] = b.order[k];
  }

  // leaf AABBs
  for (int64_t k = 0; k < T; ++k) {
    int32_t t = b.order[k];
    for (int a = 0; a < 3; ++a) {
      node_min[(T - 1 + k) * 3 + a] = std::min(
          std::min(v0[3 * t + a], v1[3 * t + a]), v2[3 * t + a]);
      node_max[(T - 1 + k) * 3 + a] = std::max(
          std::max(v0[3 * t + a], v1[3 * t + a]), v2[3 * t + a]);
    }
  }
  // post-order AABB union (iterative DFS; every internal node visited
  // after both children)
  std::vector<int32_t> stack;
  std::vector<uint8_t> seen(T - 1, 0);
  stack.reserve(96);
  stack.push_back(0);
  while (!stack.empty()) {
    int32_t n = stack.back();
    if (n >= T - 1) { stack.pop_back(); continue; }  // leaf: ready
    if (!seen[n]) {
      seen[n] = 1;
      stack.push_back(left_out[n]);
      stack.push_back(right_out[n]);
      continue;
    }
    stack.pop_back();
    int32_t l = left_out[n], r = right_out[n];
    for (int a = 0; a < 3; ++a) {
      node_min[n * 3 + a] = std::min(node_min[l * 3 + a],
                                     node_min[r * 3 + a]);
      node_max[n * 3 + a] = std::max(node_max[l * 3 + a],
                                     node_max[r * 3 + a]);
    }
  }
  (void)N;
  return 0;
}

// Binned-SAH top-down builder (Wald 2007), same node convention as the
// LBVH: internal nodes 0..T-2 assigned in pre-order (root 0, left
// subtree first, so a subtree over k leaves owns a contiguous block of
// k-1 internal ids), leaf k = node (T-1)+k holding the k-th triangle
// of the FINAL partition order. The reference requests
// PREFER_FAST_TRACE structures (Scene.cpp:397, Model.cpp:150) — the
// driver's SAH build; this is that analog (host sim: 1.3-1.7x fewer
// packet traversal steps than the LBVH on the stress scene).
int hr_build_sah(const float* v0, const float* v1, const float* v2,
                    int64_t T, float* node_min, float* node_max,
                    int32_t* left_out, int32_t* right_out,
                    int32_t* tri_out) {
  if (T <= 0) return 1;
  if (T == 1) {
    for (int a = 0; a < 3; ++a) {
      node_min[a] = std::min(std::min(v0[a], v1[a]), v2[a]);
      node_max[a] = std::max(std::max(v0[a], v1[a]), v2[a]);
    }
    left_out[0] = -1; right_out[0] = -1; tri_out[0] = 0;
    return 0;
  }
  constexpr int NB = 16;
  std::vector<float> tlo(3 * T), thi(3 * T), cen(3 * T);
  for (int64_t i = 0; i < T; ++i)
    for (int a = 0; a < 3; ++a) {
      float mn = std::min(std::min(v0[3 * i + a], v1[3 * i + a]),
                          v2[3 * i + a]);
      float mx = std::max(std::max(v0[3 * i + a], v1[3 * i + a]),
                          v2[3 * i + a]);
      tlo[3 * i + a] = mn;
      thi[3 * i + a] = mx;
      cen[3 * i + a] = 0.5f * (mn + mx);
    }
  std::vector<int32_t> order(T);
  std::iota(order.begin(), order.end(), 0);

  auto area = [](const float* lo, const float* hi) {
    float d0 = std::max(hi[0] - lo[0], 0.0f);
    float d1 = std::max(hi[1] - lo[1], 0.0f);
    float d2 = std::max(hi[2] - lo[2], 0.0f);
    return d0 * d1 + d1 * d2 + d2 * d0;
  };

  struct Range { int64_t lo, hi; int32_t node; };
  std::vector<Range> stack;
  stack.reserve(128);
  int32_t next_internal = 1;  // root = 0
  stack.push_back({0, T, 0});

  while (!stack.empty()) {
    Range rg = stack.back();
    stack.pop_back();
    int64_t lo = rg.lo, hi = rg.hi, n = hi - lo;
    // centroid bounds
    float cmin[3] = {3e38f, 3e38f, 3e38f};
    float cmax[3] = {-3e38f, -3e38f, -3e38f};
    for (int64_t i = lo; i < hi; ++i) {
      const float* c = &cen[3 * order[i]];
      for (int a = 0; a < 3; ++a) {
        cmin[a] = std::min(cmin[a], c[a]);
        cmax[a] = std::max(cmax[a], c[a]);
      }
    }
    int axis = 0;
    float ext = -1.0f;
    for (int a = 0; a < 3; ++a)
      if (cmax[a] - cmin[a] > ext) { ext = cmax[a] - cmin[a]; axis = a; }

    int64_t mid = -1;
    if (ext > 1e-12f) {
      // binned SAH on the widest centroid axis
      float scale = NB / (cmax[axis] - cmin[axis]);
      int64_t cnt[NB] = {0};
      float blo[NB][3], bhi[NB][3];
      for (int b = 0; b < NB; ++b)
        for (int a = 0; a < 3; ++a) { blo[b][a] = 3e38f; bhi[b][a] = -3e38f; }
      for (int64_t i = lo; i < hi; ++i) {
        int32_t t = order[i];
        int b = std::min<int>(NB - 1, int((cen[3 * t + axis] - cmin[axis])
                                          * scale));
        cnt[b]++;
        for (int a = 0; a < 3; ++a) {
          blo[b][a] = std::min(blo[b][a], tlo[3 * t + a]);
          bhi[b][a] = std::max(bhi[b][a], thi[3 * t + a]);
        }
      }
      // suffix areas
      float rarea[NB] = {0};
      {
        float acc_lo[3] = {3e38f, 3e38f, 3e38f};
        float acc_hi[3] = {-3e38f, -3e38f, -3e38f};
        for (int b = NB - 1; b >= 1; --b) {
          for (int a = 0; a < 3; ++a) {
            acc_lo[a] = std::min(acc_lo[a], blo[b][a]);
            acc_hi[a] = std::max(acc_hi[a], bhi[b][a]);
          }
          rarea[b] = area(acc_lo, acc_hi);
        }
      }
      // prefix sweep
      float best = 3e38f;
      int best_b = -1;
      {
        float acc_lo[3] = {3e38f, 3e38f, 3e38f};
        float acc_hi[3] = {-3e38f, -3e38f, -3e38f};
        int64_t lcnt = 0;
        for (int b = 0; b < NB - 1; ++b) {
          for (int a = 0; a < 3; ++a) {
            acc_lo[a] = std::min(acc_lo[a], blo[b][a]);
            acc_hi[a] = std::max(acc_hi[a], bhi[b][a]);
          }
          lcnt += cnt[b];
          if (lcnt == 0 || lcnt == n) continue;
          float cost = area(acc_lo, acc_hi) * lcnt
                     + rarea[b + 1] * (n - lcnt);
          if (cost < best) { best = cost; best_b = b; }
        }
      }
      if (best_b >= 0) {
        auto it = std::partition(
            order.begin() + lo, order.begin() + hi, [&](int32_t t) {
              int b = std::min<int>(NB - 1,
                                    int((cen[3 * t + axis] - cmin[axis])
                                        * scale));
              return b <= best_b;
            });
        mid = it - order.begin();
        if (mid == lo || mid == hi) mid = -1;
      }
    }
    if (mid < 0) {  // degenerate centroids: median split
      mid = lo + n / 2;
      std::nth_element(order.begin() + lo, order.begin() + mid,
                       order.begin() + hi, [&](int32_t x, int32_t y) {
                         return cen[3 * x + axis] < cen[3 * y + axis];
                       });
    }

    int64_t nl = mid - lo, nr = hi - mid;
    // internal ids allocated sequentially at assignment (exactly one
    // per split → T-1 total); leaves are position-determined
    int32_t lid = (nl > 1) ? next_internal++ : int32_t((T - 1) + lo);
    int32_t rid = (nr > 1) ? next_internal++ : int32_t((T - 1) + mid);
    left_out[rg.node] = lid;
    right_out[rg.node] = rid;
    tri_out[rg.node] = -1;
    if (nr > 1) stack.push_back({mid, hi, rid});
    if (nl > 1) stack.push_back({lo, mid, lid});
  }

  for (int64_t k = 0; k < T; ++k) {
    int32_t t = order[k];
    left_out[T - 1 + k] = -1;
    right_out[T - 1 + k] = -1;
    tri_out[T - 1 + k] = t;
    for (int a = 0; a < 3; ++a) {
      node_min[(T - 1 + k) * 3 + a] = tlo[3 * t + a];
      node_max[(T - 1 + k) * 3 + a] = thi[3 * t + a];
    }
  }
  // post-order AABB union (same pass as the LBVH)
  std::vector<int32_t> st2;
  std::vector<uint8_t> seen(T - 1, 0);
  st2.reserve(96);
  st2.push_back(0);
  while (!st2.empty()) {
    int32_t nd = st2.back();
    if (nd >= T - 1) { st2.pop_back(); continue; }
    if (!seen[nd]) {
      seen[nd] = 1;
      st2.push_back(left_out[nd]);
      st2.push_back(right_out[nd]);
      continue;
    }
    st2.pop_back();
    int32_t l = left_out[nd], r = right_out[nd];
    for (int a = 0; a < 3; ++a) {
      node_min[nd * 3 + a] = std::min(node_min[l * 3 + a],
                                      node_min[r * 3 + a]);
      node_max[nd * 3 + a] = std::max(node_max[l * 3 + a],
                                      node_max[r * 3 + a]);
    }
  }
  return 0;
}

}  // extern "C"
