// Connected-component morphology for pseudo-mask refinement.
//
// The port's own copy of the JAX package's native morphology: the
// reference's skimage remove_small_objects + remove_small_holes, which run
// per image over thousands of 299x299 masks in the stage-3 pseudo-mask
// pipeline. A two-pass union-find labeler with areas folded into the find
// structure; one traversal per op, no allocation beyond the parent table.
//
// Semantics (skimage parity):
// - remove_small_objects: drop foreground components with area <  min_size
//   (components with area >= min_size survive), connectivity 1 = 4-conn,
//   2 = 8-conn.
// - remove_small_holes: fill background components with area <
//   area_threshold. Like skimage, the outer background is just another
//   component (it is large, so it survives).
//
// Build: g++ -O3 -shared -fPIC (native/build.py). ABI: plain C, driven
// through ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  std::vector<int64_t> area;

  explicit UnionFind(size_t n) : parent(n, -1), area(n, 0) {}

  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {  // path compression
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }

  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (area[a] < area[b]) { int32_t t = a; a = b; b = t; }
    parent[b] = a;
    area[a] += area[b];
  }
};

// Remove components of `value` whose area < threshold by writing
// `replacement` over them. connectivity: 1 (edges) or 2 (edges+corners).
void filter_components(uint8_t* mask, int h, int w, int64_t threshold,
                       int connectivity, uint8_t value, uint8_t replacement) {
  const size_t n = static_cast<size_t>(h) * w;
  UnionFind uf(n);

  // pass 1: create singleton sets for matching pixels, union with left/up
  // (and diagonal) neighbours.
  for (int y = 0; y < h; ++y) {
    const int row = y * w;
    for (int x = 0; x < w; ++x) {
      const int i = row + x;
      if (mask[i] != value) continue;
      uf.parent[i] = i;
      uf.area[i] += 1;
      if (x > 0 && mask[i - 1] == value) uf.unite(i, i - 1);
      if (y > 0) {
        if (mask[i - w] == value) uf.unite(i, i - w);
        if (connectivity >= 2) {
          if (x > 0 && mask[i - w - 1] == value) uf.unite(i, i - w - 1);
          if (x < w - 1 && mask[i - w + 1] == value) uf.unite(i, i - w + 1);
        }
      }
    }
  }

  // pass 2: rewrite pixels in components below the threshold.
  for (size_t i = 0; i < n; ++i) {
    if (mask[i] == value && uf.area[uf.find(static_cast<int32_t>(i))] < threshold)
      mask[i] = replacement;
  }
}

}  // namespace

extern "C" {

void remove_small_objects(uint8_t* mask, int h, int w, int64_t min_size,
                          int connectivity) {
  filter_components(mask, h, w, min_size, connectivity, 1, 0);
}

void remove_small_holes(uint8_t* mask, int h, int w, int64_t area_threshold,
                        int connectivity) {
  filter_components(mask, h, w, area_threshold, connectivity, 0, 1);
}

// Fused pipeline over a batch of masks (the generate_masks hot pass):
// objects < min_object removed, then holes < hole_area filled, per image.
void remove_small_regions_batch(uint8_t* masks, int n, int h, int w,
                                int64_t min_object, int64_t hole_area,
                                int connectivity) {
  const size_t stride = static_cast<size_t>(h) * w;
  for (int i = 0; i < n; ++i) {
    uint8_t* m = masks + i * stride;
    filter_components(m, h, w, min_object, connectivity, 1, 0);
    filter_components(m, h, w, hole_area, connectivity, 0, 1);
  }
}

}  // extern "C"
