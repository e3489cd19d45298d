// Host-side native kernels of the PyTorch port: the port's own copy of
// native/hostkernels.cpp (the JAX package's host library), function for
// function: connected components, greedy NMS, the exact Euclidean distance
// transform, hole filling with sprinkle removal over batches of mask score
// maps (the video pipeline's emission path, which runs on host numpy), and
// the stage-1 record store. Host C++ only, no device code: nvcc compiles it
// with the CUDA kernels so the build has one path (ops/_build.py), and g++
// builds the same file where there is no nvcc
// (g++ -O3 -shared -fPIC -pthread -x c++).
//
// Exposed via ctypes (see efficientsam3_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// Connected components, 8-connectivity, two-pass union-find.
// mask: h*w uint8 (nonzero = foreground); labels_out: h*w int32 (0 = bg,
// components numbered 1..K). Returns K.
// ---------------------------------------------------------------------------
static int32_t find_root(std::vector<int32_t>& parent, int32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];  // path halving
    x = parent[x];
  }
  return x;
}

int32_t cc_label(const uint8_t* mask, int32_t h, int32_t w, int32_t* labels_out) {
  const int32_t n = h * w;
  std::vector<int32_t> parent(n);
  for (int32_t i = 0; i < n; ++i) parent[i] = i;

  auto unite = [&](int32_t a, int32_t b) {
    int32_t ra = find_root(parent, a), rb = find_root(parent, b);
    if (ra != rb) parent[std::max(ra, rb)] = std::min(ra, rb);
  };

  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int32_t i = y * w + x;
      if (!mask[i]) continue;
      // scan-order neighbors: W, NW, N, NE
      if (x > 0 && mask[i - 1]) unite(i, i - 1);
      if (y > 0) {
        if (x > 0 && mask[i - w - 1]) unite(i, i - w - 1);
        if (mask[i - w]) unite(i, i - w);
        if (x + 1 < w && mask[i - w + 1]) unite(i, i - w + 1);
      }
    }
  }
  std::vector<int32_t> remap(n, 0);
  int32_t next = 0;
  for (int32_t i = 0; i < n; ++i) {
    if (!mask[i]) { labels_out[i] = 0; continue; }
    int32_t r = find_root(parent, i);
    if (remap[r] == 0) remap[r] = ++next;
    labels_out[i] = remap[r];
  }
  return next;
}

// ---------------------------------------------------------------------------
// Greedy NMS over a precomputed IoU matrix (n x n), score-descending order.
// keep_out: n uint8.
// ---------------------------------------------------------------------------
void nms_greedy(const float* iou, const float* scores, int32_t n,
                float thresh, uint8_t* keep_out) {
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](int32_t a, int32_t b) { return scores[a] > scores[b]; });
  std::memset(keep_out, 0, n);
  for (int32_t oi = 0; oi < n; ++oi) {
    const int32_t i = order[oi];
    bool ok = true;
    for (int32_t oj = 0; oj < oi; ++oj) {
      const int32_t j = order[oj];
      if (keep_out[j] && iou[i * n + j] > thresh) { ok = false; break; }
    }
    keep_out[i] = ok;
  }
}

// ---------------------------------------------------------------------------
// Exact Euclidean distance transform (Felzenszwalb & Huttenlocher),
// distance from nonzero pixels to the nearest zero pixel.
// ---------------------------------------------------------------------------
static void dt_1d(const float* f, float* d, int32_t n, std::vector<int32_t>& v,
                  std::vector<float>& z) {
  int32_t k = 0;
  v[0] = 0;
  z[0] = -1e20f;
  z[1] = 1e20f;
  for (int32_t q = 1; q < n; ++q) {
    float s;
    while (true) {
      s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2.0f * q - 2.0f * v[k]);
      if (s <= z[k]) { --k; } else break;
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = 1e20f;
  }
  k = 0;
  for (int32_t q = 0; q < n; ++q) {
    while (z[k + 1] < q) ++k;
    const float dq = q - v[k];
    d[q] = dq * dq + f[v[k]];
  }
}

void edt(const uint8_t* mask, int32_t h, int32_t w, float* out) {
  const float INF = 1e20f;
  std::vector<float> f(std::max(h, w)), d(std::max(h, w));
  std::vector<int32_t> v(std::max(h, w));
  std::vector<float> z(std::max(h, w) + 1);
  std::vector<float> tmp(h * w);

  // columns first
  for (int32_t x = 0; x < w; ++x) {
    for (int32_t y = 0; y < h; ++y) f[y] = mask[y * w + x] ? INF : 0.0f;
    dt_1d(f.data(), d.data(), h, v, z);
    for (int32_t y = 0; y < h; ++y) tmp[y * w + x] = d[y];
  }
  // then rows
  for (int32_t y = 0; y < h; ++y) {
    dt_1d(tmp.data() + y * w, d.data(), w, v, z);
    for (int32_t x = 0; x < w; ++x) out[y * w + x] = std::sqrt(d[x]);
  }
}

// ---------------------------------------------------------------------------
// Batched hole filling + sprinkle removal on mask score maps (reference
// sam3_tracker_utils.py:392 fill_holes_in_mask_scores): for each (h, w)
// score map, (a) background components (score <= 0, 8-connectivity) with
// area <= max_area are overwritten with fill_value (+0.1), then (b) if
// remove_sprinkles, foreground components (score > 0 AFTER the fill pass)
// with area <= min(total_fg_area / 2, max_area) are overwritten with
// sprinkle_value (-0.1) — small stray blobs are dropped without killing
// genuinely tiny tracked objects. Run-based union-find: runs of
// consecutive same-side pixels are the union-find nodes (>=10x fewer
// find/unite ops than per-pixel labeling on noisy masks), united against
// the overlapping runs of the previous row, then patched in place. One
// call handles the whole (b, h, w) batch, threaded over masks (they are
// independent) — the Python per-mask label/bincount/fancy-index loop cost
// ~21 ms for 8x288^2 noise masks; single-thread runs is ~9 ms worst-case
// (noise) / <1 ms typical, and threading divides the worst case by the
// batch fan-out.
// ---------------------------------------------------------------------------
namespace {

struct RunCC {
  std::vector<int32_t> parent, run_xs, run_xe, row0, area;

  // Build runs of pixels where (row[x] > 0) == positive, unite across rows
  // (8-connectivity), accumulate component areas. Returns total run area.
  int64_t label(const float* s, int32_t h, int32_t w, bool positive) {
    parent.clear(); run_xs.clear(); run_xe.clear();
    row0.assign(h + 1, 0);
    int64_t total = 0;
    for (int32_t y = 0; y < h; ++y) {
      row0[y] = (int32_t)run_xs.size();
      const float* row = s + (int64_t)y * w;
      int32_t prev = (y > 0) ? row0[y - 1] : 0;
      const int32_t prev_end = (y > 0) ? row0[y] : 0;
      for (int32_t x = 0; x < w;) {
        if ((row[x] > 0.0f) != positive) { ++x; continue; }
        const int32_t xs = x;
        while (x < w && (row[x] > 0.0f) == positive) ++x;
        const int32_t xe = x - 1;  // inclusive
        const int32_t id = (int32_t)run_xs.size();
        run_xs.push_back(xs); run_xe.push_back(xe); parent.push_back(id);
        total += xe - xs + 1;
        // 8-connectivity: overlap with prev-row runs widened by 1
        while (prev < prev_end && run_xe[prev] < xs - 1) ++prev;
        for (int32_t p = prev; p < prev_end && run_xs[p] <= xe + 1; ++p) {
          int32_t ra = find_root(parent, id), rb = find_root(parent, p);
          if (ra != rb) parent[std::max(ra, rb)] = std::min(ra, rb);
        }
      }
    }
    row0[h] = (int32_t)run_xs.size();
    const int32_t nruns = (int32_t)run_xs.size();
    area.assign(nruns, 0);
    for (int32_t r = 0; r < nruns; ++r)
      area[find_root(parent, r)] += run_xe[r] - run_xs[r] + 1;
    return total;
  }

  // Overwrite pixels of components with area <= thresh.
  void patch_small(float* s, int32_t h, int32_t w, float thresh, float value) {
    for (int32_t y = 0; y < h; ++y) {
      float* row = s + (int64_t)y * w;
      for (int32_t r = row0[y]; r < row0[y + 1]; ++r) {
        const int32_t a = area[find_root(parent, r)];
        if ((float)a <= thresh)
          for (int32_t x = run_xs[r]; x <= run_xe[r]; ++x) row[x] = value;
      }
    }
  }
};

void fill_one(float* s, int32_t h, int32_t w, float max_area,
              float fill_value, int32_t remove_sprinkles,
              float sprinkle_value, RunCC& cc) {
  cc.label(s, h, w, /*positive=*/false);
  cc.patch_small(s, h, w, max_area, fill_value);
  if (remove_sprinkles) {
    // fg threshold: min(total_fg // 2, max_area) — reference
    // sam3_tracker_utils.py:417-428 (floor_divide then clamp)
    const int64_t fg = cc.label(s, h, w, /*positive=*/true);
    const float thresh = std::min((float)(fg / 2), max_area);
    cc.patch_small(s, h, w, thresh, sprinkle_value);
  }
}

}  // namespace

void fill_holes(float* scores, int32_t b, int32_t h, int32_t w,
                float max_area, float fill_value) {
  RunCC cc;
  for (int32_t img = 0; img < b; ++img)
    fill_one(scores + (int64_t)img * h * w, h, w, max_area, fill_value,
             0, 0.0f, cc);
}

void fill_holes_sprinkles(float* scores, int32_t b, int32_t h, int32_t w,
                          float max_area, float fill_value,
                          int32_t remove_sprinkles, float sprinkle_value) {
  unsigned hw = std::thread::hardware_concurrency();
  const int32_t nthreads = std::max(1, std::min<int32_t>(b, hw ? (int32_t)hw : 1));
  if (nthreads <= 1 || b <= 1) {
    RunCC cc;
    for (int32_t img = 0; img < b; ++img)
      fill_one(scores + (int64_t)img * h * w, h, w, max_area, fill_value,
               remove_sprinkles, sprinkle_value, cc);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int32_t t = 0; t < nthreads; ++t) {
    pool.emplace_back([=]() {
      RunCC cc;
      for (int32_t img = t; img < b; img += nthreads)
        fill_one(scores + (int64_t)img * h * w, h, w, max_area, fill_value,
                 remove_sprinkles, sprinkle_value, cc);
    });
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// Fixed-item-size keyed binary record reader (stage-1 embedding store,
// replacing the reference's TxtManager byte store). The file layout is
// [count: int64][item_size: int64][items...]; items addressed by index.
// ---------------------------------------------------------------------------
int64_t record_store_item_size(const char* path) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  int64_t header[2];
  if (std::fread(header, sizeof(int64_t), 2, fp) != 2) { std::fclose(fp); return -1; }
  std::fclose(fp);
  return header[1];
}

int64_t record_store_count(const char* path) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  int64_t header[2];
  if (std::fread(header, sizeof(int64_t), 2, fp) != 2) { std::fclose(fp); return -1; }
  std::fclose(fp);
  return header[0];
}

int32_t record_store_read(const char* path, int64_t index, uint8_t* out,
                          int64_t out_size) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  int64_t header[2];
  if (std::fread(header, sizeof(int64_t), 2, fp) != 2) { std::fclose(fp); return -2; }
  if (index < 0 || index >= header[0] || out_size < header[1]) {
    std::fclose(fp);
    return -3;
  }
  if (std::fseek(fp, 16 + index * header[1], SEEK_SET) != 0) { std::fclose(fp); return -4; }
  const size_t got = std::fread(out, 1, (size_t)header[1], fp);
  std::fclose(fp);
  return got == (size_t)header[1] ? 0 : -5;
}

}  // extern "C"
