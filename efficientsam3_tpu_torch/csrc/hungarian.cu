// Exact Hungarian assignment on the host for a batch of cost matrices: the
// native form of efficientsam3_tpu_torch/ops/hungarian.py's NumPy solver
// (and of efficientsam3_tpu/ops/hungarian.py, which is plain JAX, not a
// Pallas kernel). Host C++ only: nvcc compiles it with the kernels so the
// build has one path.
//
// Why native: a Stage-3 step solves S * B = 44 matrices of 40 targets x 200
// queries (11 decoder layers' o2o and aux-o2m sets, batch 4). Targets are
// padded to 40 with constant-cost rows, and every padded row grows an
// augmenting path through all earlier padded rows' columns (they tie), so
// the 44 matrices take ~700 path steps a step; NumPy pays ~0.2 ms of call
// overhead per lockstep path step, 170 ms a training step on the H100's
// host. Here each matrix is a few hundred thousand float operations, and
// the matrices are split over threads.
//
// Semantics are the NumPy version's, operation for operation in float32:
// the e-maxx formulation with a virtual column 0, cur = (cost - u[i0]) -
// v[j], strict '<' relaxation, the first index of the least masked minv,
// then u += delta over used columns' rows, v -= delta over used columns,
// minv -= delta over unused ones. No products appear, so no contraction
// into fused multiply-adds can change a result.

#include <algorithm>
#include <thread>
#include <vector>

namespace {

void solve_one(const float* cost, int t, int q, int* out) {
  const float INF = 1e18f;
  std::vector<float> u(t + 1, 0.f), v(q + 1, 0.f), minv(q + 1);
  std::vector<int> p(q + 1, 0), way(q + 1);
  std::vector<char> used(q + 1);
  for (int i = 0; i < t; ++i) {
    std::fill(minv.begin(), minv.end(), INF);
    std::fill(used.begin(), used.end(), 0);
    std::fill(way.begin(), way.end(), 0);
    p[0] = i + 1;
    int j0 = 0;
    while (p[j0] != 0) {
      used[j0] = 1;
      const int i0 = p[j0];
      const float* row = cost + static_cast<long long>(i0 - 1) * q;
      const float ui = u[i0];
      for (int j = 1; j <= q; ++j) {
        if (used[j]) continue;
        const float cur = (row[j - 1] - ui) - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
      }
      int j1 = 1;
      float delta = used[1] ? INF : minv[1];
      for (int j = 2; j <= q; ++j) {
        const float m = used[j] ? INF : minv[j];
        if (m < delta) {
          delta = m;
          j1 = j;
        }
      }
      for (int j = 0; j <= q; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    }
    while (j0 != 0) {  // augment along `way` back to the virtual column
      const int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    }
  }
  for (int j = 1; j <= q; ++j)
    if (p[j] != 0) out[p[j] - 1] = j - 1;
}

}  // namespace

// cost (n, t, q) float32 row-major with t <= q -> out (n, t) int32 column
// per row. Returns 0, or 1 when t > q.
extern "C" int hungarian_solve(const float* cost, int n, int t, int q, int* out) {
  if (t > q) return 1;
  const int hw = static_cast<int>(std::thread::hardware_concurrency());
  const int workers = std::max(1, std::min(n, hw > 0 ? hw : 1));
  auto run = [&](int w) {
    for (int k = w; k < n; k += workers)
      solve_one(cost + static_cast<long long>(k) * t * q, t, q, out + static_cast<long long>(k) * t);
  };
  std::vector<std::thread> pool;
  for (int w = 1; w < workers; ++w) pool.emplace_back(run, w);
  run(0);
  for (auto& th : pool) th.join();
  return 0;
}
