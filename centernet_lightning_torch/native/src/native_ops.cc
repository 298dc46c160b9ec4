// Native host-side hot loops (C ABI, loaded via ctypes): a copy of the
// JAX package's native/src/native_ops.cc, so the port's tracker pairs
// detections exactly as the JAX tracker does on the same cost matrix.
//
// Hungarian assignment (SciPy's linear_sum_assignment contract) for the
// tracker's association, and COCOeval's greedy matching (the inner loop of
// pycocotools' evaluateImg). Both are single-threaded and allocation-light:
// the arrays are small (<=300 dets, <=10 IoU thresholds) but the loops run
// O(images x classes x frames) times, where the interpreter would dominate.
// native/__init__.py builds this file with g++ on first use.

#include <algorithm>
#include <cstddef>
#include <limits>
#include <vector>

extern "C" {

// Minimum-cost linear assignment via shortest augmenting paths
// (Jonker-Volgenant). Requires n <= m; the Python wrapper transposes when
// needed. `cost` is row-major n*m, finite. `col4row[i]` receives the column
// assigned to row i. Returns 0 on success, 1 if no feasible augmenting path
// exists (non-finite costs).
int cl_lap_assign(const double* cost, int n, int m, int* col4row) {
  const double kInf = std::numeric_limits<double>::infinity();
  // 1-indexed potentials/assignment; column 0 is the virtual start column.
  std::vector<double> u(static_cast<size_t>(n) + 1, 0.0);
  std::vector<double> v(static_cast<size_t>(m) + 1, 0.0);
  std::vector<int> p(static_cast<size_t>(m) + 1, 0);    // p[j] = row in col j
  std::vector<int> way(static_cast<size_t>(m) + 1, 0);
  std::vector<double> minv(static_cast<size_t>(m) + 1);
  std::vector<char> used(static_cast<size_t>(m) + 1);

  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::fill(minv.begin(), minv.end(), kInf);
    std::fill(used.begin(), used.end(), 0);
    do {
      used[j0] = 1;
      const int i0 = p[j0];
      int j1 = 0;
      double delta = kInf;
      const double* row = cost + static_cast<size_t>(i0 - 1) * m;
      for (int j = 1; j <= m; ++j) {
        if (used[j]) continue;
        const double cur = row[j - 1] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      if (j1 == 0) return 1;  // infeasible
      for (int j = 0; j <= m; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    // Augment along the found path.
    do {
      const int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0 != 0);
  }

  for (int j = 1; j <= m; ++j) {
    if (p[j] != 0) col4row[p[j] - 1] = j - 1;
  }
  return 0;
}

// COCOeval greedy matching (pycocotools cocoeval.evaluateImg inner loop).
// Detections arrive score-sorted; for each IoU threshold each detection
// takes the highest-IoU not-yet-taken GT at/above the threshold, preferring
// any non-ignored GT over ignored ones; crowd GTs are never marked taken
// (any number of detections may ignore-match one). Exact-IoU ties break to
// the LAST tied GT — pycocotools' loop updates on `>=` — matching both the
// numpy reference path and pycocotools bit-for-bit.
//
// ious: row-major D*G; thrs: T; gt_ig/gt_crowd: G (0/1);
// dtm out: row-major T*D, entries = matched GT index + 1, 0 = unmatched.
void cl_coco_match(const double* ious, int D, int G, const double* thrs,
                   int T, const unsigned char* gt_ig,
                   const unsigned char* gt_crowd, long long* dtm) {
  std::vector<char> taken(static_cast<size_t>(G));
  const double kLim = 1.0 - 1e-10;
  for (int t = 0; t < T; ++t) {
    const double thr_eff = thrs[t] < kLim ? thrs[t] : kLim;
    std::fill(taken.begin(), taken.end(), 0);
    long long* out = dtm + static_cast<size_t>(t) * D;
    for (int d = 0; d < D; ++d) {
      const double* row = ious + static_cast<size_t>(d) * G;
      int best_real = -1, best_any = -1;
      double bv_real = -1.0, bv_any = -1.0;
      for (int g = 0; g < G; ++g) {
        if (taken[g] && !gt_crowd[g]) continue;
        const double iou = row[g];
        if (iou < thr_eff) continue;
        if (!gt_ig[g] && iou >= bv_real) {
          bv_real = iou;
          best_real = g;
        }
        if (iou >= bv_any) {
          bv_any = iou;
          best_any = g;
        }
      }
      const int match = best_real >= 0 ? best_real : best_any;
      out[d] = 0;
      if (match >= 0) {
        out[d] = match + 1;
        taken[match] = 1;
      }
    }
  }
}

}  // extern "C"
