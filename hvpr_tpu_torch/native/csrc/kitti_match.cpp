// KITTI devkit greedy matching kernel (per image, per threshold).
//
// Native fast path for hvpr_tpu_torch/datasets/kitti/kitti_object_eval_python/
// eval.py::compute_statistics — the sequential TP/FP matching loop the
// reference runs via numba JIT (eval.py:157-275 upstream). Semantics are
// identical to the Python implementation (which remains the fallback and
// the correctness oracle in tests).

#include <cmath>
#include <cstdint>

namespace {
constexpr double NO_DETECTION = -10000000.0;
}

extern "C" {

// overlaps: (num_dt, num_gt) row-major
// gt_alphas: (num_gt,), dt_alphas/dt_scores: (num_dt,)
// ignored_gt: (num_gt,), ignored_det: (num_dt,) in {-1, 0, 1}
// out: [tp, fp, fn, similarity, n_thresholds]; out_thresholds: (num_gt,) buffer
void kitti_compute_statistics(
    const double* overlaps, int64_t num_dt, int64_t num_gt,
    const double* gt_alphas, const double* dt_alphas, const double* dt_scores,
    const int32_t* ignored_gt, const int32_t* ignored_det,
    double min_overlap, double thresh, int32_t compute_fp, int32_t compute_aos,
    double* out, double* out_thresholds, int32_t* assigned_out) {
  bool* assigned = new bool[num_dt]();
  bool* ignored_threshold = new bool[num_dt]();
  if (compute_fp) {
    for (int64_t j = 0; j < num_dt; ++j)
      if (dt_scores[j] < thresh) ignored_threshold[j] = true;
  }

  int64_t tp = 0, fp = 0, fn = 0;
  double similarity = 0.0;
  int64_t n_thresh = 0;
  double aos_sum = 0.0;

  for (int64_t i = 0; i < num_gt; ++i) {
    if (ignored_gt[i] == -1) continue;
    int64_t det_idx = -1;
    double valid_detection = NO_DETECTION;
    double max_overlap = 0.0;
    bool assigned_ignored_det = false;

    for (int64_t j = 0; j < num_dt; ++j) {
      if (ignored_det[j] == -1 || assigned[j] || ignored_threshold[j]) continue;
      const double overlap = overlaps[j * num_gt + i];
      const double dt_score = dt_scores[j];
      if (!compute_fp && overlap > min_overlap && dt_score > valid_detection) {
        det_idx = j;
        valid_detection = dt_score;
      } else if (compute_fp && overlap > min_overlap
                 && (overlap > max_overlap || assigned_ignored_det)
                 && ignored_det[j] == 0) {
        max_overlap = overlap;
        det_idx = j;
        valid_detection = 1.0;
        assigned_ignored_det = false;
      } else if (compute_fp && overlap > min_overlap
                 && valid_detection == NO_DETECTION && ignored_det[j] == 1) {
        det_idx = j;
        valid_detection = 1.0;
        assigned_ignored_det = true;
      }
    }

    if (valid_detection == NO_DETECTION && ignored_gt[i] == 0) {
      ++fn;
    } else if (valid_detection != NO_DETECTION
               && (ignored_gt[i] == 1 || ignored_det[det_idx] == 1)) {
      assigned[det_idx] = true;
    } else if (valid_detection != NO_DETECTION) {
      ++tp;
      out_thresholds[n_thresh++] = dt_scores[det_idx];
      if (compute_aos) aos_sum += (1.0 + std::cos(gt_alphas[i] - dt_alphas[det_idx])) / 2.0;
      assigned[det_idx] = true;
    }
  }

  if (compute_fp) {
    for (int64_t j = 0; j < num_dt; ++j) {
      if (!(assigned[j] || ignored_det[j] == -1 || ignored_det[j] == 1
            || ignored_threshold[j]))
        ++fp;
    }
    if (compute_aos) similarity = (tp > 0 || fp > 0) ? aos_sum : -1.0;
  }

  for (int64_t j = 0; j < num_dt; ++j) assigned_out[j] = assigned[j] ? 1 : 0;
  out[0] = static_cast<double>(tp);
  out[1] = static_cast<double>(fp);
  out[2] = static_cast<double>(fn);
  out[3] = similarity;
  out[4] = static_cast<double>(n_thresh);

  delete[] assigned;
  delete[] ignored_threshold;
}

}  // extern "C"
