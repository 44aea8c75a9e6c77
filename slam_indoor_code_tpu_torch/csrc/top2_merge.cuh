// The running top-2 that every top-2 kernel of the port keeps per query row,
// and the merge of two such partials — the device side of
// slam_indoor_code_tpu/ops/pallas_kernels.py:_merge_top2.
//
// A partial (d1, i1, d2) over some set of columns holds the smallest
// distance d1, the lowest column i1 attaining it, and the second smallest
// distance d2 over the other columns (a duplicate minimum gives d2 == d1).
// The empty partial is (3e38, 0, 3e38).

#pragma once

namespace {

// Fold distance d of column col into the partial.  Columns must come in
// increasing order: the strict '<' then keeps the lowest column of a tie.
// With d1 <= d2, the new second smallest is min(d2, max(d1, d)).
__device__ __forceinline__ void top2_fold(float d, int col, float& d1,
                                          int& i1, float& d2) {
  d2 = fminf(d2, fmaxf(d1, d));
  i1 = d < d1 ? col : i1;
  d1 = fminf(d1, d);
}

// Merge another partial (e1, j1, e2) over a disjoint column set into
// (d1, i1, d2): the smaller (distance, column) pair wins, and d2 is the
// second smallest of the union, min(d2, e2, max(d1, e1)).
__device__ __forceinline__ void top2_merge(float& d1, int& i1, float& d2,
                                           float e1, int j1, float e2) {
  const float lo2 = fminf(d2, e2);
  const float hi1 = fmaxf(d1, e1);
  if (e1 < d1 || (e1 == d1 && j1 < i1)) {
    d1 = e1;
    i1 = j1;
  }
  d2 = fminf(lo2, hi1);
}

}  // namespace
