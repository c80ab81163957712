// Host entry of griffin_ffn's down projection (ffn_common.cuh): how many
// row splits pass 2 cuts its N rows into, so the caller can size the
// [splits, M, D] partial sums before it launches griffin_ffn, which
// applies the same rule.

#include "ffn_common.cuh"

extern "C" int ffn_down_splits(int M, int N, int D, int n_sm) {
  int rows_per_split;
  return griffin::down_splits(M, N, D, n_sm, &rows_per_split);
}
