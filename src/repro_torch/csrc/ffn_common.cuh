// The down-projection pass of griffin_ffn.cu and the in-order reduction
// of its splits (glu_ffn.cu has its own, merged in a thread block
// cluster).
//
// y[M, D] = z[M, N] . W2[rows(n), D] with an fp32 accumulator, where z
// holds the first pass's activations already rounded to the input dtype
// (as the TPU kernel rounds before its second dot) and rows(n) is
// block_ids[n / bs] * bs + n % bs (n when block_ids is null).  W2 rows are
// read in place, never compacted.
//
// Grid (D / kDownCols column tiles, splits, M / MT row chunks): one thread
// per output column, so a warp reads 32 neighbouring elements of a W2 row;
// the N rows are cut into `splits` ranges (down_splits) so a decode step
// (M = 2) still fills the card.  Each split writes its partial sum to
// part[split, M, D] and ffn_reduce adds the splits in split order: the
// result does not depend on scheduling.  With one split the partial sum is
// the output.  The caller sizes part from ffn_down_splits (ffn_common.cu),
// which applies the same rule.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace griffin {
// internal linkage: each translation unit that includes this header gets
// its own copy of the kernels, so the FF sources link side by side
namespace {

constexpr int kDownCols = 128;  // threads (output columns) of a CTA
constexpr int kDownRows = 64;   // W2 rows staged per step
constexpr int kCtasPerSm = 2;   // CTAs per SM the row split aims at

// rows of z (MT) one CTA takes
constexpr int down_rows_tile(int M) { return M <= 4 ? 4 : 16; }

// number of splits of the N rows, and the rows each takes: column tiles x
// row chunks x splits come to about kCtasPerSm CTAs per SM, and no split
// gets fewer than kDownRows rows
inline int down_splits(int M, int N, int D, int n_sm, int* rows_per_split) {
  if (N <= 0) {
    *rows_per_split = 0;
    return 1;
  }
  const int mt = down_rows_tile(M);
  const int base = ((D + kDownCols - 1) / kDownCols) * ((M + mt - 1) / mt);
  const int splits =
      std::max(1, std::min((N + kDownRows - 1) / kDownRows,
                           (kCtasPerSm * n_sm + base - 1) / base));
  const int rps = (N + splits - 1) / splits;
  *rows_per_split = rps;
  return (N + rps - 1) / rps;
}

template <typename T, int MT>
__global__ void __launch_bounds__(kDownCols)
ffn_down(const T* __restrict__ z,            // [M, N]
         const T* __restrict__ w2,           // [F, D]
         const int* __restrict__ block_ids,  // [N / bs] or null
         float* __restrict__ part,           // [splits, M, D]
         int M, int N, int D, int bs, int rows_per_split) {
  __shared__ float zs[MT][kDownRows];
  __shared__ long long rows[kDownRows];
  const int tid = threadIdx.x;
  const int d = blockIdx.x * kDownCols + tid;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT;
  const int mc = min(MT, M - m0);
  const int n_begin = split * rows_per_split;
  const int n_end = min(N, n_begin + rows_per_split);
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;

  for (int n0 = n_begin; n0 < n_end; n0 += kDownRows) {
    const int nk = min(kDownRows, n_end - n0);
    __syncthreads();  // the previous step's zs/rows are consumed
    for (int i = tid; i < MT * kDownRows; i += kDownCols) {
      const int m = i / kDownRows, k = i % kDownRows;
      zs[m][k] = (m < mc && k < nk)
                     ? to_f32(z[(long long)(m0 + m) * N + n0 + k])
                     : 0.f;
    }
    for (int k = tid; k < nk; k += kDownCols) {
      const int n = n0 + k;
      rows[k] = block_ids ? (long long)block_ids[n / bs] * bs + n % bs : n;
    }
    __syncthreads();
    if (d < D) {
#pragma unroll 4
      for (int k = 0; k < nk; ++k) {
        const float w = to_f32(w2[rows[k] * D + d]);
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m] += zs[m][k] * w;
      }
    }
  }
  if (d < D) {
    for (int m = 0; m < mc; ++m)
      part[((long long)split * M + m0 + m) * D + d] = acc[m];
  }
}

// y[i] = sum over splits, in split order, of part[split, i]
__global__ void __launch_bounds__(256)
ffn_reduce(const float* __restrict__ part, float* __restrict__ y,
           long long n, int splits) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[(long long)sp * n + i];
  y[i] = s;
}

// launches pass 2 (and the reduction when there is more than one split)
// over the splits down_splits gives for n_sm SMs; part holds that many
// [M, D] partial sums, or is null when there is one
template <typename T>
cudaError_t launch_down(const T* z, const T* w2, const int* block_ids,
                        float* part, float* y, int M, int N, int D, int bs,
                        int n_sm, cudaStream_t stream) {
  int rows_per_split;
  const int splits = down_splits(M, N, D, n_sm, &rows_per_split);
  float* out = splits > 1 ? part : y;
  if (down_rows_tile(M) == 4) {
    dim3 grid((D + kDownCols - 1) / kDownCols, splits, (M + 3) / 4);
    ffn_down<T, 4><<<grid, kDownCols, 0, stream>>>(z, w2, block_ids, out, M,
                                                    N, D, bs, rows_per_split);
  } else {
    dim3 grid((D + kDownCols - 1) / kDownCols, splits, (M + 15) / 16);
    ffn_down<T, 16><<<grid, kDownCols, 0, stream>>>(z, w2, block_ids, out, M,
                                                     N, D, bs, rows_per_split);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long n = (long long)M * D;
  ffn_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, y, n,
                                                               splits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace griffin
