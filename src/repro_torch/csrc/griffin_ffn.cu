// GRIFFIN's zero-copy pruned decode FF on Hopper:
//   y = (act(x . Wg_sel^T) * (x . W1_sel^T)) . W2_sel,  fp32 out,
// over the selected blocks of `bs` neuron rows of the [F, D] weights.
//
// Replaces: repro/kernels/griffin_ffn.py::griffin_ffn / _kernel (Pallas,
// TPU), entry point ops.griffin_ffn_decode.  The TPU kernel prefetches the
// block ids as scalars and lets them drive its BlockSpec index maps; here
// they drive a row map (ffn_common.cuh: Blocks), so the selected rows of
// Wg, W1 and W2 are read in place and no compacted copy is made.
//
// Bound on the H100: bytes.  At decode (B rows of x, B small) every
// selected weight element is read once and used B times, so the
// 3 * n_sel * D * itemsize weight bytes over 3.35 TB/s bound the call
// (Yi-9B at half its blocks in bf16: 135 MB, 40 us); the operations
// (6 * B * n_sel * D) are far below the bf16 ridge.
//
// Design: two launches of the tiled loop that glu_ffn.cu also runs
// (ffn_common.cuh), no library call, no scratch besides z:
// * Up pass (ffn_up, BT): z = act(x . Wg_sel^T) * (x . W1_sel^T).  Wg and
//   W1 are neuron rows, so a weight tile is [n][k]: kUpN neurons (rows
//   map(n)) by 128 bytes of D, staged as it lies and handed to
//   mma.sync.m16n8k16 through plain ldmatrix (an [n][k] tile is the mma's
//   column-major B operand).  x is the A operand in row tiles of 16 (a
//   decode step is one tile, no padding beyond 16 rows).  D is cut into
//   ranges merged in a cluster, g and h before the activation; z is
//   rounded to x's dtype, as the TPU kernel rounds before its second dot.
// * Down pass (ffn_down): y = z . W2_sel, glu_ffn's down pass with z's
//   column k reading W2's row map(k): [k][n] tiles of 128 columns, the
//   selected rows cut into at most 8 ranges per column tile that merge in
//   rank order in a cluster (no partial buffer, no reduction launch).
// * bf16 weights come by TMA when the block size is a multiple of 64 (so
//   a 64-row box never leaves a selected block) and the rows and
//   addresses are 16-byte aligned; otherwise each row is staged by
//   cp.async from its mapped address.  fp32 runs the same tiles on exact
//   FMA.  kernels/griffin_ffn.py::griffin_plan sizes the ranges so every
//   CTA of a pass is resident at once (3 per SM at a 16-row tile, 2 at 64
//   rows; griffin_ffn_resident_ctas lets the card tests check registers
//   and shared memory against that): at Yi-9B width with 43 of 86 blocks,
//   86 neuron tiles x 4 D ranges for the up pass and 32 column tiles x 8
//   ranges of the 5,504 rows for the down pass.
// * Both passes are programmatic dependent launches (ffn_common.cuh): the
//   down pass's CTAs may start while the up pass still runs, head their
//   first W2 tiles for L2, and wait for z (griddepcontrol.wait), which
//   hides part of the second launch.
// * What shaped the tiles, from timing variants on the H100 (bf16, Yi-9B,
//   43 of 86 blocks): 64 neurons by 128 bytes at 3 CTAs per SM was the
//   fastest up pass; 128 neurons, 256-byte k tiles, deeper or shallower
//   rings, k tiles interleaved across the cluster, Wg and W1 on separate
//   CTAs, and the up pass prefetching W2 into L2 were each as fast or
//   slower.
// * Bits are the same from run to run: every sum has a fixed order.

#include <type_traits>

#include "ffn_common.cuh"

namespace {

using namespace griffin;

constexpr int kUpN = 64;          // neurons (z columns) of an up-pass CTA
constexpr int kUpKBytes = 128;    // bytes of an x row per up-pass k tile
constexpr int kDownN = 128;       // y columns of a down-pass CTA
constexpr int kDownKBytes = 128;  // bytes of a z row per down-pass k tile

// rows of x (and z) one CTA takes: 16 for a decode step, 64 above
inline int row_tile(int M) { return M <= 16 ? 16 : 64; }

// a decode step's passes fit 3 CTAs per SM (227 KB of shared memory)
template <typename T, bool TMA>
constexpr bool fits3() {
  constexpr int budget = 232448 / 3 - 1024;  // less what the runtime keeps
  return Tiles<T, 16, kUpN, 2, kUpKBytes, TMA, true>::smem <= budget &&
         Tiles<T, 16, kDownN, 1, kDownKBytes, TMA, false>::smem <= budget;
}
static_assert(fits3<float, false>() && fits3<__nv_bfloat16, false>() &&
                  fits3<__nv_bfloat16, true>(),
              "griffin_plan counts 3 CTAs per SM at a 16-row tile");

template <typename T, int MT, bool TMA>
cudaError_t launch(const T* x, const T* wg, const T* w1, const T* w2, Blocks map, T* z,
                   float* y, int M, int D, int F, int n_sel, int act, int up_splits,
                   int up_k, int down_splits, int down_k, const CUtensorMap* maps,
                   cudaStream_t stream) {
  constexpr int isz = sizeof(T);
  const int m_tiles = (M + MT - 1) / MT;
  cudaError_t e = launch_clusters(
      ffn_up<T, MT, kUpN, kUpKBytes, TMA, true, Blocks>,
      Tiles<T, MT, kUpN, 2, kUpKBytes, TMA, true>::smem, (n_sel + kUpN - 1) / kUpN,
      up_splits, m_tiles, stream, x, wg, w1, z, M, D, n_sel, act, up_splits, up_k,
      copy_bytes(D * isz, isz, x), copy_bytes(D * isz, isz, wg, w1), map, F, maps[0],
      maps[1]);
  if (e != cudaSuccess) return e;
  return launch_clusters(
      ffn_down<T, MT, kDownN, kDownKBytes, TMA, Blocks>,
      Tiles<T, MT, kDownN, 1, kDownKBytes, TMA, false>::smem, (D + kDownN - 1) / kDownN,
      down_splits, m_tiles, stream, static_cast<const T*>(z), w2, y, M, D, n_sel,
      down_splits, down_k, copy_bytes(n_sel * isz, isz, z), copy_bytes(D * isz, isz, w2),
      map, maps[2]);
}

template <typename T>
cudaError_t launch_any(const void* x, const void* wg, const void* w1, const void* w2,
                       const int* ids, void* z, void* y, int M, int D, int F, int n_sel,
                       int bs, int act, int up_splits, int up_k, int down_splits,
                       int down_k, cudaStream_t st) {
  // bf16 weights come by TMA where a box of 64 rows stays in one block and
  // the rows and addresses are 16-byte aligned
  CUtensorMap maps[3] = {};
  const bool tma = std::is_same<T, __nv_bfloat16>::value && bs % kBoxRows == 0 &&
                   D % 8 == 0 && aligned16(wg) && aligned16(w1) && aligned16(w2) &&
                   bf16_map(&maps[0], wg, F, D, kBoxRows) &&
                   bf16_map(&maps[1], w1, F, D, kBoxRows) &&
                   bf16_map(&maps[2], w2, F, D, kDownKBytes / 2);
  auto run = [&](auto mt, auto use_tma) {
    return launch<T, decltype(mt)::value, decltype(use_tma)::value>(
        static_cast<const T*>(x), static_cast<const T*>(wg), static_cast<const T*>(w1),
        static_cast<const T*>(w2), Blocks{ids, bs, F / bs}, static_cast<T*>(z),
        static_cast<float*>(y), M, D, F, n_sel, act, up_splits, up_k, down_splits, down_k,
        maps, st);
  };
  using I16 = std::integral_constant<int, 16>;
  using I64 = std::integral_constant<int, 64>;
  using Yes = std::true_type;
  using No = std::false_type;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tma) return row_tile(M) == 16 ? run(I16{}, Yes{}) : run(I64{}, Yes{});
  }
  return row_tile(M) == 16 ? run(I16{}, No{}) : run(I64{}, No{});
}

template <typename T, int MT, bool TMA>
void resident(int* up, int* down) {
  *up = resident_ctas(ffn_up<T, MT, kUpN, kUpKBytes, TMA, true, Blocks>,
                      Tiles<T, MT, kUpN, 2, kUpKBytes, TMA, true>::smem);
  *down = resident_ctas(ffn_down<T, MT, kDownN, kDownKBytes, TMA, Blocks>,
                        Tiles<T, MT, kDownN, 1, kDownKBytes, TMA, false>::smem);
}

}  // namespace

// x [M, D], wg/w1/w2 [F, D] in one dtype (fp32 or bf16); block_ids [n_sel /
// bs] int32 in any order (z's columns follow it), an id outside [0, F /
// bs) a block that adds nothing (its rows are read from block F / bs - 1
// and its z columns written as zeros, so nothing out of bounds is read); z
// [M, n_sel] scratch in x's dtype; y [M, D] fp32.  act: 0 swiglu, 1 geglu
// (tanh), 2 reglu.  The up pass cuts D, the down pass the n_sel selected
// rows, into ranges that run as one cluster per column tile
// (kernels/griffin_ffn.py::griffin_plan): up_splits ranges of up_k rows,
// down_splits of down_k, each a whole number of k tiles (128 bytes of an x
// row, 128 bytes of a z row), none empty; else cudaErrorInvalidValue.
extern "C" int griffin_ffn(const void* x, const void* wg, const void* w1, const void* w2,
                           const void* block_ids, void* z, void* y, int M, int D, int F,
                           int n_sel, int bs, int act, int up_splits, int up_k,
                           int down_splits, int down_k, int is_bf16, void* stream) {
  const int isz = is_bf16 ? 2 : 4;
  const bool ok = M > 0 && D > 0 && bs > 0 && F % bs == 0 && n_sel > 0 &&
                  n_sel % bs == 0 &&
                  valid_split(D, up_splits, up_k, kUpKBytes / isz) &&
                  valid_split(n_sel, down_splits, down_k, kDownKBytes / isz);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* ids = static_cast<const int*>(block_ids);
  const cudaError_t e =
      is_bf16 ? launch_any<__nv_bfloat16>(x, wg, w1, w2, ids, z, y, M, D, F, n_sel, bs, act,
                                          up_splits, up_k, down_splits, down_k, st)
              : launch_any<float>(x, wg, w1, w2, ids, z, y, M, D, F, n_sel, bs, act,
                                  up_splits, up_k, down_splits, down_k, st);
  return static_cast<int>(e);
}

// CTAs of the up and the down pass that one SM holds at once (registers
// and shared memory) for M rows of x, fp32 or bf16, with or without TMA
// weights: what kernels/griffin_ffn.py::ctas_per_sm assumes is checked
// against this on the card.
extern "C" int griffin_ffn_resident_ctas(int M, int is_bf16, int tma, int* up, int* down) {
  *up = *down = 0;
  if (M <= 0 || (tma && !is_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  const bool r16 = row_tile(M) == 16;
  if (!is_bf16)
    r16 ? resident<float, 16, false>(up, down) : resident<float, 64, false>(up, down);
  else if (!tma)
    r16 ? resident<__nv_bfloat16, 16, false>(up, down)
        : resident<__nv_bfloat16, 64, false>(up, down);
  else
    r16 ? resident<__nv_bfloat16, 16, true>(up, down)
        : resident<__nv_bfloat16, 64, true>(up, down);
  return static_cast<int>(cudaGetLastError());
}
