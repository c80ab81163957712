// Dense GLU FF forward on Hopper:
//   y = (act(x . Wg) * (x . W1)) . W2,  fp32 out,
// x [M, D], Wg/W1 [D, F], W2 [F, D].
//
// Replaces: repro/kernels/glu_ffn.py::glu_ffn / _kernel (Pallas, TPU),
// entry point ops.glu_ffn_forward.  Unlike the TPU kernel it takes any M,
// D and F (no F % 512 tile rule: Yi-9B's F = 11008 is not a multiple of
// 512).
//
// Bound on the H100: bytes.  At a prefill chunk of M = 32 rows the three
// weight matrices (3 * D * F * itemsize, 270 MB at Yi-9B width in bf16)
// take 81 us at 3.35 TB/s, against 9 us for the operations (6 * M * D * F)
// at the bf16 tensor-core rate.  So the kernel has to keep the weights
// streaming at the memory rate from every SM, and do its products on the
// tensor cores fast enough to stay behind the loads.
//
// Design: two launches, no library call, no scratch besides z.
// * Both passes are the tiled loop of ffn_common.cuh (ffn_up and ffn_down
//   with the Dense row map and [k][n] weight tiles): a CTA of 4 warps owns
//   an output tile [MT rows, BN = 128 columns] over one range of the K
//   rows, and tiles of the A operand (x or z) and of the weights stream
//   through a ring of kStages stages.  bf16 weights whose rows and addresses are 16-byte
//   aligned come by TMA: per stage one thread issues [BK, 64] boxes of a
//   tensor map (128-byte swizzled, the tensor's edges zero-filled by the
//   copy engine) that complete on the stage's mbarrier.  Everything else
//   (the A tiles, fp32 and unaligned weights) is cp.async, 16-byte copies
//   where the rows and pointers allow, narrower otherwise, ragged edges
//   zero-filled in shared memory.
// * The K rows of a column tile are cut into ranges (at most 8) that run
//   as one thread block cluster; each CTA leaves its fp32 partials in
//   shared memory and, after a cluster barrier, rank r sums the float4
//   groups r, r + splits, ... over every rank in rank order (distributed
//   shared memory), so the sum order is fixed and no partial goes through
//   device memory.  The up pass (z = act(x . Wg) * (x . W1)) merges g and
//   h before the activation; the down pass (y = z . W2) merges y.
//   kernels/glu_ffn.py::glu_plan sizes the ranges so that every CTA of a
//   pass is resident at once at 3 CTAs per SM: at Yi-9B width 86 column
//   tiles x 4 ranges for the up pass, 32 x 8 for the down pass.
// * Both passes are programmatic dependent launches (ffn_common.cuh): the
//   down pass may start while the up pass runs, heads its first W2 tiles
//   for L2 and then waits for z (griddepcontrol.wait).
// * What shaped the tiles, from timing variants on the H100: whole
//   residency mattered most (a ring of 3 stages, ~60 KB, lets 3 CTAs
//   share an SM; deeper rings that cost residency or a second wave were
//   slower); 256-byte runs of a weight row (BN = 128, with the K split to
//   keep the CTA count) beat 128-byte runs; TMA boxes beat cp.async for
//   the weights, while 1-D bulk copies of single rows were slower than
//   either.
// * bf16: mma.sync.m16n8k16 with fp32 accumulators; x and z tiles come
//   through ldmatrix (rows padded by 16 bytes), the [k][n] weight tiles
//   through ldmatrix.trans (the swizzle, or the padding, keeps both free
//   of bank conflicts).  z = act(g) * h is rounded to bf16 before the
//   second product, as the TPU kernel rounds before its second dot.
// * fp32: tensor cores would mean TF32 (~3 digits), outside the 1e-4
//   tolerance at K = 4096, so the same tiles and ring feed exact fp32 FMA
//   (a thread owns 4 columns of several rows).
// * Bits are the same from run to run: every sum has a fixed order.

#include <type_traits>

#include "ffn_common.cuh"

namespace {

using namespace griffin;

constexpr int kUpN = 128;        // z columns of an up-pass CTA
constexpr int kUpKBytes = 64;    // bytes of an x row per up-pass k tile
constexpr int kDownN = 128;      // y columns of a down-pass CTA
constexpr int kDownKBytes = 128; // bytes of a z row per down-pass k tile

// rows of x (and z) one CTA takes: 32 for a prefill chunk, 64 above
inline int row_tile(int M) { return M <= 32 ? 32 : 64; }

template <typename T, int MT, bool TMA>
cudaError_t launch(const T* x, const T* wg, const T* w1, const T* w2, T* z,
                   float* y, int M, int D, int F, int act, int up_splits,
                   int up_k, int down_splits, int down_k, const CUtensorMap* maps,
                   cudaStream_t stream) {
  constexpr int isz = sizeof(T);
  const int m_tiles = (M + MT - 1) / MT;
  cudaError_t e = launch_clusters(
      ffn_up<T, MT, kUpN, kUpKBytes, TMA, false, Dense>,
      Tiles<T, MT, kUpN, 2, kUpKBytes, TMA, false>::smem, (F + kUpN - 1) / kUpN,
      up_splits, m_tiles, stream, x, wg, w1, z, M, D, F, act, up_splits, up_k,
      copy_bytes(D * isz, isz, x), copy_bytes(F * isz, isz, wg, w1), Dense{}, 0,
      maps[0], maps[1]);
  if (e != cudaSuccess) return e;
  return launch_clusters(
      ffn_down<T, MT, kDownN, kDownKBytes, TMA, Dense>,
      Tiles<T, MT, kDownN, 1, kDownKBytes, TMA, false>::smem, (D + kDownN - 1) / kDownN,
      down_splits, m_tiles, stream, static_cast<const T*>(z), w2, y, M, D, F,
      down_splits, down_k, copy_bytes(F * isz, isz, z), copy_bytes(D * isz, isz, w2),
      Dense{}, maps[2]);
}

template <typename T>
cudaError_t launch_any(const void* x, const void* wg, const void* w1,
                       const void* w2, void* z, void* y, int M, int D, int F,
                       int act, int up_splits, int up_k, int down_splits,
                       int down_k, cudaStream_t st) {
  // bf16 weights whose rows and addresses are 16-byte aligned come by TMA
  CUtensorMap maps[3] = {};
  const bool tma = std::is_same<T, __nv_bfloat16>::value && D % 8 == 0 && F % 8 == 0 &&
                   aligned16(wg) && aligned16(w1) && aligned16(w2) &&
                   bf16_map(&maps[0], wg, D, F, kUpKBytes / 2) &&
                   bf16_map(&maps[1], w1, D, F, kUpKBytes / 2) &&
                   bf16_map(&maps[2], w2, F, D, kDownKBytes / 2);
  auto run = [&](auto mt, auto use_tma) {
    return launch<T, decltype(mt)::value, decltype(use_tma)::value>(
        static_cast<const T*>(x), static_cast<const T*>(wg),
        static_cast<const T*>(w1), static_cast<const T*>(w2),
        static_cast<T*>(z), static_cast<float*>(y), M, D, F, act, up_splits,
        up_k, down_splits, down_k, maps, st);
  };
  using I32 = std::integral_constant<int, 32>;
  using I64 = std::integral_constant<int, 64>;
  using Yes = std::true_type;
  using No = std::false_type;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tma) return row_tile(M) == 32 ? run(I32{}, Yes{}) : run(I64{}, Yes{});
  }
  return row_tile(M) == 32 ? run(I32{}, No{}) : run(I64{}, No{});
}

}  // namespace

// x [M, D], wg/w1 [D, F], w2 [F, D] in one dtype (fp32 or bf16); z [M, F]
// scratch in x's dtype; y [M, D] fp32.  act: 0 swiglu, 1 geglu (tanh),
// 2 reglu.  The up pass cuts D, the down pass F, into ranges that run as
// one cluster per column tile (kernels/glu_ffn.py::k_splits): up_splits
// ranges of up_k rows, down_splits of down_k, each a whole number of k
// tiles (64 bytes of an x row, 128 bytes of a z row), none empty; else
// cudaErrorInvalidValue.
extern "C" int glu_ffn(const void* x, const void* wg, const void* w1,
                       const void* w2, void* z, void* y, int M, int D, int F,
                       int act, int up_splits, int up_k, int down_splits,
                       int down_k, int is_bf16, void* stream) {
  const int isz = is_bf16 ? 2 : 4;
  const bool ok = M > 0 && D > 0 && F > 0 &&
                  valid_split(D, up_splits, up_k, kUpKBytes / isz) &&
                  valid_split(F, down_splits, down_k, kDownKBytes / isz);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch_any<__nv_bfloat16>(x, wg, w1, w2, z, y, M, D, F, act,
                                          up_splits, up_k, down_splits,
                                          down_k, st)
              : launch_any<float>(x, wg, w1, w2, z, y, M, D, F, act,
                                  up_splits, up_k, down_splits, down_k, st);
  return static_cast<int>(e);
}
