// K2: fused soft-pass band score of the partial GapFiller EM.
//
// Replaces figbird_tpu/ops/band.py::_band_soft_kernel (pallas_call at
// band.py:191), reached from fill/em.py:590-598 (both bands of every soft
// EM pass).
//
//   score[i, r, p] = sum_{j ascending, valid[i, r, j]}
//                    log(max(A[i, p+j, c](1 - e_j) + e_j B[i, p+j, c], 1e-30))
//   with c = codes[i, r, j] (read r's base j).
//
// The TPU built a banded K tile in VMEM and contracted it with a one-hot of
// the reads on the MXU.  Each output cell is a selection (at most one
// non-zero per j), so here it is a gather-sum over band_core.cuh: a block
// stages the log factors of its positions once in shared memory, with
// precise logf (L * 5 * TP of them, amortised over all P reads), and scores
// every read against them.  No one-hot and no K ever reach device memory.
// What bounds it on an H100: the core's shared-memory loads (see there).

#include "band_core.cuh"
#include <math.h>

// The tile's shape: positions per lane, reads per warp at a time, warps per
// block, blocks per SM the shared memory is planned for.  A source that
// tries another shape defines this before it includes this file.  Two
// positions a lane, one read a warp at a time, 32 warps and an SM to
// itself: measured against 1 and 4 positions, 2 to 8 reads, 8 to 24 warps
// and 2 or 3 blocks an SM, the fastest or within 8% of it, for K2 and both
// forms of K3, at every instance batch the main path sends (64 to 495) and
// at the unmapped mode's full width.
#ifndef BAND_SOFT_TILE
#define BAND_SOFT_TILE 2, 1, 32, 1
#endif

// Instance i's log factor of base c at read position j on window row w.
struct SoftTile {
  const float* A;  // (R, 5)
  const float* B;  // (R, 5)
  const float* e;  // (L,)
  __device__ __forceinline__ float operator()(int w, int j, int c) const {
    const float ej = e[j], a = A[w * 5 + c], b = B[w * 5 + c];
    return logf(fmaxf(a * (1.0f - ej) + ej * b, 1e-30f));
  }
};

struct SoftMake {
  const float *A, *B, *e;
  int R;
  __device__ __forceinline__ SoftTile operator()(size_t i) const {
    return SoftTile{A + i * R * 5, B + i * R * 5, e};
  }
};

#ifdef __CUDACC__
namespace {
template <int NQ, int NR, int NW, int BPS>
int stage_bytes(int L) {
  return band_core::plan<NQ, NR, NW, BPS>(L).bytes;
}
template <int NQ, int NR, int NW, int BPS>
int launch(const SoftMake& m, const void* codes, const void* valid, void* out,
           int I, int P, int L, int Wp, void* stream) {
  return band_core::launch<NQ, NR, NW, BPS>(m, codes, valid, out, I, P, L,
                                            Wp, stream);
}
}  // namespace

// The dynamic shared memory a block asks for at read length L (for reports).
extern "C" int band_soft_stage_bytes(int L) {
  return stage_bytes<BAND_SOFT_TILE>(L);
}

// codes (I, P, L) int8; valid (I, P, L) bool; A, B (I, R, 5) f32 with
// R >= Wp + L - 1; e (L,) f32; out (I, P, Wp) f32.
extern "C" int band_soft_launch(const void* codes, const void* valid,
                                const void* A, const void* B, const void* e,
                                void* out, int I, int P, int L, int R, int Wp,
                                void* stream) {
  const SoftMake m{(const float*)A, (const float*)B, (const float*)e, R};
  return launch<BAND_SOFT_TILE>(m, codes, valid, out, I, P, L, Wp, stream);
}
#endif
