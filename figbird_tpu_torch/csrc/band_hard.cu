// K3: banded score of the hard (consensus) pass and the finalize placement
// of the partial GapFiller EM, in two forms over band_core.cuh.
//
// Replaces figbird_tpu/ops/band.py::_band_kernel (pallas_call at band.py:110),
// reached from fill/em.py:462-464 and :601-605 (hard pass em.py:1175-1178,
// finalize em.py:1624-1627).  Its output feeds a first-max position argmax.
//
//   score[i, r, p] = sum_{j ascending, valid[i, r, j]} K[i, p+j, 5j + c],
//   c = codes[i, r, j],  K flat j-major (I, R, 5L) as fill/em.py _hard_K
//   builds it from the gap string g:
//     K[w, 5j + c] = 0                      where g[w] >= 5,
//                    a_j                    where c == g[w],
//                    b_j + lnET[g[w], c]    else (one f32 add).
//
// band_hard_launch takes K from device memory (the counterpart of
// _band_kernel).  band_hard_gap_launch, the one the EM's main path calls,
// builds the same entries from the gap string while it stages the tile, so
// K never reaches device memory; the entries, and so the scores, are bit
// for bit those of the K form on _hard_K's output.
//
// The TPU assembled the banded tile Kw[t, 5j+c] = K[p0+t+j, 5j+c] in VMEM and
// ran a one-hot matmul on the MXU.  Each output cell selects one entry per j,
// so here it is the core's gather-sum: no one-hot, no Kw in device memory.
// What bounds it on an H100: the core's shared-memory loads (see there); the
// K form also reads K, each element once a block.

#include "band_core.cuh"

// The tile's shape (see band_soft.cu); a trial source defines it before it
// includes this file.
#ifndef BAND_HARD_TILE
#define BAND_HARD_TILE 2, 1, 32, 1
#endif

// Instance i's entries from K (R, 5L).
struct KTile {
  const float* K;
  int LC;  // 5L
  __device__ __forceinline__ float operator()(int w, int j, int c) const {
    return K[(size_t)w * LC + j * 5 + c];
  }
};

struct KMake {
  const float* K;
  int R, LC;
  __device__ __forceinline__ KTile operator()(size_t i) const {
    return KTile{K + i * R * LC, LC};
  }
};

// Instance i's entries from its gap string (R,) int8, codes 0..5.
struct GapTile {
  const int8_t* g;
  const float* a;   // (L,) match log factors
  const float* b;   // (L,) mismatch log factors
  const float* ln;  // (5, 5) lnET
  __device__ __forceinline__ float operator()(int w, int j, int c) const {
    const int gw = g[w];
    if (gw >= 5) return 0.0f;
    return c == gw ? a[j] : b[j] + ln[gw * 5 + c];
  }
};

struct GapMake {
  const int8_t* g;
  const float *a, *b, *ln;
  int R;
  __device__ __forceinline__ GapTile operator()(size_t i) const {
    return GapTile{g + i * R, a, b, ln};
  }
};

#ifdef __CUDACC__
namespace {
template <int NQ, int NR, int NW, int BPS>
int stage_bytes(int L) {
  return band_core::plan<NQ, NR, NW, BPS>(L).bytes;
}
template <int NQ, int NR, int NW, int BPS, class Make>
int launch(const Make& m, const void* codes, const void* valid, void* out,
           int I, int P, int L, int Wp, void* stream) {
  return band_core::launch<NQ, NR, NW, BPS>(m, codes, valid, out, I, P, L,
                                            Wp, stream);
}
}  // namespace

// The dynamic shared memory a block asks for at read length L (for reports).
extern "C" int band_hard_stage_bytes(int L) {
  return stage_bytes<BAND_HARD_TILE>(L);
}

// codes (I, P, L) int8; valid (I, P, L) bool; K (I, R, 5L) f32 with
// R >= Wp + L - 1; out (I, P, Wp) f32.
extern "C" int band_hard_launch(const void* codes, const void* valid,
                                const void* K, void* out, int I, int P, int L,
                                int R, int Wp, void* stream) {
  const KMake m{(const float*)K, R, 5 * L};
  return launch<BAND_HARD_TILE>(m, codes, valid, out, I, P, L, Wp, stream);
}

// codes, valid as above; gap_string (I, R) int8 with R >= Wp + L - 1;
// a, b (L,) f32; ln_et (5, 5) f32; out (I, P, Wp) f32.
extern "C" int band_hard_gap_launch(const void* codes, const void* valid,
                                    const void* gap_string, const void* a,
                                    const void* b, const void* ln_et,
                                    void* out, int I, int P, int L, int R,
                                    int Wp, void* stream) {
  const GapMake m{(const int8_t*)gap_string, (const float*)a, (const float*)b,
                  (const float*)ln_et, R};
  return launch<BAND_HARD_TILE>(m, codes, valid, out, I, P, L, Wp, stream);
}
#endif
