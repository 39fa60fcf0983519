// K1: the soft-count cascade — level weights, count product and diagonal fold
// in one pass (the exact double-range soft accumulate of every production
// fill, and the mini-cascade of the fast tiers).
//
// Replaces figbird_tpu/ops/band.py::_cascade_kernel (pallas_call at
// band.py:280), reached from fill/em.py::_accumulate_levels (em.py:666-671).
//
//   w_k[i, r, p]       = lk <= cut ? expf(clamp(lk, -745, cut)) : 0,
//                        lk = lw[i, r, p] + k * shift            (k < m)
//   counts[i, k, w, c] = sum_j sum_r w_k[i, r, w - j] * vals[i, r, j]
//                                    * (codes[i, r, j] == c)
//   over 0 <= w - j < Pw.  lw holds natural-log weights with illegal entries
//   at -1e30: the clamp sends them to expf(-745), exactly 0 in f32, at every
//   level.  vals is the count one-hot's non-zero value (1 for a counted base).
//
// The TPU kept the whole (5L, Pw) one-hot product of a level in VMEM and
// folded it with L row-block adds; an SM's shared memory cannot hold it, and
// a product against a one-hot is a gather.  Here the kernel is
// count_core.cuh's tile with m levels: a block owns one instance and a tile
// of output rows; for a chunk of reads it computes, once, all m level weights
// of the positions its rows read into shared memory (precise expf, so the f32
// denormals of the deep levels stay denormals) beside the chunk's (code,
// value) pairs, and runs the sliding-window gather-sum over them: a decoded
// base feeds rows-per-thread times m FMAs, sent to its channel by a
// warp-uniform switch.  A thread owns 2 rows at m > 3 (60 running sums) and 4
// rows at m <= 3, which is what 128 registers hold; a block has 16 warps and
// an SM to itself, as K4's has (against two blocks of 8 warps: 10% faster at
// 128 instances, 1% at the scan's 495, slower nowhere measured).
// Neither the level weights nor a one-hot ever reach device memory; the order
// of the sum is fixed, so two runs give the same bits.
//
// What bounds it on an H100: counted as the function needs them, the bytes
// (78 MB at the banded main-path shape: 495 instances, 128 reads, Pw = 128,
// L = 101, m = 6) outweigh the multiply-adds of the non-zero weights, so the
// card's least time is the memory's.  The kernel is bound by the rate of its
// instructions: it works through m L P Pw I = 4.9 G (row, base, read, level) terms
// whatever their value, and through the zero-weight terms at its tiles'
// slanted edges besides.

#include "count_core.cuh"

// The tile's shape at M levels: output rows per thread, warps per block (they
// split a chunk's reads), blocks per SM the registers and the stage are
// planned for.  A source that tries another shape defines this before it
// includes this file.
#ifndef CASCADE_TILE
#define CASCADE_TILE(M) ((M) <= 3 ? 4 : 2), 16, 1
#endif

namespace {

constexpr int MAXM = 6;  // deepest cascade

template <int RW_, int NW_, int BPS_>
struct Shape {
  static constexpr int RW = RW_, NW = NW_, BPS = BPS_;
};
template <int M>
using Tile = Shape<CASCADE_TILE(M)>;

struct Level {
  float shift, cut;
  __device__ __forceinline__ float operator()(float lw, int k) const {
    const float lk = lw + (float)k * shift;
    return lk <= cut ? expf(fminf(fmaxf(lk, -745.0f), cut)) : 0.0f;
  }
};

template <int M>
__global__ void __launch_bounds__(32 * Tile<M>::NW, Tile<M>::BPS)
    cascade_kernel(const float* __restrict__ lw,
                   const int8_t* __restrict__ codes,
                   const float* __restrict__ vals, float* __restrict__ out,
                   int P, int L, int Pw, int W, int n_tiles, int RC, int S,
                   int LR, Level f) {
  constexpr int RW = Tile<M>::RW;
  const size_t inst = blockIdx.x / n_tiles;
  const int w0 = (blockIdx.x % n_tiles) * (32 * RW);
  count_core::tile<M, RW, Tile<M>::NW>(
      lw + inst * P * Pw, codes + inst * P * L, vals + inst * P * L,
      out + inst * M * W * 5, P, L, Pw, W, w0, RC, S, LR, f);
}

template <int M>
int launch(const float* lw, const int8_t* codes, const float* vals,
           float* out, int I, int P, int L, int Pw, int W, float shift,
           float cut, cudaStream_t stream) {
  constexpr int RW = Tile<M>::RW, NW = Tile<M>::NW;
  const count_core::Plan p = count_core::plan<M, RW, NW, Tile<M>::BPS>(P, L);
  if (p.RC < 1) return (int)cudaErrorInvalidValue;  // read too long to stage
  const int n_tiles = (W + 32 * RW - 1) / (32 * RW);
  if ((long long)I * n_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  // above 48 KB the dynamic shared memory is an opt-in of the kernel
  cudaError_t err = cudaFuncSetAttribute(
      cascade_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err != cudaSuccess) return (int)err;
  cascade_kernel<M><<<I * n_tiles, dim3(32, NW), p.bytes, stream>>>(
      lw, codes, vals, out, P, L, Pw, W, n_tiles, p.RC, p.S, p.LR,
      Level{shift, cut});
  return (int)cudaGetLastError();
}

template <int M>
int stage_bytes(int P, int L) {
  return count_core::plan<M, Tile<M>::RW, Tile<M>::NW, Tile<M>::BPS>(P, L)
      .bytes;
}

}  // namespace

// The dynamic shared memory a block of the m-level kernel asks for at P reads
// of length L (for reports; 0 where m is out of range).
extern "C" int cascade_stage_bytes(int P, int L, int m) {
  switch (m) {
    case 1: return stage_bytes<1>(P, L);
    case 2: return stage_bytes<2>(P, L);
    case 3: return stage_bytes<3>(P, L);
    case 4: return stage_bytes<4>(P, L);
    case 5: return stage_bytes<5>(P, L);
    case 6: return stage_bytes<6>(P, L);
    default: return 0;
  }
}

// lw (I, P, Pw) f32 masked log-weights; codes (I, P, L) int8; vals (I, P, L)
// f32; out (I, m, W, 5) f32 with Pw + L - 1 <= W <= Pw + L; 1 <= m <= 6.
extern "C" int cascade_launch(const void* lw, const void* codes,
                              const void* vals, void* out, int I, int P,
                              int L, int Pw, int W, int m, float shift,
                              float cut, void* stream) {
  if (I == 0 || W == 0) return 0;
  if (m < 1 || m > MAXM || P < 1 || L < 1 || Pw < 1)
    return (int)cudaErrorInvalidValue;
  const float* a = (const float*)lw;
  const int8_t* b = (const int8_t*)codes;
  const float* c = (const float*)vals;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
    case 1: return launch<1>(a, b, c, o, I, P, L, Pw, W, shift, cut, s);
    case 2: return launch<2>(a, b, c, o, I, P, L, Pw, W, shift, cut, s);
    case 3: return launch<3>(a, b, c, o, I, P, L, Pw, W, shift, cut, s);
    case 4: return launch<4>(a, b, c, o, I, P, L, Pw, W, shift, cut, s);
    case 5: return launch<5>(a, b, c, o, I, P, L, Pw, W, shift, cut, s);
    default: return launch<6>(a, b, c, o, I, P, L, Pw, W, shift, cut, s);
  }
}
