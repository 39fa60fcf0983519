// K4: raw-weight count accumulation with the diagonal fold — soft counts of
// the partial EM (m == 1 path) and the finalize counts and quality sums.
//
// Replaces figbird_tpu/ops/band.py::_fold_kernel (pallas_call at band.py:346),
// reached from fill/em.py:521-531 (soft counts em.py:551-556, finalize counts
// and quality em.py:1639-1648).
//
//   counts[i, w, c] = sum_j sum_r weights[i, r, w - j] * vals[i, r, j]
//                                 * (codes[i, r, j] == c)
//   over 0 <= w - j < Pw.  vals is the count one-hot's non-zero value: 1 for
//   a valid base (0 outside the read), or the base's quality-error weight.
//
// The TPU formed the (5L, Pw) product oh_j^T . weights on the MXU in VMEM and
// folded it with L row-block adds.  Here the kernel is count_core.cuh's tile
// with one level and the identity for a weight: a block owns one instance and
// a tile of output rows, stages a chunk's weights and (code, value) pairs in
// shared memory and runs the sliding-window gather-sum over them.  No one-hot
// is ever materialised; the order of the sum is fixed, so two runs give the
// same bits.
//
// A thread owns 8 rows, so one 256-row tile covers the banded W = 229, and a
// block has 16 warps and an SM to itself: measured against 4 and 2 rows a
// thread and against two blocks of 8 warps, this shape was the fastest or
// within 8% of it at every instance batch the main path sends (64 to 495).
//
// What bounds it on an H100: counted as the function needs them, the bytes
// (66.7 MB at the main path's shape: 495 instances, 128 reads, Pw = 128,
// L = 101) outweigh the multiply-adds of the non-zero weights, so the card's
// least time is the memory's.  The kernel is bound by the rate of its
// instructions: it works through every (row, base, read) term of its tiles
// whatever its value.

#include "count_core.cuh"

// The tile's shape: output rows per thread, warps per block (they split a
// chunk's reads), blocks per SM the shared memory is planned for.  A source
// that tries another shape defines this before it includes this file.
#ifndef FOLD_TILE
#define FOLD_TILE 8, 16, 1
#endif

namespace {

struct Raw {
  __device__ __forceinline__ float operator()(float x, int) const { return x; }
};

template <int RW, int NW, int BPS>
__global__ void __launch_bounds__(32 * NW, BPS)
    fold_kernel(const float* __restrict__ weights,
                const int8_t* __restrict__ codes,
                const float* __restrict__ vals, float* __restrict__ out, int P,
                int L, int Pw, int W, int n_tiles, int RC, int S, int LR) {
  const size_t inst = blockIdx.x / n_tiles;
  const int w0 = (blockIdx.x % n_tiles) * (32 * RW);
  count_core::tile<1, RW, NW>(
      weights + inst * P * Pw, codes + inst * P * L, vals + inst * P * L,
      out + inst * W * 5, P, L, Pw, W, w0, RC, S, LR, Raw());
}

template <int RW, int NW, int BPS>
int launch(const float* weights, const int8_t* codes, const float* vals,
           float* out, int I, int P, int L, int Pw, int W,
           cudaStream_t stream) {
  const count_core::Plan p = count_core::plan<1, RW, NW, BPS>(P, L);
  if (p.RC < 1) return (int)cudaErrorInvalidValue;  // read too long to stage
  const int n_tiles = (W + 32 * RW - 1) / (32 * RW);
  if ((long long)I * n_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  // above 48 KB the dynamic shared memory is an opt-in of the kernel
  cudaError_t err = cudaFuncSetAttribute(
      fold_kernel<RW, NW, BPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.bytes);
  if (err != cudaSuccess) return (int)err;
  fold_kernel<RW, NW, BPS><<<I * n_tiles, dim3(32, NW), p.bytes, stream>>>(
      weights, codes, vals, out, P, L, Pw, W, n_tiles, p.RC, p.S, p.LR);
  return (int)cudaGetLastError();
}

template <int RW, int NW, int BPS>
int stage_bytes(int P, int L) {
  return count_core::plan<1, RW, NW, BPS>(P, L).bytes;
}

}  // namespace

// The dynamic shared memory a block asks for at P reads of length L (for
// reports).
extern "C" int fold_stage_bytes(int P, int L) {
  return stage_bytes<FOLD_TILE>(P, L);
}

// weights (I, P, Pw) f32; codes (I, P, L) int8; vals (I, P, L) f32;
// out (I, W, 5) f32 with W >= Pw + L - 1.
extern "C" int fold_launch(const void* weights, const void* codes,
                           const void* vals, void* out, int I, int P, int L,
                           int Pw, int W, void* stream) {
  if (I == 0 || W == 0) return 0;
  if (P < 1 || L < 1 || Pw < 1) return (int)cudaErrorInvalidValue;
  const float* a = (const float*)weights;
  const int8_t* b = (const int8_t*)codes;
  const float* c = (const float*)vals;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  return launch<FOLD_TILE>(a, b, c, o, I, P, L, Pw, W, s);
}
