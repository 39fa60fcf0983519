// The banded-score core of K2 (band_soft.cu) and K3 (band_hard.cu): one
// instance's
//
//   score[r, p] = sum_{j ascending, valid[r, j], 0 <= codes[r, j] < 5}
//                 f(p + j, j, codes[r, j]),        0 <= p < Wp,
//
// in f32 on the CUDA cores.  f gives the log factor of base c at read
// position j placed on window row w: K2 builds it from the probability
// slabs with precise logf, K3 loads it from K or builds it from the gap
// string.
//
// A block owns one instance and a tile of TP = 32 * NQ consecutive
// positions p0 .. p0 + TP - 1; lane t of every warp owns the NQ consecutive
// positions p0 + NQ t + q, which it reads from a tile row with one 4 * NQ
// byte access.  For a pass over the read positions j0 .. j0 + LJ - 1 the
// block stages the tile kw[(j - j0) * 5 + c][i] = f(p0 + i + j, j, c),
// i < TP, in shared memory once (f is called here and nowhere else), with
// one more row of zeros, and then every warp scores its reads against it.
//
// A warp takes NR reads at a time.  Their codes over the pass, with the
// valid mask folded in, come from device memory into registers while the
// warp scores the reads before them, so the scoring never waits on device
// memory.  A ballot then compacts each read's scored bases, in ascending j,
// into a list of tile offsets in the warp's own shared memory, padded with
// the zero row's offset to the longest of the NR lists (a multiple of 4).
// The scoring loop reads four offsets of a read with one broadcast load and
// then, for each, one access of NQ floats a lane, 32 lanes reading 32 NQ
// consecutive floats (no bank conflicts), into NR x NQ independent sums.
// Nothing inside it comes from device memory, and a base that is not
// scored (masked, or a pad code) or a padding read costs no step.
//
// What bounds it on an H100: the scoring loop, by the shared-memory loads
// of the tile (one 4-byte word a scored (read, j, position) cell at 128
// bytes a clock an SM); beside it the staging of the tile and each read's
// list, which a block with its SM to itself cannot overlap with scoring.
//
// Order of the sum: every cell adds its entries over j in ascending order
// into one f32 sum that starts at +0.0 (the zero row's +0.0 leaves it bit
// for bit as it is), and a pass after the first resumes from the sum the
// pass before wrote.  No atomics, no fast-math: two launches give the same
// bits, and equal placements score equal.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace band_core {

constexpr int JW = 4;  // a pass holds at most 32 * JW read positions
constexpr int SM_BYTES = 228 * 1024; // an SM's shared memory; a block of it
                                     // takes 1 KB beside what it asks for

// Shared-memory plan of a launch: read positions a pass holds (LJ), the
// stride of a read's offset list (LP) and the bytes a block asks for.  LJ is
// 0 where not even one read position fits.
struct Plan {
  int LJ, LP, bytes;
};

inline int plan_bytes(int TP, int NWR, int LJ) {
  return 4 * (TP * (5 * LJ + 1) + NWR * ((LJ + 3) / 4 * 4));
}

template <int NQ, int NR, int NW, int BPS>
inline Plan plan(int L) {
  constexpr int TP = 32 * NQ;
  const int budget = SM_BYTES / BPS - 1024;
  Plan p{L < 32 * JW ? L : 32 * JW, 0, 0};
  while (p.LJ > 0 && plan_bytes(TP, NW * NR, p.LJ) > budget) --p.LJ;
  p.LP = (p.LJ + 3) / 4 * 4;
  p.bytes = plan_bytes(TP, NW * NR, p.LJ);
  return p;
}

// a lane's NQ consecutive floats of a tile row as one shared-memory access
// (NQ 1, 2 or 4): acc += row, and row = v
__device__ __forceinline__ void add_row(float (&acc)[1], const float* row) {
  acc[0] += row[0];
}
__device__ __forceinline__ void add_row(float (&acc)[2], const float* row) {
  const float2 v = *reinterpret_cast<const float2*>(row);
  acc[0] += v.x;
  acc[1] += v.y;
}
__device__ __forceinline__ void add_row(float (&acc)[4], const float* row) {
  const float4 v = *reinterpret_cast<const float4*>(row);
  acc[0] += v.x;
  acc[1] += v.y;
  acc[2] += v.z;
  acc[3] += v.w;
}
__device__ __forceinline__ void put_row(float* row, const float (&v)[1]) {
  row[0] = v[0];
}
__device__ __forceinline__ void put_row(float* row, const float (&v)[2]) {
  *reinterpret_cast<float2*>(row) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void put_row(float* row, const float (&v)[4]) {
  *reinterpret_cast<float4*>(row) = make_float4(v[0], v[1], v[2], v[3]);
}

// offset u (0..3) of four, u a constant once the caller is unrolled
__device__ __forceinline__ int pick(const int4& o, int u) {
  return u == 0 ? o.x : u == 1 ? o.y : u == 2 ? o.z : o.w;
}

// Codes of the NR reads of group g over the pass j0 .. j0 + nj - 1, lane t
// holding j0 + 32 u + t; a base that is not scored (masked, a code outside
// 0..4, past the pass or the read count) is 5.
template <int NR>
__device__ __forceinline__ void fetch(int (&x)[NR][JW],
                                      const int8_t* __restrict__ codes,
                                      const uint8_t* __restrict__ valid,
                                      int P, int L, int g, int j0, int nj,
                                      int t) {
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    const int r = g * NR + k;
#pragma unroll
    for (int u = 0; u < JW; ++u) {
      const int j = 32 * u + t;
      int e = 5;
      if (r < P && j < nj) {
        const size_t i = (size_t)r * L + j0 + j;
        const int c = codes[i];
        if (valid[i] && (unsigned)c < 5u) e = c;
      }
      x[k][u] = e;
    }
  }
}

// One tile of one instance.  codes, valid (P, L) and out (P, Wp) are the
// instance's; p0 is the tile's first position.  Called by every thread of
// a (32, NW) block with dynamic shared memory of plan<NQ, NR, NW, .>(L).
template <int NQ, int NR, int NW, class F>
__device__ __forceinline__ void scores(const int8_t* __restrict__ codes,
                                       const uint8_t* __restrict__ valid,
                                       float* __restrict__ out, int P, int L,
                                       int Wp, int p0, int LJ, int LP, F f) {
  constexpr int TP = 32 * NQ;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int warp = threadIdx.y;
  const int n_groups = (P + NR - 1) / NR;

  for (int j0 = 0; j0 < L; j0 += LJ) {
    const int nj = min(LJ, L - j0);
    float* kw = smem;                                   // [5 nj + 1][TP]
    int* lst = (int*)(kw + (5 * nj + 1) * TP) + warp * NR * LP;  // [NR][LP]
    const int zero_row = 5 * nj * TP;

    int x[NR][JW];
    fetch<NR>(x, codes, valid, P, L, warp, j0, nj, t);
    if (j0 > 0) __syncthreads();  // the pass before is done with its tile
#pragma unroll 2
    for (int row = warp; row < 5 * nj; row += NW) {
      const int j = j0 + row / 5, c = row % 5;
      float v[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int p = p0 + NQ * t + q;
        v[q] = p < Wp ? f(p + j, j, c) : 0.0f;
      }
      put_row(kw + row * TP + NQ * t, v);
    }
    for (int i = warp * 32 + t; i < TP; i += 32 * NW) kw[zero_row + i] = 0.0f;
    __syncthreads();

    for (int g = warp; g < n_groups; g += NW) {
      // the group's lists of tile offsets, ascending j
      int steps = 0, cnt[NR];
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        int n = 0;
#pragma unroll
        for (int u = 0; u < JW; ++u) {
          if (32 * u >= nj) break;  // warp-uniform
          const int c = x[k][u];
          const unsigned m = __ballot_sync(0xffffffffu, c < 5);
          if (c < 5)
            lst[k * LP + n + __popc(m & ((1u << t) - 1u))] =
                ((32 * u + t) * 5 + c) * TP;
          n += __popc(m);
        }
        cnt[k] = n;
        steps = max(steps, n);
      }
      steps = (steps + 3) & ~3;
#pragma unroll
      for (int k = 0; k < NR; ++k)
        for (int s = cnt[k] + t; s < steps; s += 32)
          lst[k * LP + s] = zero_row;
      __syncwarp();
      // the next group's codes are on their way while this one is scored
      fetch<NR>(x, codes, valid, P, L, g + NW, j0, nj, t);

      float acc[NR][NQ];
#pragma unroll
      for (int k = 0; k < NR; ++k)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int r = g * NR + k, p = p0 + NQ * t + q;
          acc[k][q] = j0 > 0 && r < P && p < Wp ? out[(size_t)r * Wp + p]
                                                : 0.0f;
        }
      const float* base = kw + NQ * t;
#pragma unroll 1
      for (int s = 0; s < steps; s += 4) {
        int4 o[NR];
#pragma unroll
        for (int k = 0; k < NR; ++k)
          o[k] = *reinterpret_cast<const int4*>(lst + k * LP + s);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int k = 0; k < NR; ++k) add_row(acc[k], base + pick(o[k], u));
      }
      __syncwarp();  // the lists are read before the next group writes them

#pragma unroll
      for (int k = 0; k < NR; ++k)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int r = g * NR + k, p = p0 + NQ * t + q;
          if (r < P && p < Wp) out[(size_t)r * Wp + p] = acc[k][q];
        }
    }
  }
}

#ifdef __CUDACC__
// One block per (instance, position tile), instances on blockIdx.x.
// make(i) gives instance i's tile functor.
template <int NQ, int NR, int NW, int BPS, class Make>
__global__ void __launch_bounds__(32 * NW, BPS)
    kernel(Make make, const int8_t* __restrict__ codes,
           const uint8_t* __restrict__ valid, float* __restrict__ out, int P,
           int L, int Wp, int n_tiles, int LJ, int LP) {
  const size_t inst = blockIdx.x / n_tiles;
  const int p0 = (blockIdx.x % n_tiles) * (32 * NQ);
  scores<NQ, NR, NW>(codes + inst * P * L, valid + inst * P * L,
                     out + inst * P * Wp, P, L, Wp, p0, LJ, LP, make(inst));
}

// codes (I, P, L) int8; valid (I, P, L) bool; out (I, P, Wp) f32.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a launch it cannot plan.
template <int NQ, int NR, int NW, int BPS, class Make>
int launch(Make make, const void* codes, const void* valid, void* out, int I,
           int P, int L, int Wp, void* stream) {
  if (I == 0 || P == 0 || Wp == 0) return 0;
  const Plan p = plan<NQ, NR, NW, BPS>(L);
  if (p.LJ < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (Wp + 32 * NQ - 1) / (32 * NQ);
  if ((long long)I * n_tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  // above 48 KB the dynamic shared memory is an opt-in of the kernel
  cudaError_t err = cudaFuncSetAttribute(
      kernel<NQ, NR, NW, BPS, Make>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<NQ, NR, NW, BPS, Make>
      <<<I * n_tiles, dim3(32, NW), p.bytes, (cudaStream_t)stream>>>(
          make, (const int8_t*)codes, (const uint8_t*)valid, (float*)out, P,
          L, Wp, n_tiles, p.LJ, p.LP);
  return (int)cudaGetLastError();
}
#endif

}  // namespace band_core
