// A stand-in for the CUDA runtime header, for running csrc/count_core.cuh,
// csrc/band_core.cuh, csrc/align_score.cu and csrc/overlap.cu on the CPU:
// the qualifiers vanish, a block's threads are host threads,
// __syncthreads() is a barrier of theirs, a warp's collectives (__syncwarp,
// __ballot_sync, __shfl_sync) a barrier of its 32, and shared memory is one
// array.  The byte-permute and funnel-shift intrinsics and __fmul_rn have
// CUDA's semantics.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <math.h>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(x)
#define __shared__
struct Index3 {
  unsigned x, y, z;
};
extern thread_local Index3 threadIdx, blockIdx;
extern std::barrier<>* block_barrier;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
// one barrier and one vote slot a lane for each warp of the block
extern std::barrier<>** warp_barriers;
extern unsigned (*warp_votes)[32];
inline void __syncwarp(unsigned = 0xffffffffu) {
  warp_barriers[threadIdx.y]->arrive_and_wait();
}
inline unsigned __ballot_sync(unsigned, bool p) {
  unsigned* v = warp_votes[threadIdx.y];
  v[threadIdx.x] = p;
  __syncwarp();
  unsigned m = 0;
  for (unsigned i = 0; i < 32; ++i) m |= v[i] << i;
  __syncwarp();  // every lane has read the votes before they change
  return m;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// one f32 product, rounded to nearest (x86-64 SSE arithmetic)
inline float __fmul_rn(float a, float b) { return a * b; }
// lane src's var, every lane of the warp taking part
inline int __shfl_sync(unsigned, int var, int src) {
  unsigned* v = warp_votes[threadIdx.y];
  v[threadIdx.x] = (unsigned)var;
  __syncwarp();
  const int r = (int)v[src & 31];
  __syncwarp();
  return r;
}
// the low 32 bits of (hi:lo) >> (shift & 31)
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  const unsigned long long v = ((unsigned long long)hi << 32) | lo;
  return (unsigned)(v >> (shift & 31));
}
// result byte n is byte (s >> 4n) & 7 of the eight bytes y:x
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = ((unsigned long long)y << 32) | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (unsigned)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xffu) << (8 * n);
  return r;
}
struct uint4 {
  unsigned x, y, z, w;
};
struct int4 {
  int x, y, z, w;
};
struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return float2{a, b}; }
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return float4{a, b, c, d};
}
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline int __float_as_int(float f) {
  int i;
  std::memcpy(&i, &f, 4);
  return i;
}
using std::max;
using std::min;
enum cudaError_t { cudaSuccess = 0 };
enum { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int*) { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* n, int, int) {
  *n = 132;
  return cudaSuccess;
}
