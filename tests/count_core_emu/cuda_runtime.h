// A stand-in for the CUDA runtime header, for running csrc/count_core.cuh on
// the CPU: the qualifiers vanish, a block's threads are host threads,
// __syncthreads() is a barrier of theirs, and shared memory is one array.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
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
struct float2 {
  float x, y;
};
inline float2 make_float2(float a, float b) { return float2{a, b}; }
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
