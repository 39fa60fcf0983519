// The count-and-fold core of K4 (fold.cu) and K1 (cascade.cu): one instance's
//
//   counts[k, w, c] = sum_r sum_j f(x[r, w - j], k) * vals[r, j]
//                                 * (codes[r, j] == c),   0 <= w - j < Pw,
//
// for k < M levels, in f32 on the CUDA cores.  f turns a loaded entry of the
// (P, Pw) array x into level k's weight: the identity for K4 (M = 1), the
// cascade's level weight exp(lw + k * shift) for K1.
//
// A block owns one instance and a tile of TW = 32 * RW consecutive output
// rows.  Lane t of every warp owns the RW rows w0 + RW * t + q; the NW warps
// share the tile's rows and split the reads.  The reads are walked in chunks
// of RC; for a chunk the block stages in shared memory, once,
//
//   * the M level weights of every position the tile's rows read (f is
//     applied here, so expf stays out of the inner loop and a weight never
//     reaches device memory; positions outside 0..Pw-1 are staged as 0, so
//     the inner loop has no bounds test), and
//   * the chunk's (code, value) pairs over the read positions j the tile can
//     reach, 8 bytes a pair, in the order the inner loop walks them.
//
// The raw inputs of a chunk (x, values, codes) come from device memory by
// cp.async into a buffer of their own while the chunk before is worked
// through, so no warp waits on device memory between chunks.
//
// The inner loop of a warp then reads nothing but shared memory.  A step is
// one (read, j): one broadcast load of the (code, value) pair, decoded once
// for the thread's RW rows and M levels, and per level ONE new weight — the
// rows are consecutive, so the RW weights of step j - 1 are those of step j
// moved up by one row (a sliding window held in registers; the loop is
// unrolled RW steps so that the window's slots are fixed registers).  Staged
// position n lies at (n % RW) * S + n / RW, so lane t's load of position
// RW * t + const falls on consecutive banks.  The value goes to the base's
// channel by a warp-uniform switch on the code (every lane of a warp is at
// the same base): 1 FMA per row and level.
//
// The warp executes j for all 32 * RW rows at once, so the (row, j) pairs
// outside the band 0 <= w - j < Pw at a tile's slanted edges are worked
// through with 0 weights: Pw / (Pw + 32 * RW) of the steps are useful.
//
// Order of the sum: a thread sums its reads of one chunk over the tile's j
// (a few hundred terms at most), the NW warps' sums are added in warp order,
// and the chunks' sums are added in chunk order.  Fixed, hierarchical, no
// atomics: two launches give the same bits, and no long running f32 sum
// drifts.  No fast-math and no flush-to-zero: denormal weights stay denormal.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace count_core {

constexpr int MAXRC = 32;            // reads per staged chunk, at most
constexpr int SM_BYTES = 228 * 1024; // an SM's shared memory; a block of it
                                     // takes 1 KB beside what it asks for

// Shared-memory plan of a launch: the read-length padding LR, the stage's
// row stride S, the reads per chunk RC and the bytes a block needs.  RC is 0
// where not even one read fits (a read too long to stage).
struct Plan {
  int LR, S, RC, bytes;
};

template <int M, int RW, int NW, int BPS>
inline Plan plan(int P, int L) {
  constexpr int TW = 32 * RW;
  Plan p;
  p.LR = (L + RW - 1) / RW * RW;
  p.S = 32 + p.LR / RW;
  // accumulator and the warps' partial sums; slack of the raw codes
  const long long fixed = 4LL * 5 * TW * (M + NW) + 8;
  // per read: (code, value) pairs and level weights as the inner loop reads
  // them, and the next chunk's raw weights, values and codes
  const long long per_read = 8LL * p.LR + 4LL * M * RW * p.S +
                             4LL * (TW + p.LR) + 4LL * L + L;
  long long rc = (SM_BYTES / BPS - 1024 - fixed - 4) / per_read;
  if (rc > MAXRC) rc = MAXRC;
  if (rc > (P + NW - 1) / NW * NW) rc = (P + NW - 1) / NW * NW;
  if (rc >= NW) rc -= rc % NW;  // every warp the same number of reads
  p.RC = rc < 1 ? 0 : (int)rc;
  p.bytes = (int)((fixed + p.RC * per_read + 3) / 4 * 4);
  return p;
}

// Asynchronous 4-byte copies from device memory to shared memory (cp.async):
// started, committed as one group, and waited for before the group's data is
// read.  A harness that runs the core without a card supplies its own.
#ifndef COUNT_CORE_COPIES
__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const size_t g = __cvta_generic_to_global(src);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(g));
}
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
#endif

// s[k][CH][q] += xw[k][(q + u) % RW] * v for every level and row: one
// channel's FMAs of a step (u is a constant once the caller is unrolled).
template <int M, int RW, int CH>
__device__ __forceinline__ void add_channel(float (&s)[M][5][RW],
                                            const float (&xw)[M][RW], float v,
                                            int u) {
#pragma unroll
  for (int k = 0; k < M; ++k)
#pragma unroll
    for (int q = 0; q < RW; ++q)
      s[k][CH][q] = fmaf(xw[k][(q + u) % RW], v, s[k][CH][q]);
}

// One tile of one instance.  x (P, Pw), codes (P, L), vals (P, L) and
// out (M, W, 5) are the instance's; w0 is the tile's first row.  Called by
// every thread of a (32, NW) block with dynamic shared memory of
// plan<M, RW, NW, .>(P, L).bytes.
template <int M, int RW, int NW, class F>
__device__ __forceinline__ void tile(const float* __restrict__ x,
                                     const int8_t* __restrict__ codes,
                                     const float* __restrict__ vals,
                                     float* __restrict__ out, int P, int L,
                                     int Pw, int W, int w0, int RC, int S,
                                     int LR, F f) {
  constexpr int TW = 32 * RW;
  constexpr int NT = 32 * NW;
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;                            // [M][TW][5]
  float* part = acc + M * TW * 5;               // [NW][5][RW][32]
  float2* cv = (float2*)(part + NW * 5 * TW);   // [RC][LR] (code, value)
  float* wst = (float*)(cv + RC * LR);          // [RC][M][RW][S]
  const int NX = TW + LR;
  float* rawx = wst + RC * M * RW * S;          // [RC][NX] the next chunk's x
  float* rawv = rawx + RC * NX;                 // [RC][L] ... values
  int8_t* rawc = (int8_t*)(rawv + RC * L);      // [RC][L] ... codes (+ slack)

  const int t = threadIdx.x;
  const int kw = threadIdx.y;
  const int tid = kw * 32 + t;

  // the read positions the tile's rows can reach, walked downwards from jhi
  // in ND steps (a multiple of RW; the steps past jlo are staged as value 0)
  const int jlo = max(0, w0 - Pw + 1), jhi = min(L - 1, w0 + TW - 1);
  const int nd = max(0, jhi - jlo + 1);
  const int ND = (nd + RW - 1) / RW * RW;
  const int NS = TW + ND - 1;  // staged positions: pb .. pb + NS - 1
  const int pb = w0 - jhi;

  for (int idx = tid; idx < M * TW * 5; idx += NT) acc[idx] = 0.0f;

  // The next chunk's inputs are copied into the raw buffers while this
  // chunk is worked through: the x entries the tile's rows read (in-range
  // positions only), and the chunk's rows of values and codes whole.
  const int n_lo = max(0, -pb), n_hi = min(NS, Pw - pb);
  auto prefetch = [&](int r0) {
    const int rc = min(RC, P - r0);
    for (int rr = kw; rr < rc; rr += NW) {
      const float* xg = x + (r0 + rr) * Pw + pb;
      float* xd = rawx + rr * NX;
      for (int n = n_lo + t; n < n_hi; n += 32) copy4_async(xd + n, xg + n);
    }
    const float* vg = vals + r0 * L;
    for (int i = tid; i < rc * L; i += NT) copy4_async(rawv + i, vg + i);
    // byte b of the chunk's codes goes to rawc[mis + b], so that the whole
    // 4-byte words among them are aligned on both sides; the bytes before
    // the first and after the last whole word (3 each at most) are plain
    // loads, so nothing outside the chunk's rows is read
    const int8_t* cg = codes + r0 * L;
    const int nb = rc * L;
    const int mis = (int)((size_t)cg & 3);
    const int head = min((4 - mis) & 3, nb);
    const int whole = (nb - head) / 4, tail = nb - head - 4 * whole;
    for (int i = tid; i < whole; i += NT)
      copy4_async(rawc + mis + head + 4 * i, cg + head + 4 * i);
    if (tid < head + tail) {
      const int b = tid < head ? tid : nb - tail + (tid - head);
      rawc[mis + b] = cg[b];
    }
    copies_commit();
  };

  prefetch(0);
  for (int r0 = 0; r0 < P; r0 += RC) {
    const int rc = min(RC, P - r0);
    copies_wait();
    __syncthreads();  // the chunk's raw inputs have landed; the previous
                      // chunk's readers are done
    // raw -> the forms the inner loop reads; a warp takes whole reads
    const int mis = (int)((size_t)(codes + r0 * L) & 3);
    for (int rr = kw; rr < rc; rr += NW) {
      const int8_t* cs = rawc + mis + rr * L + jhi;
      const float* vs = rawv + rr * L + jhi;
      float2* cd = cv + rr * LR;
      for (int d = t; d < ND; d += 32) {
        float2 e = make_float2(0.0f, 0.0f);
        if (d < nd) {  // j = jhi - d >= jlo
          e.y = vs[-d];
          // a base of value 0 counts nowhere: it takes the pad code, which
          // the switch passes over
          e.x = __int_as_float(e.y != 0.0f ? (int)cs[-d] : 5);
        }
        cd[d] = e;
      }
      const float* xs = rawx + rr * NX;
      float* wd = wst + rr * M * RW * S;
#pragma unroll 2
      for (int n = t; n < NS; n += 32) {
        const bool in = n >= n_lo && n < n_hi;
        float* dst = wd + (n % RW) * S + n / RW;
        if (in) {
          const float xv = xs[n];
#pragma unroll
          for (int k = 0; k < M; ++k) dst[k * RW * S] = f(xv, k);
        } else {
#pragma unroll
          for (int k = 0; k < M; ++k) dst[k * RW * S] = 0.0f;
        }
      }
    }
    __syncthreads();
    if (r0 + RC < P) prefetch(r0 + RC);

    // this thread's sums over its reads of the chunk: s[level][channel][row]
    float s[M][5][RW];
#pragma unroll
    for (int k = 0; k < M; ++k)
#pragma unroll
      for (int c = 0; c < 5; ++c)
#pragma unroll
        for (int q = 0; q < RW; ++q) s[k][c][q] = 0.0f;

    for (int rr = kw; rr < rc; rr += NW) {
      const float* wp = wst + rr * M * RW * S + t;
      const float2* cp = cv + rr * LR;
      // window slot i holds the staged position of residue i (mod RW)
      float xw[M][RW];
#pragma unroll
      for (int k = 0; k < M; ++k)
#pragma unroll
        for (int q = 0; q + 1 < RW; ++q) xw[k][q] = wp[(k * RW + q) * S];
#pragma unroll 1
      for (int d0 = 0; d0 < ND; d0 += RW, ++wp, cp += RW) {
#pragma unroll
        for (int u = 0; u < RW; ++u) {
          // the one new position of this step: row RW - 1's
          const int slot = (u + RW - 1) % RW, ahead = (u + RW - 1) / RW;
#pragma unroll
          for (int k = 0; k < M; ++k)
            xw[k][slot] = wp[(k * RW + slot) * S + ahead];
          const float2 e = cp[u];
          const int c = __float_as_int(e.x);
          const float v = e.y;
          // warp-uniform: every lane of the warp is at the same (read, j)
          switch (c) {
            case 0: add_channel<M, RW, 0>(s, xw, v, u); break;
            case 1: add_channel<M, RW, 1>(s, xw, v, u); break;
            case 2: add_channel<M, RW, 2>(s, xw, v, u); break;
            case 3: add_channel<M, RW, 3>(s, xw, v, u); break;
            case 4: add_channel<M, RW, 4>(s, xw, v, u); break;
            default: break;  // a pad code counts nowhere
          }
        }
      }
    }

    // the warps' sums of this chunk, level by level, added in warp order
    // into the block's accumulator; each cell has one owner thread
#pragma unroll
    for (int k = 0; k < M; ++k) {
      __syncthreads();  // the previous level's readers are done
#pragma unroll
      for (int c = 0; c < 5; ++c)
#pragma unroll
        for (int q = 0; q < RW; ++q)
          part[((kw * 5 + c) * RW + q) * 32 + t] = s[k][c][q];
      __syncthreads();
      for (int idx = tid; idx < 5 * TW; idx += NT) {
        const int c = idx / TW, i = idx - c * TW;  // i = q * 32 + lane
        const int row = RW * (i % 32) + i / 32;
        float sum = 0.0f;
#pragma unroll
        for (int g = 0; g < NW; ++g) sum += part[(g * 5 + c) * TW + i];
        acc[(k * TW + row) * 5 + c] += sum;
      }
    }
  }

  __syncthreads();
  const int rows = min(TW, W - w0);
  for (int idx = tid; idx < M * rows * 5; idx += NT) {
    const int k = idx / (rows * 5);
    const int e = idx - k * rows * 5;  // (row, channel) of the tile
    out[((size_t)k * W + w0) * 5 + e] = acc[k * TW * 5 + e];
  }
}

}  // namespace count_core
