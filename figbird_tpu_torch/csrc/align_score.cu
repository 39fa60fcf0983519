// K5: gapless local scoring of every (read, candidate window) pair — the
// extend step of the seed-and-extend aligner.
//
// Replaces figbird_tpu/ops/align_score.py::_kernel (pallas_call at
// align_score.py:134), reached from align/core.py:_align_one_strand.
//
// Definition (bit-equal to the XLA path align/core.py:_score_candidates and
// to ops/align_score.py::score_candidates_plain).  Window w = flat[cand :
// cand + L], read r; base j scores s_j = 0 where r_j == gap, +match where
// w_j == r_j (so w_j is not the gap code either), else +mismatch; x_j = 1
// for a mismatch (r_j != gap, w_j != r_j).  With p the inclusive prefix
// sums of s and pre[j] = p[j-1] (pre[0] = 0):
//   local = max_j (p[j] - min(pre[0..j]))
//   end   = first j attaining local
//   start = first index <= end attaining min(pre[0..end])
//   n_mis = sum of x over [start, end]
//   e2e   = p[L-1]
//
// What bounds it on an H100.  Bytes: each window is read once (one or two
// 128-byte lines; the 4.6 Mb genome stays in the 50 MB L2) and five int32
// are written a pair.  Operations: L serial steps a pair, each a running
// minimum and a running first maximum; at about 13 integer instructions a
// base, issued at half the f32 rate (64 lanes a clock an SM), these bind,
// not the bytes.  The design:
// - A warp owns 32 consecutive pairs of the flat (B * C) order.  It copies
//   their windows into shared memory as aligned 4-byte words by cp.async,
//   lanes on consecutive words (one window a copy instruction, all in flight
//   at once), each window at an odd word stride so the scan's loads hit 32
//   banks; and the bytes of the (one to 32) reads those pairs belong to,
//   once per read, as words with a mask of their non-gap bytes.
// - Each lane then scans its pair four bases a step.  A funnel shift
//   aligns the window word to cand & 3; a zero-byte test gives the
//   mismatch bytes; one multiply turns the step's non-gap and mismatch
//   bytes into four byte-wise prefix counts, each of which indexes a table
//   of the state's increment.  The running state is packed into one
//   integer, Q = p 2^(2b) + cm 2^b + j (cm = mismatches so far, j = bases
//   so far, 2^b > L): the running minimum of Q is one min instruction and
//   keeps the first index on a tie of p (cm and j only grow), Q - min Q
//   holds the interval's score, mismatches and length at once, and the
//   best keeps the first end by a strict compare of the score field.  Where
//   L or the scores are too large for 32 bits the state is 64-bit.
// - Outputs are five planes (5, B * C) int32: each lane stores one int32 a
//   plane, 128 coalesced bytes a warp.  No atomics; one thread writes each
//   output.
// Bytes of flat outside [0, flen) are never read (they count as gap codes);
// flat must be 4-byte aligned.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// Warps per block (at most) and blocks per SM for __launch_bounds__; a
// trial source defines it before it includes this file.
#ifndef ALIGN_SCORE_TILE
#define ALIGN_SCORE_TILE 4, 12
#endif

namespace align_score {

#ifndef ALIGN_SCORE_HOST
__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
template <class T>
__device__ __forceinline__ T load_shared(uint32_t a) {
  T v;
  if constexpr (sizeof(T) == 4)
    asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  else
    asm("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void copy4_async(void* dst, const void* src) {
  const size_t g = __cvta_generic_to_global(src);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   shared_addr(dst)), "l"(g));
}
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                   : "memory");
}
#endif

// The block's first shared words hold the increment table, at a shared
// address that is a multiple of 256.
constexpr int TABLE_WORDS = 128;

struct Plan {
  int b;      // bits of the cm and j fields: 2^b > L
  int W;      // window words staged: ceil(L / 4) + 1
  int WS;     // their stride in shared memory (odd)
  int RS;     // a staged read's stride in uint4 (odd, >= ceil(L / 4))
  int NRW;    // reads a warp stages at most
  int SPW;    // words of the reads' raw span
  int words;  // shared words a warp
  bool wide;  // the packed state needs 64 bits
};

inline __host__ __device__ Plan plan(int C, int L, int match, int mismatch) {
  Plan p;
  p.b = 1;
  while ((1 << p.b) <= L) ++p.b;
  p.W = (L + 3) / 4 + 1;
  p.WS = p.W | 1;
  p.RS = ((L + 3) / 4) | 1;
  p.NRW = 31 / C + 2 < 32 ? 31 / C + 2 : 32;
  p.SPW = (p.NRW * L + 3) / 4 + 2;
  p.words = 32 * p.WS + 4 * p.NRW * p.RS + (p.SPW + 3) / 4 * 4;
  // |Q - min Q| < 2 (L max(|match|, |mismatch|) + 1) 2^(2b) must fit int32
  long long am = match < 0 ? -(long long)match : match;
  long long ax = mismatch < 0 ? -(long long)mismatch : mismatch;
  const long long pm = (long long)L * (am > ax ? am : ax);
  p.wide = 2 * p.b > 30 || (pm + 1) > (1LL << (30 - 2 * p.b));
  return p;
}

// Bytes 4a .. 4a + 3 of buf (len bytes), little-endian; those outside
// [0, len) read as fill.
__device__ __forceinline__ uint32_t word_of_bytes(
    const int8_t* __restrict__ buf, long long len, long long a,
    uint32_t fill) {
  uint32_t w = 0;
  for (int i = 0; i < 4; ++i) {
    const long long bi = 4 * a + i;
    w |= (bi >= 0 && bi < len ? (uint32_t)(uint8_t)buf[bi] : fill) << (8 * i);
  }
  return w;
}

// Bit 7 of each byte: set where that byte of v is not zero.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t v) {
  return (v | ((v & 0x7f7f7f7fu) + 0x7f7f7f7fu)) & 0x80808080u;
}

// Writes entry e (0 <= e < 25; others write nothing) of the increment
// table into the block's shared memory and returns the table's shared
// address.  The state's increment over the bases 0..k of a step when R of
// them are not gaps and X of those mismatch lies at byte (4R + X) sizeof(T)
// of the table.
template <class T>
__device__ __forceinline__ uint32_t put_table(int e, int b, int match,
                                              int mismatch) {
  extern __shared__ __align__(16) uint32_t smem[];
  const uint32_t s0 = shared_addr(smem), tb = (s0 + 255u) & ~255u;
  T* table = reinterpret_cast<T*>(reinterpret_cast<char*>(smem) + (tb - s0));
  const int R = e / 5, Xc = e % 5;
  if (e < 25 && Xc <= R)
    table[4 * R + Xc] = (T)match * ((T)1 << 2 * b) * (R - Xc)
                        + ((T)mismatch * ((T)1 << 2 * b) + ((T)1 << b)) * Xc;
  return tb;
}

// One base: the packed update, given Qk, the state after base j.  best is
// Q - min Q at the best end so far; mask = 2^(2b) - 1.
template <class T>
__device__ __forceinline__ void base(T& Q, T& Qmin, T& best, T& bestQ, T Qk,
                                     T mask) {
  Qmin = Q < Qmin ? Q : Qmin;           // min over pre[0..j]
  Q = Qk;
  const T bev = Q - Qmin;
  const bool c = bev > (best | mask);   // p[j] - min(pre[0..j]) greater:
  best = c ? bev : best;                // strict, the first end
  bestQ = c ? Q : bestQ;
}

// One warp's 32 pairs [i0, i0 + 32) of n.  Called by every lane of every
// warp of a (32, nw) block with dynamic shared memory of TABLE_WORDS +
// nw * plan.words words, the increment table at shared address tb.
template <class T>
__device__ __forceinline__ void warp_pairs(
    const int8_t* __restrict__ flat, const int8_t* __restrict__ reads,
    const int32_t* __restrict__ cand, int32_t* __restrict__ out, long long n,
    long long flen, int C, int L, int gap_code, const Plan pl, long long i0,
    uint32_t tb) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x;
  uint32_t* win = smem + TABLE_WORDS + (size_t)threadIdx.y * pl.words;
  uint4* rd4 = reinterpret_cast<uint4*>(win + 32 * pl.WS);   // [NRW][RS]
  uint32_t* span = reinterpret_cast<uint32_t*>(rd4 + pl.NRW * pl.RS);
  const uint32_t gap8 = (uint8_t)gap_code;
  const uint32_t g4 = 0x01010101u * gap8;
  const long long i = i0 + lane;
  const int nv = n - i0 < 32 ? (int)(n - i0) : 32;   // pairs of this warp
  const long long c_me = i < n ? cand[i] : 0;
  constexpr int e = sizeof(T) == 8;     // table offsets: (4R + X) << (2+e)

  // stage the windows, lanes on consecutive words
  const unsigned nwf = (unsigned)(flen / 4 < 0x7fffffffLL ? flen / 4
                                                          : 0x7fffffffLL);
  for (int t = 0; t < nv; ++t) {
    const int a0 = __shfl_sync(0xffffffffu, (int)c_me, t) >> 2;
    for (int w = lane; w < pl.W; w += 32) {
      const int a = a0 + w;
      if ((unsigned)a < nwf)
        copy4_async(win + t * pl.WS + w, flat + 4LL * a);
      else
        win[t * pl.WS + w] = word_of_bytes(flat, flen, a, gap8);
    }
  }
  // and the raw span of the reads of pairs i0 .. i0 + nv - 1
  const long long r0 = i0 / C;
  const int nr = (int)((i0 + nv - 1) / C - r0) + 1;
  const long long rlen = n / C * L, s0 = r0 * L / 4;
  const int n_sp = (int)(((r0 + nr) * L + 3) / 4 - s0);
  for (int w = lane; w < n_sp; w += 32) {
    const long long a = s0 + w;
    if (4 * a + 4 <= rlen)
      copy4_async(span + w, reads + 4 * a);
    else
      span[w] = word_of_bytes(reads, rlen, a, gap8);
  }
  copies_wait();
  __syncwarp();
  // each read as words, beside the table offsets of its non-gap bytes
  // (bit 2 + e of each, to select mismatches, and 4 x that)
  const int RW = (L + 3) / 4;
  for (int rr = 0; rr < nr; ++rr)
    for (int q = lane; q < RW; q += 32) {
      const long long o = (r0 + rr) * L + 4 * q - 4 * s0;   // byte in span
      const int ow = (int)(o >> 2);
      const uint32_t v = __funnelshift_r(span[ow], span[ow + 1],
                                         8 * (int)(o & 3));
      const uint32_t ng = nonzero_bytes(v ^ g4);
      rd4[rr * pl.RS + q] = uint4{v, ng >> (5 - e), ng >> (3 - e), 0};
    }
  __syncwarp();
  if (i >= n) return;

  // scan: four bases a step
  const uint32_t* ww = win + lane * pl.WS;
  const uint4* rw = rd4 + (int)(i / C - r0) * pl.RS;
  const int sh = 8 * (int)(c_me & 3);
  const int b = pl.b, s2 = 2 * pl.b;
  const T mask = ((T)1 << s2) - 1;
  T Q = 0, Qmin = 0, bestQ = 0;
  T best = sizeof(T) == 4 ? (T)INT_MIN : (T)LLONG_MIN;
  const int nq = L >> 2;
  // byte k: the table offset of bases 0..k of word q (inclusive prefix
  // counts of non-gap bases, 16 x T each, and of mismatches, 4 x T each)
  auto prefix = [&](int q) {
    const uint4 r = rw[q];
    const uint32_t d = __funnelshift_r(ww[q], ww[q + 1], sh) ^ r.x;
    const uint32_t t = (d & 0x7f7f7f7fu) + 0x7f7f7f7fu;   // bit 7: d != 0
    return ((((t | d) >> (5 - e)) & r.y) | r.z) * 0x01010101u;
  };
  // the increment of bases 0..k of a step: one byte permute puts byte k
  // of P into the table's address
  auto at = [&](uint32_t P, int k) {
    return load_shared<T>(__byte_perm(P, tb, 0x7650 + k));
  };
#pragma unroll 2
  for (int q = 0; q < nq; ++q) {
    const uint32_t P = prefix(q);
    const T Qs = Q;
    base<T>(Q, Qmin, best, bestQ, Qs + at(P, 0) + 1, mask);
    base<T>(Q, Qmin, best, bestQ, Qs + at(P, 1) + 2, mask);
    base<T>(Q, Qmin, best, bestQ, Qs + at(P, 2) + 3, mask);
    base<T>(Q, Qmin, best, bestQ, Qs + at(P, 3) + 4, mask);
  }
  const int rem = L & 3;   // the same for every lane
  if (rem) {
    const uint32_t P = prefix(nq);
    const T Qs = Q;
    for (int k = 0; k < rem; ++k)
      base<T>(Q, Qmin, best, bestQ, Qs + at(P, k) + (k + 1), mask);
  }
  const T low = ((T)1 << b) - 1;
  const int end = (int)(bestQ & low) - 1;
  out[i] = (int32_t)(best >> s2);                    // local
  out[n + i] = (int32_t)(Q >> s2);                   // e2e
  out[2 * n + i] = end + 1 - (int32_t)(best & low);  // start
  out[3 * n + i] = end;                              // end
  out[4 * n + i] = (int32_t)((best >> b) & low);     // n_mis
}

#ifdef __CUDACC__
template <class T, int NW, int BPS>
__global__ void __launch_bounds__(32 * NW, BPS)
    kernel(const int8_t* __restrict__ flat, const int8_t* __restrict__ reads,
           const int32_t* __restrict__ cand, int32_t* __restrict__ out,
           long long n, long long flen, int C, int L, int match, int mismatch,
           int gap_code, Plan pl) {
  const uint32_t tb =
      put_table<T>(threadIdx.y ? 32 : threadIdx.x, pl.b, match, mismatch);
  __syncthreads();
  const long long i0 = ((long long)blockIdx.x * blockDim.y + threadIdx.y) * 32;
  if (i0 >= n) return;
  warp_pairs<T>(flat, reads, cand, out, n, flen, C, L, gap_code, pl, i0, tb);
}

// The warps of a block: NW, or fewer where their shared memory would not fit
// in an SM's 227 KB.
template <int NW>
int warps(const Plan& pl) {
  int nw = NW;
  while (nw > 1 && (TABLE_WORDS + nw * pl.words) * 4 > 227 * 1024) nw /= 2;
  return nw;
}

template <class T, int NW, int BPS>
int launch(const void* flat, const void* reads, const void* cand, void* out,
           long long n, long long flen, int C, int L, int match, int mismatch,
           int gap_code, const Plan& pl, void* stream) {
  const int nw = warps<NW>(pl);
  const int bytes = (TABLE_WORDS + nw * pl.words) * 4;
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  // above 48 KB the dynamic shared memory is an opt-in of the kernel
  cudaError_t err = cudaFuncSetAttribute(
      kernel<T, NW, BPS>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + 32LL * nw - 1) / (32LL * nw);
  kernel<T, NW, BPS><<<(unsigned)blocks, dim3(32, nw), bytes,
                       (cudaStream_t)stream>>>(
      (const int8_t*)flat, (const int8_t*)reads, (const int32_t*)cand,
      (int32_t*)out, n, flen, C, L, match, mismatch, gap_code, pl);
  return (int)cudaGetLastError();
}

template <int NW, int BPS>
int stage_bytes(int C, int L) {
  const Plan pl = plan(C, L, 2, -6);
  return (TABLE_WORDS + warps<NW>(pl) * pl.words) * 4;
}
#endif

}  // namespace align_score

#ifdef __CUDACC__
// The dynamic shared memory a block asks for at C candidates and read length
// L (for reports).
extern "C" int align_score_stage_bytes(int C, int L) {
  return align_score::stage_bytes<ALIGN_SCORE_TILE>(C, L);
}

// flat: padded genome, int8, 4-byte aligned, flen bytes; reads: (B, L)
// int8; cand: (B * C,) int32 window starts; out: (5, B * C) int32 planes
// [local, e2e, start, end, n_mis].
extern "C" int score_candidates_launch(const void* flat, const void* reads,
                                       const void* cand, void* out,
                                       long long n, long long flen, int C,
                                       int L, int match, int mismatch,
                                       int gap_code, void* stream) {
  if (n == 0) return 0;
  if (C < 1 || L < 1 || L > 65535 || n % C || ((uintptr_t)flat & 3))
    return (int)cudaErrorInvalidValue;
  const align_score::Plan pl = align_score::plan(C, L, match, mismatch);
  return pl.wide ? align_score::launch<long long, ALIGN_SCORE_TILE>(
                       flat, reads, cand, out, n, flen, C, L, match, mismatch,
                       gap_code, pl, stream)
                 : align_score::launch<int, ALIGN_SCORE_TILE>(
                       flat, reads, cand, out, n, flen, C, L, match, mismatch,
                       gap_code, pl, stream);
}
#endif
