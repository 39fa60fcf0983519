// Runs the candidate-scoring kernel K5 (figbird_tpu_torch/csrc/align_score.cu)
// on the CPU, one host thread per CUDA thread, and holds each of its five
// outputs bit for bit against a direct transcription of the definition in
// the kernel's header comment:
//
//   s_j = 0 (read gap), +match (window == read, window not gap), else
//   +mismatch;  p = inclusive prefix sums, pre[j] = p[j-1], pre[0] = 0;
//   local = max_j (p[j] - min(pre[0..j])), end = first j attaining it,
//   start = first i <= end with pre[i] = min(pre[0..end]),
//   n_mis = mismatches in [start, end], e2e = p[L-1].
//
// The genome and read buffers of each case hold exactly their bytes, so a
// build with AddressSanitizer catches any read outside them; the cp.async
// copies are plain copies here.  Build with a C++20 compiler, this
// directory and csrc/ on the include path; exits with 0 when every case
// holds.
#include "cuda_runtime.h"

#include <cstdint>
#include <cstdio>
#include <deque>
#include <random>
#include <thread>
#include <vector>

thread_local Index3 threadIdx, blockIdx;
std::barrier<>* block_barrier;
std::barrier<>** warp_barriers;
unsigned (*warp_votes)[32];

#define ALIGN_SCORE_HOST
namespace align_score {
uint32_t smem[1 << 16];  // 256 KB
// a shared address is an offset into smem plus a base whose bytes 1 and 2
// are not zero, as a block's shared window on the card
constexpr uint32_t kWindow = 0x12300;
inline uint32_t shared_addr(const void* p) {
  return kWindow + (uint32_t)((const char*)p - (const char*)smem);
}
template <class T>
T load_shared(uint32_t a) {
  T v;
  std::memcpy(&v, (const char*)smem + (a - kWindow), sizeof(T));
  return v;
}
inline void copy4_async(void* d, const void* s) { std::memcpy(d, s, 4); }
inline void copies_wait() {}
}  // namespace align_score
#include "align_score.cu"

struct Case {
  const char* what;
  int B, C, L, match, mismatch, gap;
  long long flen;
  std::vector<int8_t> flat, reads;
  std::vector<int32_t> cand;
};

// A genome of G bases with N runs and single Ns, then 256 bytes of gap
// padding (the aligner's as_rows); reads copied from it with errors, Ns,
// trailing gap padding and now and then all gap; candidates at the read's
// true start (twice: ties), at 0, at the last legal start G - L - 1, in an
// N run, and anywhere.  tail > 0 instead cuts the buffer to flen = G - tail
// bytes and puts candidates at its very end (windows running past it).
Case make_case(const char* what, int B, int C, int L, int match, int mismatch,
               int gap, int seed, int tail = 0) {
  std::mt19937 g(seed);
  std::uniform_real_distribution<float> U(0, 1);
  const int G = 3000 + L * 4;
  Case cs{what, B, C, L, match, mismatch, gap, 0, {}, {}, {}};
  std::vector<int8_t> genome(G);
  for (auto& b : genome) b = (int8_t)(g() % 4);
  for (int k = 0; k < G / 200; ++k) genome[g() % G] = (int8_t)gap;
  const int nrun = 500 + (int)(g() % 500);
  for (int k = nrun; k < nrun + 60 && k < G; ++k) genome[k] = (int8_t)gap;
  cs.flat = genome;
  if (tail) {
    cs.flat.resize(G - tail);
  } else {
    cs.flat.resize(G + 256, (int8_t)gap);
  }
  cs.flen = (long long)cs.flat.size();
  const int last = tail ? (int)cs.flen - L : G - L - 1;
  std::vector<int> starts(B);
  for (int r = 0; r < B; ++r) {
    starts[r] = (int)(g() % (unsigned)(last + 1));
    for (int j = 0; j < L; ++j) {
      int8_t v = cs.flat[starts[r] + j];
      const float u = U(g);
      if (u < 0.03f) v = (int8_t)(g() % 4);
      else if (u < 0.05f) v = (int8_t)gap;
      cs.reads.push_back(v);
    }
    if (r % 4 == 1)  // ragged: trailing pad
      for (int j = L - L / 3; j < L; ++j) cs.reads[r * L + j] = (int8_t)gap;
    if (r % 9 == 4)  // all gap
      for (int j = 0; j < L; ++j) cs.reads[r * L + j] = (int8_t)gap;
  }
  for (int r = 0; r < B; ++r)
    for (int c = 0; c < C; ++c) {
      int v;
      switch ((r + c) % 7) {
        case 0: case 1: v = starts[r]; break;
        case 2: v = 0; break;
        case 3: v = last; break;
        case 4: v = nrun - (int)(g() % 40); break;
        default: v = (int)(g() % (unsigned)(last + 1));
      }
      if (tail && c % 2) v = last - (int)(g() % 3);  // the buffer's end
      if (v < 0) v = 0;
      cs.cand.push_back(v);
    }
  return cs;
}

// One launch: every warp of every block, a block's threads as host threads.
template <class T, int NW>
std::vector<int32_t> launch(const Case& cs) {
  const long long n = (long long)cs.B * cs.C;
  const align_score::Plan pl =
      align_score::plan(cs.C, cs.L, cs.match, cs.mismatch);
  std::vector<int32_t> out(5 * n, -7);
  const long long blocks = (n + 32 * NW - 1) / (32 * NW);
  for (long long blk = 0; blk < blocks; ++blk) {
    for (auto& s : align_score::smem) s = 0xabababab;
    uint32_t tb = 0;
    for (int e = 0; e < 25; ++e)
      tb = align_score::put_table<T>(e, pl.b, cs.match, cs.mismatch);
    std::deque<std::barrier<>> wb;
    std::vector<std::barrier<>*> wbp;
    for (int w = 0; w < NW; ++w) wbp.push_back(&wb.emplace_back(32));
    warp_barriers = wbp.data();
    static unsigned votes[32][32];
    warp_votes = votes;
    std::vector<std::thread> threads;
    for (int w = 0; w < NW; ++w)
      for (int t = 0; t < 32; ++t)
        threads.emplace_back([&, w, t] {
          threadIdx = {(unsigned)t, (unsigned)w, 0};
          blockIdx = {(unsigned)blk, 0, 0};
          const long long i0 = (blk * NW + w) * 32;
          if (i0 >= n) return;
          align_score::warp_pairs<T>(cs.flat.data(), cs.reads.data(),
                                     cs.cand.data(), out.data(), n, cs.flen,
                                     cs.C, cs.L, cs.gap, pl, i0, tb);
        });
    for (auto& th : threads) th.join();
  }
  return out;
}

// The definition for pair (r, c): local, e2e, start, end, n_mis.
void definition(const Case& cs, int r, int c, int o[5]) {
  const int L = cs.L;
  const long long c0 = cs.cand[(size_t)r * cs.C + c];
  std::vector<long long> p(L), pre(L + 1, 0), pmin(L);
  std::vector<int> x(L);
  long long acc = 0;
  for (int j = 0; j < L; ++j) {
    const int rd = cs.reads[(size_t)r * L + j];
    const long long k = c0 + j;
    const int w = (k >= 0 && k < cs.flen) ? cs.flat[k] : cs.gap;
    const bool rv = rd != cs.gap;
    const bool m = rv && w == rd && w != cs.gap;
    acc += rv ? (m ? cs.match : cs.mismatch) : 0;
    x[j] = rv && !m;
    p[j] = acc;
    pre[j + 1] = acc;
  }
  for (int j = 0; j < L; ++j) {
    pmin[j] = pre[0];
    for (int i = 1; i <= j; ++i) pmin[j] = std::min(pmin[j], pre[i]);
  }
  long long local = p[0] - pmin[0];
  int end = 0;
  for (int j = 1; j < L; ++j)
    if (p[j] - pmin[j] > local) local = p[j] - pmin[j], end = j;
  int start = 0;
  while (pre[start] != pmin[end]) ++start;
  int nmis = 0;
  for (int j = start; j <= end; ++j) nmis += x[j];
  o[0] = (int)local;
  o[1] = (int)p[L - 1];
  o[2] = start;
  o[3] = end;
  o[4] = nmis;
}

template <int NW>
int run(const Case& cs) {
  const align_score::Plan pl =
      align_score::plan(cs.C, cs.L, cs.match, cs.mismatch);
  const auto got = pl.wide ? launch<long long, NW>(cs) : launch<int, NW>(cs);
  const auto again = pl.wide ? launch<long long, NW>(cs) : launch<int, NW>(cs);
  const long long n = (long long)cs.B * cs.C;
  static const char* keys[5] = {"local", "e2e", "start", "end", "n_mis"};
  int bad = 0;
  for (int r = 0; r < cs.B; ++r)
    for (int c = 0; c < cs.C; ++c) {
      int want[5];
      definition(cs, r, c, want);
      const long long i = (long long)r * cs.C + c;
      for (int k = 0; k < 5; ++k)
        if (got[k * n + i] != want[k] && bad++ < 5)
          printf("  %s r%d c%d cand %d: %s %d, definition %d\n", cs.what, r,
                 c, cs.cand[i], keys[k], got[k * n + i], want[k]);
    }
  if (got != again) {
    printf("  %s: a second launch differs\n", cs.what);
    ++bad;
  }
  printf("%s: B %d C %d L %d, match %d mismatch %d gap %d, flen %lld, "
         "%s state, %d warps a block: %d bad\n", cs.what, cs.B, cs.C, cs.L,
         cs.match, cs.mismatch, cs.gap, cs.flen, pl.wide ? "64-bit" : "32-bit",
         NW, bad);
  return bad;
}

int main() {
  int bad = 0;
  // the main path's two shapes (C = 32, C = 8 with B not a multiple of the
  // four reads a warp holds), ragged C and L, long reads
  bad += run<4>(make_case("main C=32", 37, 32, 101, 2, -6, 4, 1));
  bad += run<4>(make_case("main C=8", 45, 8, 101, 2, -6, 4, 2));
  bad += run<2>(make_case("L=1", 13, 5, 1, 2, -6, 4, 3));
  bad += run<4>(make_case("L=7 C=1", 70, 1, 7, 2, -6, 4, 4));
  bad += run<4>(make_case("L=77 C=5", 29, 5, 77, 2, -6, 4, 5));
  bad += run<4>(make_case("L=151 C=32", 9, 32, 151, 2, -6, 4, 6));
  bad += run<4>(make_case("L=250 C=8", 11, 8, 250, 2, -6, 4, 7));
  bad += run<2>(make_case("L=250 C=32", 5, 32, 250, 2, -6, 4, 8));
  bad += run<4>(make_case("L=250 C=1", 40, 1, 250, 2, -6, 4, 9));
  // many ties (match 1, mismatch -1); scores too large for the 32-bit state;
  // another gap code; windows that run past the end of an unpadded buffer
  // whose length is not a multiple of 4
  bad += run<4>(make_case("ties", 21, 8, 101, 1, -1, 4, 10));
  bad += run<2>(make_case("wide", 9, 8, 77, 20000, -30000, 4, 11));
  bad += run<2>(make_case("gap -1", 11, 8, 7, 2, -6, -1, 12));
  bad += run<4>(make_case("buffer end", 17, 5, 101, 2, -6, 4, 13, 7));
  bad += run<2>(make_case("buffer end L=1", 7, 5, 1, 2, -6, 4, 14, 3));
  printf(bad ? "FAILED\n" : "ALL OK\n");
  return bad != 0;
}
