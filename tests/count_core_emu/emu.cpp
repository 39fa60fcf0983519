// Runs the count-and-fold core of the CUDA kernels K4 and K1
// (figbird_tpu_torch/csrc/count_core.cuh) on the CPU, one host thread per
// CUDA thread, and holds it against the definition summed in float64:
//
//   counts[k, w, c] = sum_r sum_j f(x[r, w - j], k) * vals[r, j]
//                                 * (codes[r, j] == c),   0 <= w - j < Pw.
//
// The arithmetic (fmaf in the kernel's order) is the card's; the cp.async
// copies are plain copies here.  Build with a C++20 compiler, this directory
// and csrc/ on the include path; exits with 0 when every case is within
// rtol 2e-6.
#include "cuda_runtime.h"

#include <cstdio>
#include <random>
#include <thread>
#include <vector>

thread_local Index3 threadIdx, blockIdx;
std::barrier<>* block_barrier;

#define COUNT_CORE_COPIES
namespace count_core {
float smem[1 << 16];  // 256 KB
inline void copy4_async(void* d, const void* s) { std::memcpy(d, s, 4); }
inline void copies_commit() {}
inline void copies_wait() {}
}  // namespace count_core
#include "count_core.cuh"

struct Raw {
  float operator()(float x, int) const { return x; }
};
struct Level {
  float shift, cut;
  float operator()(float lw, int k) const {
    const float lk = lw + (float)k * shift;
    return lk <= cut ? expf(fminf(fmaxf(lk, -745.0f), cut)) : 0.0f;
  }
};

// One launch of tile<M, RW, NW> over I instances, against the float64
// loop.  Raw weights are half zeros; log-weights spread over [-900, 0] with
// ~30% masked.  Codes 0-5, ~10% of the values 0, the others 1 or (quality)
// fractions.
template <int M, int RW, int NW, int BPS = 2, class F>
int run(int I, int P, int L, int Pw, int W, F f, bool levels, bool quality,
        int seed) {
  std::mt19937 g(seed);
  std::uniform_real_distribution<float> U(0, 1);
  std::vector<float> x(I * P * Pw), vals(I * P * L), out(I * M * W * 5, -7.f);
  std::vector<int8_t> codes(I * P * L);
  for (auto& v : x) {
    v = levels ? -900.f * U(g) : U(g);
    if (U(g) < (levels ? 0.3f : 0.5f)) v = levels ? -1e30f : 0.f;
  }
  for (auto& c : codes) c = (int8_t)(g() % 6);
  for (auto& v : vals) v = U(g) < 0.9f ? (quality ? U(g) * 0.01f : 1.f) : 0.f;
  const count_core::Plan p = count_core::plan<M, RW, NW, BPS>(P, L);
  if (p.RC < 1 || p.bytes > (int)sizeof(count_core::smem)) {
    printf("no plan\n");
    return 1;
  }
  constexpr int TW = 32 * RW;
  const int n_tiles = (W + TW - 1) / TW;
  for (int b = 0; b < I * n_tiles; ++b) {
    for (auto& s : count_core::smem) s = NAN;
    std::barrier<> bar(32 * NW);
    block_barrier = &bar;
    std::vector<std::thread> threads;
    for (int kw = 0; kw < NW; ++kw)
      for (int t = 0; t < 32; ++t)
        threads.emplace_back([&, kw, t] {
          threadIdx = {(unsigned)t, (unsigned)kw, 0};
          blockIdx = {(unsigned)b, 0, 0};
          const size_t inst = b / n_tiles;
          count_core::tile<M, RW, NW>(
              x.data() + inst * P * Pw, codes.data() + inst * P * L,
              vals.data() + inst * P * L, out.data() + inst * M * W * 5, P, L,
              Pw, W, (b % n_tiles) * TW, p.RC, p.S, p.LR, f);
        });
    for (auto& th : threads) th.join();
  }
  double worst = 0;
  int bad = 0;
  for (int i = 0; i < I; ++i)
    for (int k = 0; k < M; ++k)
      for (int w = 0; w < W; ++w)
        for (int c = 0; c < 5; ++c) {
          double ref = 0;
          for (int r = 0; r < P; ++r)
            for (int j = 0; j < L; ++j) {
              const int pp = w - j;
              if (pp < 0 || pp >= Pw || codes[(i * P + r) * L + j] != c)
                continue;
              ref += (double)f(x[(i * P + r) * Pw + pp], k) *
                     (double)vals[(i * P + r) * L + j];
            }
          const double got = out[((i * M + k) * W + w) * 5 + c];
          const double rel = ref == 0 ? (got == 0 ? 0 : 1e9)
                                      : std::fabs(got - ref) / ref;
          if (!(rel <= 2e-6) && bad++ < 5)
            printf("  i%d k%d w%d c%d: got %g, want %g\n", i, k, w, c, got,
                   ref);
          worst = std::max(worst, rel);
        }
  printf("M %d RW %d NW %d, I %d P %d L %d Pw %d W %d (RC %d, %d B): worst "
         "rel %.3g, %d bad\n", M, RW, NW, I, P, L, Pw, W, p.RC, p.bytes, worst,
         bad);
  return bad;
}

int main() {
  int bad = 0;
  const Level lv{140.f, 78.f};
  // K4's tile (8 rows a thread, 16 warps, one block per SM; once planned
  // for two, which leaves fewer reads a chunk than warps) and narrower
  // ones, ragged shapes, quality values
  bad += run<1, 8, 16, 1>(2, 33, 36, 40, 76, Raw(), false, true, 1);
  bad += run<1, 8, 16, 2>(1, 1, 7, 5, 11, Raw(), false, false, 2);
  bad += run<1, 4, 8>(1, 33, 7, 40, 47, Raw(), false, true, 3);
  bad += run<1, 4, 8>(1, 9, 36, 5, 40, Raw(), false, true, 4);
  bad += run<1, 1, 8>(1, 5, 33, 64, 97, Raw(), false, false, 5);
  // K1: 2 rows a thread at m = 6, 4 at m <= 3; both widths W
  bad += run<6, 2, 16, 1>(1, 33, 36, 40, 75, lv, true, false, 6);
  bad += run<3, 4, 16, 1>(2, 1, 36, 5, 41, lv, true, false, 7);
  bad += run<6, 2, 8>(1, 20, 7, 40, 46, lv, true, false, 8);
  bad += run<1, 4, 16, 1>(1, 45, 37, 50, 87, lv, true, false, 9);
  // the main path's shape (fewer reads), several chunks
  bad += run<2, 2, 16, 1>(1, 40, 101, 128, 229, lv, true, false, 10);
  bad += run<1, 8, 16, 1>(1, 70, 101, 128, 229, Raw(), false, false, 11);
  printf(bad ? "FAILED\n" : "ALL OK\n");
  return bad != 0;
}
