// Runs the banded-score core of the CUDA kernels K2 and K3
// (figbird_tpu_torch/csrc/band_core.cuh) with their own tile functors
// (band_soft.cu, band_hard.cu) on the CPU, one host thread per CUDA thread,
// and holds it against the definition
//
//   score[r, p] = sum_{j ascending, valid[r, j], 0 <= codes[r, j] < 5}
//                 f(p + j, j, codes[r, j]):
//
// bit for bit against that sum taken in f32 in ascending j (the order the
// kernels promise), within rtol 1e-5, atol 1e-4 of it taken in float64, and
// K3's gap-string form bit for bit against its K form on the K that
// fill/em.py's hard_K builds.  Build with a C++20 compiler, this directory
// and csrc/ on the include path; exits with 0 when every case holds.
#include "cuda_runtime.h"

#include <cstdio>
#include <deque>
#include <random>
#include <thread>
#include <vector>

thread_local Index3 threadIdx, blockIdx;
std::barrier<>* block_barrier;
std::barrier<>** warp_barriers;
unsigned (*warp_votes)[32];

namespace band_core {
float smem[1 << 16];  // 256 KB
}  // namespace band_core
#include "band_hard.cu"
#include "band_soft.cu"

struct Case {
  int I, P, L, Wp, R;
  std::vector<int8_t> codes, g;
  std::vector<uint8_t> valid;
  std::vector<float> A, B, e, a, b, ln, K;
};

// Codes 0-5 (and a few -1), ~20% masked, whole reads masked now and then;
// probabilities with zeros (the 1e-30 clamp); a gap string with Ns (4) and
// positions past the contig (5); K as hard_K builds it from that string.
Case make_case(int I, int P, int L, int Wp, int seed) {
  std::mt19937 gen(seed);
  std::uniform_real_distribution<float> U(0, 1);
  Case cs{I, P, L, Wp, Wp + L - 1 + seed % 3};
  const int R = cs.R;
  cs.codes.resize(I * P * L);
  cs.valid.resize(I * P * L);
  for (int i = 0; i < I * P * L; ++i) {
    cs.codes[i] = (int8_t)(U(gen) < 0.02f ? -1 : gen() % 6);
    cs.valid[i] = U(gen) < 0.8f && (i / L) % 7 != 3;
  }
  for (int i = 0; i < I * R * 5; ++i) {
    cs.A.push_back(i % 11 == 0 ? 0.f : U(gen));
    cs.B.push_back(i % 13 == 0 ? 0.f : U(gen) * 1e-2f);
  }
  for (int j = 0; j < L; ++j) {
    cs.e.push_back(j < 2 ? 0.f : U(gen) * 1e-2f);
    cs.a.push_back(-U(gen) * 0.1f);
    cs.b.push_back(-2.f - U(gen) * 4.f);
  }
  for (int i = 0; i < 25; ++i) cs.ln.push_back(-U(gen) * 3.f);
  for (int w = 0; w < I * R; ++w) {
    const float u = U(gen);
    cs.g.push_back((int8_t)(u < 0.1f ? 5 : u < 0.2f ? 4 : gen() % 4));
  }
  for (int i = 0; i < I; ++i)
    for (int w = 0; w < R; ++w) {
      const int gw = cs.g[i * R + w], gs = gw < 4 ? gw : 4;
      for (int j = 0; j < L; ++j)
        for (int c = 0; c < 5; ++c)
          cs.K.push_back(gw >= 5 ? 0.f
                         : c == gs ? cs.a[j]
                                   : cs.b[j] + cs.ln[gs * 5 + c]);
    }
  return cs;
}

// One launch of the core over every (instance, position tile), a block's
// threads as host threads.
template <int NQ, int NR, int NW, class Make>
std::vector<float> launch(const Case& cs, Make make, int LJ) {
  constexpr int TP = 32 * NQ;
  const int LP = (LJ + 3) / 4 * 4;
  std::vector<float> out(cs.I * cs.P * cs.Wp, -7.f);
  const int n_tiles = (cs.Wp + TP - 1) / TP;
  for (int blk = 0; blk < cs.I * n_tiles; ++blk) {
    for (auto& s : band_core::smem) s = NAN;
    std::barrier<> bar(32 * NW);
    block_barrier = &bar;
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
          const size_t inst = blk / n_tiles;
          const size_t rows = inst * cs.P * cs.L;
          band_core::scores<NQ, NR, NW>(
              cs.codes.data() + rows, cs.valid.data() + rows,
              out.data() + inst * cs.P * cs.Wp, cs.P, cs.L, cs.Wp,
              (blk % n_tiles) * TP, LJ, LP, make(inst));
        });
    for (auto& th : threads) th.join();
  }
  return out;
}

// The definition: the f32 sum in ascending j, and the float64 sum.
template <class Make>
int check(const Case& cs, Make make, const std::vector<float>& got,
          double rtol, double atol, const char* what) {
  int bad = 0;
  double worst = 0;
  for (int i = 0; i < cs.I; ++i) {
    const auto f = make((size_t)i);
    for (int r = 0; r < cs.P; ++r)
      for (int p = 0; p < cs.Wp; ++p) {
        float s32 = 0.f;
        double s64 = 0;
        for (int j = 0; j < cs.L; ++j) {
          const size_t k = ((size_t)i * cs.P + r) * cs.L + j;
          const int c = cs.codes[k];
          if (!cs.valid[k] || c < 0 || c >= 5) continue;
          const float v = f(p + j, j, c);
          s32 += v;
          s64 += v;
        }
        const float o = got[((size_t)i * cs.P + r) * cs.Wp + p];
        const double err = std::fabs((double)o - s64);
        worst = std::max(worst, err);
        const bool same = std::memcmp(&o, &s32, 4) == 0;
        if ((!same || !(err <= atol + rtol * std::fabs(s64))) && bad++ < 5)
          printf("  %s i%d r%d p%d: got %.9g, f32 sum %.9g, f64 sum %.12g\n",
                 what, i, r, p, o, s32, s64);
      }
  }
  printf("  %s: worst abs err vs float64 %.3g, %d bad\n", what, worst, bad);
  return bad;
}

template <int NQ, int NR, int NW>
int run(int I, int P, int L, int Wp, int LJ, int seed) {
  const Case cs = make_case(I, P, L, Wp, seed);
  if (LJ == 0) LJ = band_core::plan<NQ, NR, NW, 1>(L).LJ;
  printf("NQ %d NR %d NW %d, I %d P %d L %d Wp %d R %d, %d read positions "
         "a pass\n", NQ, NR, NW, I, P, L, Wp, cs.R, LJ);
  const SoftMake soft{cs.A.data(), cs.B.data(), cs.e.data(), cs.R};
  const KMake kf{cs.K.data(), cs.R, 5 * L};
  const GapMake gap{cs.g.data(), cs.a.data(), cs.b.data(), cs.ln.data(),
                    cs.R};
  int bad = check(cs, soft, launch<NQ, NR, NW>(cs, soft, LJ), 1e-5, 1e-3,
                  "K2");
  const auto hk = launch<NQ, NR, NW>(cs, kf, LJ);
  const auto hg = launch<NQ, NR, NW>(cs, gap, LJ);
  bad += check(cs, kf, hk, 1e-5, 1e-4, "K3, K form");
  bad += check(cs, gap, hg, 1e-5, 1e-4, "K3, gap-string form");
  if (std::memcmp(hk.data(), hg.data(), hk.size() * 4) != 0) {
    printf("  K3: the gap-string form differs from the K form\n");
    ++bad;
  }
  return bad;
}

int main() {
  int bad = 0;
  // the kernels' shape (2 positions a lane, 1 read a warp, 32 warps) and
  // narrower ones; one read and 37; 5 and 70 positions; L 7 and 50; passes
  // of fewer read positions than L (the chunked form long reads take)
  bad += run<2, 1, 32>(2, 37, 50, 70, 0, 1);
  bad += run<2, 4, 16>(1, 1, 7, 5, 0, 2);
  bad += run<2, 4, 16>(1, 37, 7, 70, 0, 3);
  bad += run<2, 4, 16>(2, 1, 50, 5, 0, 4);
  bad += run<1, 4, 8>(1, 37, 50, 70, 0, 5);
  bad += run<1, 1, 8>(2, 37, 7, 5, 0, 6);
  bad += run<4, 2, 8>(1, 37, 50, 70, 0, 7);
  bad += run<2, 4, 16>(1, 37, 50, 70, 13, 8);
  bad += run<1, 2, 4>(1, 9, 50, 5, 32, 9);
  // the main path's read length, and a read longer than a pass holds
  bad += run<2, 4, 16>(1, 20, 101, 64, 0, 10);
  bad += run<2, 4, 16>(1, 9, 151, 40, 0, 11);
  printf(bad ? "FAILED\n" : "ALL OK\n");
  return bad != 0;
}
