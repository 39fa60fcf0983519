// Runs the overlap-bonus kernel (figbird_tpu_torch/csrc/overlap.cu) on the
// CPU, one host thread per CUDA thread and one block after another, on the
// instances of a file, and writes its outputs to another:
//
//   overlap_emu IN OUT
//
// IN: int32 I, P, L, W, WL, cap; then pr (I, P, L) int8, p_len, p_match
// (I, P) int32, p_valid, accept (I, P) uint8, pos_gap (I, P) int32, tmpl
// (I, W) int8, gap_len, side_limit, perfect_gap, orig_gap, perfect_gaplen
// (I,) int32.  OUT: bonus (I,) f32, saved_l, saved_r (I,) int32.  Every
// array is exactly its bytes, so a build with AddressSanitizer catches a
// read outside one.  Build with a C++20 compiler, this directory and csrc/
// on the include path; tests/test_torch_overlap.py holds the outputs to
// the plain version's.
#include "cuda_runtime.h"

#include <cstdint>
#include <cstdio>
#include <deque>
#include <thread>
#include <vector>

thread_local Index3 threadIdx, blockIdx;
std::barrier<>* block_barrier;
std::barrier<>** warp_barriers;
unsigned (*warp_votes)[32];

namespace overlap {
int smem[1 << 16];  // 256 KB
}  // namespace overlap
#include "overlap.cu"

template <class T>
std::vector<T> take(FILE* f, size_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, f) != n) {
    fprintf(stderr, "short input\n");
    exit(2);
  }
  return v;
}

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  const auto h = take<int32_t>(f, 6);
  const int I = h[0], P = h[1], L = h[2], W = h[3], WL = h[4], cap = h[5];
  const size_t IP = (size_t)I * P;
  const auto pr = take<int8_t>(f, IP * L);
  const auto p_len = take<int32_t>(f, IP), p_match = take<int32_t>(f, IP);
  const auto p_valid = take<uint8_t>(f, IP), accept = take<uint8_t>(f, IP);
  const auto pos_gap = take<int32_t>(f, IP);
  const auto tmpl = take<int8_t>(f, (size_t)I * W);
  std::vector<std::vector<int32_t>> sc;
  for (int k = 0; k < 5; ++k) sc.push_back(take<int32_t>(f, I));
  fclose(f);
  if (overlap::shared_bytes(P, cap) > (long long)sizeof(overlap::smem))
    return 3;
  std::vector<float> bonus(I, -7.f);
  std::vector<int32_t> saved_l(I, -7), saved_r(I, -7);
  const overlap::Args g{pr.data(),      p_len.data(),   p_match.data(),
                        p_valid.data(), accept.data(),  pos_gap.data(),
                        tmpl.data(),    sc[0].data(),   sc[1].data(),
                        sc[2].data(),   sc[3].data(),   sc[4].data(),
                        bonus.data(),   saved_l.data(), saved_r.data(),
                        P,              L,              W,
                        WL,             cap};
  constexpr int NW = overlap::NW;
  for (int blk = 0; blk < I; ++blk) {
    for (auto& s : overlap::smem) s = -123456789;
    std::barrier<> bar(32 * NW);
    block_barrier = &bar;
    std::deque<std::barrier<>> wb;
    std::vector<std::barrier<>*> wbp;
    for (int w = 0; w < NW; ++w) wbp.push_back(&wb.emplace_back(32));
    warp_barriers = wbp.data();
    static unsigned votes[NW][32];
    warp_votes = votes;
    std::vector<std::thread> threads;
    for (int w = 0; w < NW; ++w)
      for (int t = 0; t < 32; ++t)
        threads.emplace_back([&, w, t] {
          threadIdx = {(unsigned)t, (unsigned)w, 0};
          blockIdx = {(unsigned)blk, 0, 0};
          overlap::instance(g, (size_t)blk);
        });
    for (auto& th : threads) th.join();
  }
  f = fopen(argv[2], "wb");
  if (!f) return 2;
  fwrite(bonus.data(), 4, I, f);
  fwrite(saved_l.data(), 4, I, f);
  fwrite(saved_r.data(), 4, I, f);
  fclose(f);
  return 0;
}
