// The partial EM's overlap bonus (Figbird's detect_overlap_gapestimate over
// an instance batch): +300 for a perfect spanning read, +30 x the longest
// verified overlap of a left and a right read, -100 for a false overlap,
// and the pair it saved.
//
// Replaces no Pallas kernel: it is the JAX package's jnp code
// figbird_tpu/fill/em.py::_detect_overlap_partial, which the port ran as
// plain PyTorch (ops/overlap.py::overlap_bonus_plain, its CPU version).
// Every partial EM pass runs it once, and there it cost about 247 kernel
// launches a pass, issued one Python call at a time: the host's time, not
// the card's, was the price.  This kernel is that step in one launch.
//
// What bounds it on an H100: launch and latency, not bytes.  An instance
// reads its P x L read codes (13 KB at P = 128, L = 101) a few times over
// and little else; a warp walks one read, or one pair of reads, at a time,
// so its time is the length of those chains.  Nothing is staged: the rows a
// block reads again come from L1 and L2.
//
// One block per instance, NW warps.  The steps, each as the plain version
// takes them:
//   1. a warp a read: its reach, side, the flank fragment checks (ok_l4,
//      ok_l8, ok_r4, ok_r8: mismatches over the fragment by ballot and
//      popcount) and the perfect-spanning test; l_max, r_min and perfect by
//      a block reduction of the warps' partials;
//   2. a thread a read: the left and right candidates (lc, rc) and their
//      counts;
//   3. the candidate lists: the first `cap` by key descending, ties by read
//      index (torch.argsort(-key, stable=True)); where cap >= P, every
//      candidate in read order.  A list holds candidates only: a read that
//      is not one pairs with nothing, so leaving it out keeps the order of
//      the pairs that count;
//   4. a warp a pair of the cap_l x cap_r pairs: the overlap's length and
//      its mismatches, and from them max_ov, any_false and the saved pair,
//      the first strict maximum of cmp_len in left-major order (argmax's).
// No atomics; every output is written by one thread.  The comparisons that
// involve a float round as PyTorch's do on the card: the threshold (0.2 -
// 1e-9, 0.08, 0.1) taken to f32 times the length in f32, one rounding
// (__fmul_rn, so nothing contracts), against the count in f32.

#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace overlap {

constexpr int NW = 8;           // warps a block
constexpr int BIG = 1 << 20;    // the plain version's "none" sentinel
constexpr int RED = 8 * NW;     // shared ints of the warps' partials

// per-read flags
enum : int {
  ACC = 1,
  LEFTISH = 2,
  OK_L4 = 4,
  OK_L8 = 8,
  OK_R4 = 16,
  OK_R8 = 32,
  RC_SM = 64,
  LC = 128,
  RC = 256,
};

struct Args {
  const int8_t* pr;          // (I, P, L) read codes
  const int32_t* p_len;      // (I, P)
  const int32_t* p_match;    // (I, P)
  const uint8_t* p_valid;    // (I, P) bool
  const uint8_t* accept;     // (I, P) bool
  const int32_t* pos_gap;    // (I, P) placement in gap coordinates
  const int8_t* tmpl;        // (I, W) window template
  const int32_t* gap_len;    // (I,) and the per-instance scalars below
  const int32_t* side_limit;
  const int32_t* perfect_gap;
  const int32_t* orig_gap;
  const int32_t* perfect_gaplen;
  float* bonus;              // (I,) outputs
  int32_t* saved_l;
  int32_t* saved_r;
  int P, L, W, WL, cap;
};

// The shared ints a block uses: the partials, then pos, len and flags of
// every read, then the two candidate lists.
inline __host__ __device__ int list_len(int P, int cap) {
  return cap >= P ? P : cap;
}
inline __host__ __device__ long long shared_bytes(int P, int cap) {
  return 4LL * (RED + 3LL * P + 2LL * list_len(P, cap));
}

// The warp's count of u < n with x[u] != y[u], where x[u] = a[oa + u] below
// la and fa from there on, y likewise (n <= L; oa, ob >= 0).
__device__ __forceinline__ int warp_mismatches(const int8_t* a, int oa,
                                               int la, int fa,
                                               const int8_t* b, int ob,
                                               int lb, int fb, int n) {
  int mis = 0;
  for (int u0 = 0; u0 < n; u0 += 32) {
    const int u = u0 + (int)threadIdx.x;
    bool d = false;
    if (u < n) {
      const int ca = oa + u < la ? a[oa + u] : fa;
      const int cb = ob + u < lb ? b[ob + u] : fb;
      d = ca != cb;
    }
    mis += __popc(__ballot_sync(0xffffffffu, d));
  }
  return mis;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

// mis <= thresh * f as PyTorch takes it: thresh in f32, times f in f32.
__device__ __forceinline__ bool within(int mis, float thresh, int f) {
  return (float)mis <= __fmul_rn(thresh, (float)f);
}

// Instance i, by the block's NW warps (threadIdx.x the lane, .y the warp).
__device__ void instance(const Args& g, size_t i) {
  extern __shared__ __align__(16) int smem[];
  const int P = g.P, L = g.L, W = g.W, lane = (int)threadIdx.x,
            warp = (int)threadIdx.y, tid = warp * 32 + lane;
  int* red = smem;               // [8][NW] partials
  int* s_pos = red + RED;        // [P]
  int* s_len = s_pos + P;        // [P]
  int* s_flag = s_len + P;       // [P]
  int* list_l = s_flag + P;      // [list_len]
  int* list_r = list_l + list_len(P, g.cap);

  const int8_t* pr = g.pr + i * P * L;
  const int8_t* tmpl = g.tmpl + i * W;
  const int gl = g.gap_len[i], sl = g.side_limit[i];
  const float T4 = (float)(0.2 - 1e-9), T8 = (float)0.08;

  // 1. a warp a read
  int w_lmax = -BIG, w_rmin = BIG, w_perfect = 0;
  for (int r = warp; r < P; r += NW) {
    const size_t k = i * P + r;
    const int pos = g.pos_gap[k], len = g.p_len[k], m = g.p_match[k];
    const bool acc = g.accept[k] && g.p_valid[k];
    const int reach = min(pos + len, gl) - 1;
    const bool leftish = m == 1 || m == 4 || pos < 0;
    const int8_t* row = pr + (size_t)r * L;
    // left-flank fragment: read chars at gap coords [-f, 0) vs the flank
    const int f_l = min(max(-pos, 0), sl);
    const int mis_l = warp_mismatches(
        row, clampi(-f_l - pos, 0, L), L, -1, tmpl, clampi(g.WL - f_l, 0, W - 1),
        W, 5, clampi(f_l, 0, L));
    // right-flank fragment from read coord gl - pos vs the flank prefix
    const int startr = gl - pos;
    const int f_r = clampi(min(sl, len - startr), 0, L);
    const int mis_r = warp_mismatches(
        row, clampi(startr, 0, L), L, -1, tmpl, clampi(g.WL + gl, 0, W - 1),
        W, 5, f_r);
    const bool startr_ok = startr >= 0 && startr <= len;
    const bool spans = acc && pos < 0 && pos + len > gl;
    int flag = (acc ? ACC : 0) | (leftish ? LEFTISH : 0);
    if (f_l >= 4 && within(mis_l, T4, f_l)) flag |= OK_L4;
    if (f_l >= 8 && within(mis_l, T8, f_l)) flag |= OK_L8;
    if (f_r >= 4 && startr_ok && within(mis_r, T4, f_r)) flag |= OK_R4;
    if (f_r >= 8 && startr_ok && within(mis_r, T8, f_r)) flag |= OK_R8;
    if (spans && (m == 2 || m == 3)) flag |= RC_SM;
    if (lane == 0) {
      s_pos[r] = pos;
      s_len[r] = len;
      s_flag[r] = flag;
    }
    if (acc && leftish) w_lmax = max(w_lmax, reach);
    if (acc && !leftish) w_rmin = min(w_rmin, max(pos, 0));
    if (spans && (flag & OK_L8) && (flag & OK_R8)) w_perfect = 1;
  }
  if (lane == 0) {
    red[warp] = w_lmax;
    red[NW + warp] = w_rmin;
    red[2 * NW + warp] = w_perfect;
  }
  __syncthreads();
  int l_max = -BIG, r_min = BIG;
  bool perfect = false;
  for (int w = 0; w < NW; ++w) {
    l_max = max(l_max, red[w]);
    r_min = min(r_min, red[NW + w]);
    perfect = perfect || red[2 * NW + w];
  }
  if (l_max == -BIG) l_max = -1;
  if (r_min == BIG) r_min = gl;

  // 2. a thread a read: the candidates
  int n_lc = 0, n_rc = 0;
  for (int r0 = 0; r0 < P; r0 += 32 * NW) {
    const int r = r0 + tid;
    bool lc = false, rc = false;
    if (r < P) {
      const int pos = s_pos[r], len = s_len[r], flag = s_flag[r];
      const bool acc = flag & ACC;
      const int reach = min(pos + len, gl) - 1;
      lc = acc && pos < 0 && reach >= r_min && pos + len <= gl;
      rc = (acc && pos > 0 && pos <= l_max) || (flag & RC_SM);
      s_flag[r] = flag | (lc ? LC : 0) | (rc ? RC : 0);
    }
    n_lc += __popc(__ballot_sync(0xffffffffu, lc));
    n_rc += __popc(__ballot_sync(0xffffffffu, rc));
  }
  if (lane == 0) {
    red[3 * NW + warp] = n_lc;
    red[4 * NW + warp] = n_rc;
  }
  __syncthreads();
  n_lc = n_rc = 0;
  for (int w = 0; w < NW; ++w) {
    n_lc += red[3 * NW + w];
    n_rc += red[4 * NW + w];
  }
  const bool by_index = g.cap >= P;  // the reference's scan order
  const int n_list = list_len(P, g.cap);
  const int nl = min(n_lc, n_list), nr = min(n_rc, n_list);

  // 3. the lists: a candidate's place is the number of candidates before it
  for (int r = tid; r < P; r += 32 * NW) {
    const int flag = s_flag[r];
    if (!(flag & (LC | RC))) continue;
    const int pos = s_pos[r];
    const int key = flag & LC ? min(pos + s_len[r], gl) - 1
                    : -(flag & RC_SM ? pos + (1 << 10) : max(pos, 0));
    const int side = flag & LC ? LC : RC;
    int before = 0;
    for (int s = 0; s < P; ++s) {
      const int fs = s_flag[s];
      if (!(fs & side)) continue;
      if (by_index) {
        before += s < r;
        continue;
      }
      const int ps = s_pos[s];
      const int ks = side == LC ? min(ps + s_len[s], gl) - 1
                     : -(fs & RC_SM ? ps + (1 << 10) : max(ps, 0));
      before += ks > key || (ks == key && s < r);
    }
    if (before < n_list) (side == LC ? list_l : list_r)[before] = r;
  }
  __syncthreads();

  // 4. a warp a pair, left-major
  int best_len = -1, best_q = 0, any_false = 0;
  for (int q = warp; q < nl * nr; q += NW) {
    const int li = list_l[q / nr], ri = list_r[q % nr];
    const int p1 = s_pos[li], l1 = s_len[li], p2 = s_pos[ri], l2 = s_len[ri];
    const bool sm2 = s_flag[ri] & RC_SM;
    const int diff_gap = max(p1 + l1 - gl, 0);
    const int ov = (p1 + l1 - 1) - p2 + 1 - diff_gap;
    const int xabs = sm2 ? -p2 : 0;
    const int cmp_len = ov - xabs;
    const int a1s = l1 - ov + xabs - diff_gap, a2s = xabs;
    const bool cand = li != ri && ov >= 5 && cmp_len > 0 && a1s >= 0 &&
                      a2s + cmp_len <= l2 && (s_flag[li] & OK_L4) &&
                      (s_flag[ri] & OK_R4);
    if (!cand) continue;  // the same for every lane of the warp
    const int mism = warp_mismatches(
        pr + (size_t)li * L, clampi(a1s, 0, L), L, -1, pr + (size_t)ri * L,
        clampi(a2s, 0, L), L, -2, min(cmp_len, L));
    if ((float)mism <= __fmul_rn((float)0.1, (float)max(cmp_len, 1))) {
      if (cmp_len > best_len) {
        best_len = cmp_len;
        best_q = q;
      }
    } else {
      any_false = 1;
    }
  }
  if (lane == 0) {
    red[5 * NW + warp] = best_len;
    red[6 * NW + warp] = best_q;
    red[7 * NW + warp] = any_false;
  }
  __syncthreads();
  if (tid != 0) return;
  for (int w = 0; w < NW; ++w) {
    const int bl = red[5 * NW + w], bq = red[6 * NW + w];
    if (bl > best_len || (bl == best_len && bl >= 0 && bq < best_q)) {
      best_len = bl;
      best_q = bq;
    }
    any_false = any_false || red[7 * NW + w];
  }
  const bool has = best_len >= 0;
  const int max_ov = has ? best_len : 0;
  const bool has_rm = r_min <= l_max;
  float b;
  if (perfect || (g.perfect_gap[i] == 1 && g.orig_gap[i] <= 20 &&
                  gl == g.perfect_gaplen[i]))
    b = 300.0f;
  else if (has_rm && ((!any_false && max_ov >= 5) ||
                      (any_false && max_ov >= 10)))
    b = __fmul_rn(30.0f, (float)max_ov);
  else if (has_rm && (any_false || max_ov < 5))
    b = -100.0f;
  else
    b = 0.0f;
  g.bonus[i] = b;
  g.saved_l[i] = has ? list_l[best_q / nr] : -1;
  g.saved_r[i] = has ? list_r[best_q % nr] : -1;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(32 * NW) kernel(Args g) {
  instance(g, blockIdx.x);
}
#endif

}  // namespace overlap

#ifdef __CUDACC__
// pr (I, P, L) int8; p_len, p_match, pos_gap (I, P) int32; p_valid, accept
// (I, P) bool; tmpl (I, W) int8; gap_len, side_limit, perfect_gap,
// orig_gap, perfect_gaplen (I,) int32; outputs bonus (I,) f32, saved_l,
// saved_r (I,) int32.  cap: the candidate lists' length (cap >= P: every
// candidate in read order).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int overlap_launch(const void* pr, const void* p_len,
                              const void* p_match, const void* p_valid,
                              const void* accept, const void* pos_gap,
                              const void* tmpl, const void* gap_len,
                              const void* side_limit, const void* perfect_gap,
                              const void* orig_gap,
                              const void* perfect_gaplen, void* bonus,
                              void* saved_l, void* saved_r, int I, int P,
                              int L, int W, int WL, int cap, void* stream) {
  if (I == 0) return 0;
  if (P < 1 || L < 1 || W < 1 || cap < 1 || P > 32768)
    return (int)cudaErrorInvalidValue;
  const long long bytes = overlap::shared_bytes(P, cap);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {  // above 48 KB an opt-in of the kernel
    cudaError_t err = cudaFuncSetAttribute(
        overlap::kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  overlap::Args g{(const int8_t*)pr,         (const int32_t*)p_len,
                  (const int32_t*)p_match,   (const uint8_t*)p_valid,
                  (const uint8_t*)accept,    (const int32_t*)pos_gap,
                  (const int8_t*)tmpl,       (const int32_t*)gap_len,
                  (const int32_t*)side_limit, (const int32_t*)perfect_gap,
                  (const int32_t*)orig_gap,  (const int32_t*)perfect_gaplen,
                  (float*)bonus,             (int32_t*)saved_l,
                  (int32_t*)saved_r,         P, L, W, WL, cap};
  overlap::kernel<<<I, dim3(32, overlap::NW), (size_t)bytes,
                    (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}
#endif
