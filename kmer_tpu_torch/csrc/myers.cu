// Myers bit-vector approximate matching in HW (infix) mode: for every
// (read, pattern) lane, the best edit distance over all end positions in
// the read and how many end positions reach it (edlib's numLocations),
// counted where best <= max_e, else 0; either written as (R, P) int32
// counts or summed over the reads into a caller's int64 [P] total.
//
// Replaces the `lax.scan` of kmer_tpu/kernels/myers.py:50
// (myers_hw_counts, one 32-bit word a pattern) and :134
// (myers_hw_counts_multiword, W words with ripple carries), and the
// tool's sum over reads (kmer_tpu/tools/ed_vaf_counter.py:153); neither
// scan is a Pallas kernel: XLA compiles each into one on-device loop over
// text positions.  The port's plain versions (kernels/myers.py
// myers_hw_counts{,_multiword}_plain) run the same loop from the host.
//
// Bound on the H100: the integer pipe.  Every operation of a lane-step
// (one read base against one pattern) is a 32-bit logic op, add, shift,
// compare or select; LOP3, IADD3, SHF, ISETP, SEL and IMNMX issue to the
// ALU pipe, 16 lanes a clock in each of an SM's 4 sub-partitions, half
// the issue rate.  A lane reads nothing but its read's codes, so the lever
// is fewer integer instructions a lane-step.  The design:
//
// * A mask-free step.  Each pattern is stored left-aligned: its last base
//   sits at bit 31 of the top word W - 1, the 32 W - m bits below its
//   first base are phantom positions with Peq 0, pv 1 and mv 0.  Those
//   stay so by themselves: (eq & pv) + pv leaves them all ones with no
//   carry into the pattern, so ph = mh = 0 there and nothing shifts into
//   the pattern's first bit (the free start of HW mode).  No per-word
//   mask and no per-pattern top bit remain: the score moves by
//   ph >> 31 - mh >> 31 of the top word, pv and mv are one LOP3 each.
//   m = 0 (and m > 32 W, where the plain version never moves the score
//   either) stages Peq 0: the score stays at m and every step counts.
// * Several patterns a thread (kPatterns<W>) of one read: one code load,
//   one clamp and one Peq row address serve all of them, their Peq words
//   come in one vector load from shared memory, and the independent
//   recurrences give the scheduler work to interleave.
// * Codes read 16 at a time: one 16-byte load a warp (a broadcast: the
//   warp shares the read) per 16 steps when the row stride is a multiple
//   of 16, else one byte a step.  A code >= n_alpha (the catch-all, the
//   255 fill) reads the table's zero row, so it matches nothing; the
//   clamp is one IMNMX a thread a step.
// * The best / count update has no branch and no min: the score moves by
//   at most one a step, so from a virtual position 0 (best m, count 1,
//   taken off at the end when the best stays m) a new best is exactly
//   score + 1 == best; two compares and predicated adds, and the score's
//   two bits go in as one LEA.HI each.  ptxas leaves 7 LOP3, 2 LEA.HI, 2
//   ISETP and a SEL a lane-step on the ALU pipe, the adds and left shifts
//   on the others.
// * A block is 8 warps over the same 32 K patterns; each warp walks
//   reads_a_warp reads (the launcher picks it so the grid is a few waves
//   of the card).  The block stages its patterns' left-aligned Peq as
//   tab[code][word][pattern] in shared memory once.  In the sum form a
//   thread keeps its patterns' totals in registers over its reads, the
//   block adds the 8 warps' totals in shared memory and issues one
//   64-bit atomicAdd per (block, pattern) whose total is not 0.
// * Additions across words: one add.cc / addc.cc chain (inline PTX) for
//   the W-word (eq & pv) + pv, and a funnel shift a word for ph << 1,
//   mh << 1.
//
// W <= kRegWords (256 bases) keeps every word in registers.  A wider W,
// or a table larger than the block's shared memory (W >= 3 with an
// alphabet of a few hundred codes), runs myers_scratch: the one-lane
// form (scripts/myers_baseline.cu keeps it whole, for timing), one
// thread a lane, the masked step on right-aligned words, pv and mv in a
// scratch plane [2][W][R * P] the caller allocates (ktt_myers_shape says
// when), Peq read from device memory; its sum form adds each lane's count
// with one atomicAdd.
//
// All bit-vector arithmetic is uint32_t: `+` wraps at 32 bits, shifts
// are logical and never reach 32.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 64;  // myers_scratch's patterns a block
constexpr int kRegWords = 8;
constexpr int kBest0 = 0x3FFFFFFF;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;
constexpr int kMaxReads = 16;  // reads a warp walks, at most

// patterns a thread: KTT_MYERS_K1 for one word, KTT_MYERS_KW for 2-4
// words, 1 above (1, 2 or 4: the width of the shared-memory vector load);
// scripts/tune_myers.py builds variants of these two macros
#ifndef KTT_MYERS_K1
#define KTT_MYERS_K1 4
#endif
#ifndef KTT_MYERS_KW
#define KTT_MYERS_KW 2
#endif

template <int W>
constexpr int kPatterns = W == 1 ? KTT_MYERS_K1
                                 : (W <= 4 ? KTT_MYERS_KW : 1);

struct Args {
  const uint32_t* peq;       // [P][W][n_alpha], right-aligned
  const int32_t* pat_len;    // [P]
  const uint8_t* reads;      // [R][L] codes
  const int32_t* read_len;   // [R]
  int64_t R, P, L;
  int n_alpha, W, max_e;
  int reads_a_warp;          // myers_regs: reads each warp walks
  int tile;                  // myers_scratch: patterns a block
  bool vec;                  // 16-byte code loads (L % 16 == 0, aligned)
  uint32_t* scratch;         // [2][W][R * P] (myers_scratch only)
  int32_t* out;              // [R][P] counts, or null
  unsigned long long* sums;  // [P] totals (added to), or null
};

// ---- the register form --------------------------------------------------

// s = a + b over W words, word 0 lowest: one carry chain
template <int W>
__device__ __forceinline__ void add_words(const uint32_t* a,
                                          const uint32_t* b, uint32_t* s) {
  if constexpr (W == 1) {
    s[0] = a[0] + b[0];
  } else if constexpr (W == 2) {
    asm("add.cc.u32 %0, %2, %4;\n\t"
        "addc.u32 %1, %3, %5;"
        : "=r"(s[0]), "=r"(s[1])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]), "r"(b[1]));
  } else if constexpr (W == 3) {
    asm("add.cc.u32 %0, %3, %6;\n\t"
        "addc.cc.u32 %1, %4, %7;\n\t"
        "addc.u32 %2, %5, %8;"
        : "=r"(s[0]), "=r"(s[1]), "=r"(s[2])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(b[0]), "r"(b[1]),
          "r"(b[2]));
  } else if constexpr (W == 4) {
    asm("add.cc.u32 %0, %4, %8;\n\t"
        "addc.cc.u32 %1, %5, %9;\n\t"
        "addc.cc.u32 %2, %6, %10;\n\t"
        "addc.u32 %3, %7, %11;"
        : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]), "r"(b[2]), "r"(b[3]));
  } else {
    // W = 5..8: the low four words with their carry out, then the high
    // words plus that carry (the flag does not survive between two asm
    // statements); patterns past 128 bases only
    uint32_t c;
    asm("add.cc.u32 %0, %5, %9;\n\t"
        "addc.cc.u32 %1, %6, %10;\n\t"
        "addc.cc.u32 %2, %7, %11;\n\t"
        "addc.cc.u32 %3, %8, %12;\n\t"
        "addc.u32 %4, %13, %13;"
        : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(c)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]), "r"(b[2]), "r"(b[3]), "r"(0u));
    uint32_t hi[W - 4];
    add_words<W - 4>(a + 4, b + 4, hi);
#pragma unroll
    for (int w = 0; w < W - 4; ++w) {
      s[4 + w] = hi[w] + c;
      c = s[4 + w] < c ? 1u : 0u;
    }
  }
}

// K patterns' Peq words of one word index: one vector load from the
// shared-memory address `at`
template <int K>
__device__ __forceinline__ void load_eq(uint32_t at, uint32_t* eq) {
  if constexpr (K == 4) {
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(eq[0]), "=r"(eq[1]), "=r"(eq[2]), "=r"(eq[3])
                 : "r"(at));
  } else if constexpr (K == 2) {
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(eq[0]), "=r"(eq[1])
                 : "r"(at));
  } else {
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(eq[0]) : "r"(at));
  }
}

template <int W, int K>
struct State {
  uint32_t pv[K][W], mv[K][W];
  int score[K], best[K], cnt[K];
};

// one text step of K left-aligned patterns; at: the shared-memory address
// of the thread's first Peq word of this step's code in
// tab[code][word][pattern]
template <int W, int K>
__device__ __forceinline__ void step(uint32_t at, State<W, K>& s) {
  constexpr int kTile = 32 * K;
  uint32_t eq[W][K];
#pragma unroll
  for (int w = 0; w < W; ++w) load_eq<K>(at + w * kTile * 4, eq[w]);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    uint32_t x[W], a[W], sum[W], ph[W], mh[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      x[w] = eq[w][j] | s.mv[j][w];
      a[w] = eq[w][j] & s.pv[j][w];
    }
    add_words<W>(a, s.pv[j], sum);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t pv = s.pv[j][w];
      const uint32_t xh = (sum[w] ^ pv) | eq[w][j];
      ph[w] = s.mv[j][w] | ~(xh | pv);
      mh[w] = pv & xh;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t ph2 = w ? __funnelshift_l(ph[w - 1], ph[w], 1)
                             : ph[0] << 1;
      const uint32_t mh2 = w ? __funnelshift_l(mh[w - 1], mh[w], 1)
                             : mh[0] << 1;
      s.pv[j][w] = mh2 | ~(x[w] | ph2);
      s.mv[j][w] = ph2 & x[w];
    }
    // the score moves by bit 31 of the top word's ph (up) and mh (down):
    // the high word of 2 x, unsigned and signed, added in (ptxas makes
    // each one LEA.HI); then, as the score moves by at most one a step
    // and starts from a virtual position 0 (best m, count 1), a new best
    // is score + 1 == best and moves the best down by one: two compares
    // and three predicated updates
    int score = s.score[j];
    asm("mad.hi.u32 %0, %1, 2, %0;" : "+r"(score) : "r"(ph[W - 1]));
    asm("mad.hi.s32 %0, %1, 2, %0;" : "+r"(score) : "r"(mh[W - 1]));
    asm("{\n\t.reg .pred lt, eq;\n\t"
        ".reg .s32 up;\n\t"
        "add.s32 up, %2, 1;\n\t"
        "setp.eq.s32 lt, up, %0;\n\t"
        "setp.eq.s32 eq, %2, %0;\n\t"
        "@eq add.s32 %1, %1, 1;\n\t"
        "@lt mov.s32 %1, 1;\n\t"
        "@lt add.s32 %0, %0, -1;\n\t}"
        : "+r"(s.best[j]), "+r"(s.cnt[j])
        : "r"(score));
    s.score[j] = score;
  }
}

__device__ __forceinline__ int steps_of(const Args& a, int64_t r) {
  const int64_t n = a.read_len[r];
  return static_cast<int>(n < 0 ? 0 : (n < a.L ? n : a.L));
}

// word w of a pattern's W-word Peq column shifted left by 32 W - m bits
// (left-aligned), code c < n_alpha; 0 for m = 0 and m > 32 W
__device__ __forceinline__ uint32_t aligned_word(const Args& a,
                                                 const uint32_t* col, int m,
                                                 int W, int w, int c) {
  if (m <= 0 || m > 32 * W) return 0u;
  const int sh = 32 * W - m;
  const int ws = sh >> 5, bs = sh & 31;
  const int lo = w - ws;  // the source word whose bits land here
  const uint32_t hi_part = lo >= 0 ? col[lo * a.n_alpha + c] << bs : 0u;
  const uint32_t lo_part =
      (bs && lo >= 1) ? col[(lo - 1) * a.n_alpha + c] >> (32 - bs) : 0u;
  return hi_part | lo_part;
}

template <int W>
__host__ __device__ constexpr int64_t table_words(int n_alpha) {
  return static_cast<int64_t>(n_alpha + 1) * W * 32 * kPatterns<W>;
}

// dynamic shared memory of myers_regs<W>: the table, then (sum form)
// the 8 warps' totals
template <int W>
size_t regs_smem(int n_alpha, bool sums) {
  const size_t tab = ((table_words<W>(n_alpha) * 4 + 15) / 16) * 16;
  return tab + (sums ? static_cast<size_t>(kWarps) * 32 * kPatterns<W> * 8
                     : 0);
}

template <int W>
__global__ void __launch_bounds__(kThreads) myers_regs(Args a) {
  constexpr int K = kPatterns<W>;
  constexpr int kTile = 32 * K;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tab = smem;  // [n_alpha + 1][W][kTile]
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t left = a.P - p0;
  const int np = left < kTile ? static_cast<int>(left) : kTile;
  const int64_t n_tab = table_words<W>(a.n_alpha);
  for (int64_t i = threadIdx.x; i < n_tab; i += kThreads) {
    const int q = static_cast<int>(i % kTile);
    const int w = static_cast<int>((i / kTile) % W);
    const int c = static_cast<int>(i / (kTile * W));
    uint32_t v = 0u;
    if (q < np && c < a.n_alpha)
      v = aligned_word(a, a.peq + (p0 + q) * W * a.n_alpha,
                       a.pat_len[p0 + q], W, w, c);
    tab[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int m[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int q = lane * K + j;
    m[j] = q < np ? a.pat_len[p0 + q] : 0;
  }
  unsigned long long total[K];
#pragma unroll
  for (int j = 0; j < K; ++j) total[j] = 0ull;
  // the thread's Peq words of code 0; code c is c rows of W x kTile on
  const uint32_t mine = static_cast<uint32_t>(__cvta_generic_to_shared(
      tab + lane * K));
  constexpr uint32_t kRow = W * kTile * 4;
  const uint32_t cmax = static_cast<uint32_t>(a.n_alpha);
  const int64_t r0 =
      static_cast<int64_t>(blockIdx.y) * kWarps * a.reads_a_warp + warp;
  if (lane * K < np) {
    for (int i = 0; i < a.reads_a_warp; ++i) {
      const int64_t r = r0 + static_cast<int64_t>(i) * kWarps;
      if (r >= a.R) break;
      State<W, K> s;
#pragma unroll
      for (int j = 0; j < K; ++j) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          s.pv[j][w] = ~0u;
          s.mv[j][w] = 0u;
        }
        s.score[j] = m[j];
        s.best[j] = m[j];  // the virtual position 0
        s.cnt[j] = 1;
      }
      const uint8_t* row = a.reads + r * a.L;
      const int n = steps_of(a, r);
      int t = 0;
      if (a.vec) {
        for (; t + 16 <= n; t += 16) {
          uint4 v = __ldg(reinterpret_cast<const uint4*>(row + t));
          // four codes a word; the words move down after each four
#pragma unroll
          for (int g = 0; g < 4; ++g) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint32_t c = min(__byte_perm(v.x, 0u, 0x4440u + j), cmax);
              step<W, K>(mine + c * kRow, s);
            }
            v.x = v.y;
            v.y = v.z;
            v.z = v.w;
          }
        }
      }
      for (; t < n; ++t) {
        const uint32_t c = min(static_cast<uint32_t>(row[t]), cmax);
        step<W, K>(mine + c * kRow, s);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (s.best[j] == m[j]) --s.cnt[j];  // the virtual position 0
        const int v = s.best[j] <= a.max_e ? s.cnt[j] : 0;
        if (a.sums) {
          total[j] += static_cast<unsigned long long>(v);
        } else {
          const int64_t p = p0 + lane * K + j;
          if (p < a.P) a.out[r * a.P + p] = v;
        }
      }
    }
  }
  if (a.sums) {
    // the 8 warps' totals a pattern, then one atomic a pattern
    auto* red = reinterpret_cast<unsigned long long*>(
        smem + ((n_tab * 4 + 15) / 16) * 4);
#pragma unroll
    for (int j = 0; j < K; ++j) red[warp * kTile + lane * K + j] = total[j];
    __syncthreads();
    for (int q = threadIdx.x; q < np; q += kThreads) {
      unsigned long long v = 0ull;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) v += red[k * kTile + q];
      if (v) atomicAdd(a.sums + p0 + q, v);
    }
  }
}

// ---- the scratch form (W > kRegWords, or a table past shared memory) ---

// the word masks of a pattern of m bases (right-aligned): its bits in
// word w, and its top bit when word w holds it
__device__ __forceinline__ uint32_t word_full(int m, int w) {
  const int nb = m - 32 * w;
  return nb >= 32 ? ~0u : (nb <= 0 ? 0u : (1u << nb) - 1u);
}

__device__ __forceinline__ uint32_t word_top(int m, int w) {
  return (m >= 1 && (m - 1) / 32 == w) ? 1u << ((m - 1) % 32) : 0u;
}

// one word of a step, words taken low to high: the ripple carry of
// (eq & pv) + pv and the top bits of the lower word's ph, mh ride along
struct Ripple {
  uint32_t carry = 0u, ph_top = 0u, mh_top = 0u;
  int inc = 0, dec = 0;
};

__device__ __forceinline__ void word_step(uint32_t eq, uint32_t full,
                                          uint32_t top, uint32_t& pv,
                                          uint32_t& mv, Ripple& k) {
  const uint32_t xv = eq | mv;
  const uint32_t a = eq & pv;
  const uint32_t s1 = a + pv;
  const uint32_t s = s1 + k.carry;
  k.carry = (s1 < a || s < s1) ? 1u : 0u;
  const uint32_t xh = (s ^ pv) | eq;
  const uint32_t ph = mv | ~(xh | pv);
  const uint32_t mh = pv & xh;
  k.inc |= (ph & top) != 0u;
  k.dec |= (mh & top) != 0u;
  const uint32_t ph2 = (ph << 1) | k.ph_top;
  const uint32_t mh2 = (mh << 1) | k.mh_top;
  k.ph_top = ph >> 31;
  k.mh_top = mh >> 31;
  pv = (mh2 | ~(xv | ph2)) & full;
  mv = ph2 & xv;
}

__global__ void __launch_bounds__(kThreads) myers_scratch(Args a) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * a.tile + threadIdx.x;
  const int64_t r = static_cast<int64_t>(blockIdx.y) * blockDim.y +
                    threadIdx.y;
  if (p >= a.P || r >= a.R) return;
  const int64_t lanes = a.R * a.P;
  const int64_t lane = r * a.P + p;
  uint32_t* pvs = a.scratch + lane;
  uint32_t* mvs = a.scratch + a.W * lanes + lane;
  const int m = a.pat_len[p];
  for (int w = 0; w < a.W; ++w) {
    pvs[w * lanes] = word_full(m, w);
    mvs[w * lanes] = 0u;
  }
  int score = m, best = kBest0, cnt = 0;
  const uint8_t* row = a.reads + r * a.L;
  const uint32_t* peq = a.peq + p * a.W * a.n_alpha;
  const int n = steps_of(a, r);
  for (int t = 0; t < n; ++t) {
    const int c = row[t];
    Ripple k;
    for (int w = 0; w < a.W; ++w) {
      const uint32_t eq = c < a.n_alpha ? __ldg(peq + w * a.n_alpha + c) : 0u;
      uint32_t pv = pvs[w * lanes], mv = mvs[w * lanes];
      word_step(eq, word_full(m, w), word_top(m, w), pv, mv, k);
      pvs[w * lanes] = pv;
      mvs[w * lanes] = mv;
    }
    score += k.inc - k.dec;
    cnt = score < best ? 1 : cnt + (score == best);
    best = min(best, score);
  }
  const int v = best <= a.max_e ? cnt : 0;
  if (a.sums) {
    if (v) atomicAdd(a.sums + p, static_cast<unsigned long long>(v));
  } else {
    a.out[lane] = v;
  }
}

// ---- the launch plan ----------------------------------------------------

using Kernel = void (*)(Args);
const Kernel kRegs[kRegWords] = {
    myers_regs<1>, myers_regs<2>, myers_regs<3>, myers_regs<4>,
    myers_regs<5>, myers_regs<6>, myers_regs<7>, myers_regs<8>};

size_t regs_smem_of(int W, int n_alpha, bool sums) {
  switch (W) {
    case 1: return regs_smem<1>(n_alpha, sums);
    case 2: return regs_smem<2>(n_alpha, sums);
    case 3: return regs_smem<3>(n_alpha, sums);
    case 4: return regs_smem<4>(n_alpha, sums);
    case 5: return regs_smem<5>(n_alpha, sums);
    case 6: return regs_smem<6>(n_alpha, sums);
    case 7: return regs_smem<7>(n_alpha, sums);
    default: return regs_smem<8>(n_alpha, sums);
  }
}

constexpr int patterns_of(int W) {
  return W == 1 ? kPatterns<1> : (W <= 4 ? kPatterns<2> : 1);
}

struct Plan {
  bool regs;            // myers_regs<W>, else myers_scratch
  size_t smem;          // dynamic shared memory a block
  int patterns;         // a thread (myers_regs) or a block (scratch)
  int reads_a_warp;     // myers_regs
  dim3 grid, block;
  int blocks_per_sm, sms;
  int64_t scratch_bytes;
};

// the device's SM count and opt-in shared memory a block, cached
cudaError_t device_limits(int* sms, int* optin) {
  static int cached[kMaxDevices][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev][0] > 0) {
    *sms = cached[dev][0];
    *optin = cached[dev][1];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices) {
    cached[dev][0] = *sms;
    cached[dev][1] = *optin;
  }
  return cudaSuccess;
}

cudaError_t plan_of(const Args& a, bool sums, Plan* pl) {
  if (a.n_alpha < 0 || a.n_alpha > 256 || a.W < 1 || a.L < 0 ||
      a.L > INT32_MAX || a.R < 0 || a.P < 0)
    return cudaErrorInvalidValue;
  int sms = 0, optin = 0;
  cudaError_t err = device_limits(&sms, &optin);
  if (err != cudaSuccess) return err;
  *pl = Plan{};
  pl->sms = sms;
  if (a.W <= kRegWords) {
    pl->smem = regs_smem_of(a.W, a.n_alpha, sums);
    pl->regs = pl->smem <= static_cast<size_t>(optin);
  }
  if (pl->regs) {
    const Kernel fn = kRegs[a.W - 1];
    if (pl->smem > kDefaultSmem) {
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(pl->smem));
      if (err != cudaSuccess) return err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &pl->blocks_per_sm, fn, kThreads, pl->smem);
    if (err != cudaSuccess) return err;
    if (pl->blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
    pl->patterns = patterns_of(a.W);
    const int64_t tile = 32 * pl->patterns;
    const int64_t tiles = (a.P + tile - 1) / tile;
    // about four waves of the card, each warp at most kMaxReads reads;
    // more when the read axis would pass the grid's 65,535 rows
    const int64_t want = 4LL * sms * pl->blocks_per_sm;
    int64_t rw = tiles * a.R / (kWarps * want);
    rw = rw < 1 ? 1 : (rw > kMaxReads ? kMaxReads : rw);
    const int64_t floor_rw = (a.R + kWarps * 65535LL - 1) / (kWarps * 65535LL);
    if (rw < floor_rw) rw = floor_rw;
    if (rw > INT32_MAX || tiles > INT32_MAX) return cudaErrorInvalidValue;
    pl->reads_a_warp = static_cast<int>(rw);
    const int64_t ny = (a.R + kWarps * rw - 1) / (kWarps * rw);
    pl->grid = dim3(static_cast<unsigned>(tiles),
                    static_cast<unsigned>(ny < 1 ? 1 : ny));
    pl->block = dim3(kThreads);
    return cudaSuccess;
  }
  pl->patterns = kMaxTile;
  pl->block = dim3(kMaxTile, kThreads / kMaxTile);
  const int64_t nbp = (a.P + kMaxTile - 1) / kMaxTile;
  const int64_t nbr = (a.R + pl->block.y - 1) / pl->block.y;
  if (nbp > INT32_MAX || nbr > 65535) return cudaErrorInvalidValue;
  pl->grid = dim3(static_cast<unsigned>(nbp),
                  static_cast<unsigned>(nbr < 1 ? 1 : nbr));
  pl->scratch_bytes = 2LL * a.W * a.R * a.P * 4;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &pl->blocks_per_sm, myers_scratch, kThreads, 0);
  return err;
}

int launch(Args a, cudaStream_t s) {
  if (a.R <= 0 || a.P <= 0) return cudaSuccess;
  Plan pl;
  cudaError_t err = plan_of(a, a.sums != nullptr, &pl);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  if (pl.regs) {
    a.reads_a_warp = pl.reads_a_warp;
    a.vec = a.L % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.reads) % 16 == 0;
    err = cudaLaunchKernel(reinterpret_cast<const void*>(kRegs[a.W - 1]),
                           pl.grid, pl.block, args, pl.smem, s);
  } else {
    if (a.scratch == nullptr) return cudaErrorInvalidValue;
    a.tile = pl.patterns;
    err = cudaLaunchKernel(reinterpret_cast<const void*>(myers_scratch),
                           pl.grid, pl.block, args, 0, s);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Args args_of(const void* peq, const void* pat_len, const void* reads,
             const void* read_len, int64_t R, int64_t P, int64_t L,
             int n_alpha, int W, int max_e, void* scratch, void* out,
             void* sums) {
  Args a{};
  a.peq = static_cast<const uint32_t*>(peq);
  a.pat_len = static_cast<const int32_t*>(pat_len);
  a.reads = static_cast<const uint8_t*>(reads);
  a.read_len = static_cast<const int32_t*>(read_len);
  a.R = R;
  a.P = P;
  a.L = L;
  a.n_alpha = n_alpha;
  a.W = W;
  a.max_e = max_e;
  a.scratch = static_cast<uint32_t*>(scratch);
  a.out = static_cast<int32_t*>(out);
  a.sums = static_cast<unsigned long long*>(sums);
  return a;
}

}  // namespace

// The launch a call of R reads x P patterns of W words would make on the
// current device (sums != 0: the sum form): out int64[9] = form (1
// myers_regs, 0 myers_scratch), scratch bytes the caller allocates (0
// for myers_regs), patterns a thread (a block for myers_scratch), reads
// a warp, grid x, grid y, dynamic shared memory, blocks a SM, registers
// a thread.
extern "C" int ktt_myers_shape(int64_t R, int64_t P, int n_alpha, int W,
                               int sums, void* out) {
  Args a = args_of(nullptr, nullptr, nullptr, nullptr, R < 1 ? 1 : R,
                   P < 1 ? 1 : P, 0, n_alpha, W, 0, nullptr, nullptr,
                   nullptr);
  Plan pl;
  cudaError_t err = plan_of(a, sums != 0, &pl);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(
      &attr, pl.regs ? reinterpret_cast<const void*>(kRegs[W - 1])
                     : reinterpret_cast<const void*>(myers_scratch));
  if (err != cudaSuccess) return err;
  auto* o = static_cast<int64_t*>(out);
  o[0] = pl.regs;
  o[1] = pl.regs || R < 1 || P < 1 ? 0 : 2LL * W * R * P * 4;
  o[2] = pl.patterns;
  o[3] = pl.reads_a_warp;
  o[4] = pl.grid.x;
  o[5] = pl.grid.y;
  o[6] = static_cast<int64_t>(pl.smem);
  o[7] = pl.blocks_per_sm;
  o[8] = attr.numRegs;
  return cudaSuccess;
}

// One word a pattern.  peq: uint32[P][n_alpha] (0 <= n_alpha <= 256);
// pat_len: int32[P]; reads: uint8[R][L]; read_len: int32[R]; out:
// int32[R][P].  Launches nothing when R or P is 0.
extern "C" int ktt_myers(const void* peq, const void* pat_len,
                         const void* reads, const void* read_len, int64_t R,
                         int64_t P, int64_t L, int n_alpha, int max_e,
                         void* out, void* stream) {
  return launch(args_of(peq, pat_len, reads, read_len, R, P, L, n_alpha, 1,
                        max_e, nullptr, out, nullptr),
                static_cast<cudaStream_t>(stream));
}

// W = n_words words a pattern.  peq: uint32[P][W][n_alpha]; scratch:
// uint32[2][W][R * P] when ktt_myers_shape says so, else unused; the rest
// as ktt_myers.
extern "C" int ktt_myers_multiword(const void* peq, const void* pat_len,
                                   const void* reads, const void* read_len,
                                   int64_t R, int64_t P, int64_t L,
                                   int n_alpha, int n_words, int max_e,
                                   void* scratch, void* out, void* stream) {
  return launch(args_of(peq, pat_len, reads, read_len, R, P, L, n_alpha,
                        n_words, max_e, scratch, out, nullptr),
                static_cast<cudaStream_t>(stream));
}

// ktt_myers summed over the reads: sums: int64[P], each pattern's counts
// added to it (the caller zeroes it once and keeps it across batches).
extern "C" int ktt_myers_sums(const void* peq, const void* pat_len,
                              const void* reads, const void* read_len,
                              int64_t R, int64_t P, int64_t L, int n_alpha,
                              int max_e, void* sums, void* stream) {
  return launch(args_of(peq, pat_len, reads, read_len, R, P, L, n_alpha, 1,
                        max_e, nullptr, nullptr, sums),
                static_cast<cudaStream_t>(stream));
}

// ktt_myers_multiword summed over the reads into sums: int64[P].
extern "C" int ktt_myers_multiword_sums(const void* peq, const void* pat_len,
                                        const void* reads,
                                        const void* read_len, int64_t R,
                                        int64_t P, int64_t L, int n_alpha,
                                        int n_words, int max_e,
                                        void* scratch, void* sums,
                                        void* stream) {
  return launch(args_of(peq, pat_len, reads, read_len, R, P, L, n_alpha,
                        n_words, max_e, scratch, nullptr, sums),
                static_cast<cudaStream_t>(stream));
}
