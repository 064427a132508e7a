// The one-lane form of csrc/myers.cu, kept whole as a yardstick:
// chip_smoke.py phase 3 and scripts/tune_myers.py build it into a library
// of its own and time its (R, P) entries in turns with the kernel.
//
// Myers bit-vector approximate matching in HW (infix) mode: for every
// (read, pattern) lane, the best edit distance over all end positions in
// the read and how many end positions reach it (edlib's numLocations),
// returned where best <= max_e, else 0.
//
// Replaces the `lax.scan` of kmer_tpu/kernels/myers.py:50
// (myers_hw_counts, one 32-bit word a pattern) and :134
// (myers_hw_counts_multiword, W words with ripple carries); neither is a
// Pallas kernel: XLA compiles each into one on-device loop over text
// positions.  The port's plain versions (kernels/myers.py
// myers_hw_counts{,_multiword}_plain) run the same loop from the host,
// some 30 elementwise launches a text position, each a pass over the
// (reads x patterns) int32 state in device memory.
//
// Bound on the H100: integer operations.  A lane-step (one read base
// against one pattern) is about 29 32-bit operations for one word (the
// Peq row, the Hyyro recurrence, the score, the best / count update) and
// 25 more a further word that the pattern spans (its own recurrence, the
// carry in and out, the top bits shifted across words);
// a lane reads nothing else but its read's code.  A batch of 2,048
// 150-base reads against 2,000 patterns is 6.1e8 lane-steps, ~18 GOP,
// against 4 MB of codes in and 16 MB of counts out.
//
// Design: the state never leaves registers.  One thread a (read,
// pattern) lane; a block of 256 threads is `tile` consecutive patterns
// (threadIdx.x) x 256 / tile reads (threadIdx.y), so a warp (tile >= 32)
// holds 32 consecutive patterns of one read: the read's code at step t
// is one broadcast load, the loop bound min(read_len, L) is uniform in
// the warp, and the (R, P) counts are written coalesced, once.  pv, mv
// (W words each), score, best and cnt stay in registers for the whole
// read; steps past the read's end are not run (they change nothing).
// The block first stages its patterns' Peq columns in shared memory as
// tab[w][code][q], n_alpha + 1 rows a word: the last row is zero, and
// every read code >= n_alpha (the catch-all, the 255 fill) reads it, so
// it matches nothing and no Peq is read out of bounds.  tile is the
// largest power of two <= 64 whose table fits in 48 KB (no opt-in
// attribute; W <= 8 and n_alpha <= 256 leave tile >= 4).  The grid puts
// the larger of the two block counts on gridDim.x.
//
// myers_regs<W> keeps the W words in registers for W <= kRegWords (256
// bases).  A wider W runs myers_scratch: the same recurrence with pv and
// mv in a scratch plane [2][W][R * P] that the caller allocates (lanes
// adjacent in a warp are adjacent there), Peq read from device memory.
//
// All bit-vector arithmetic is uint32_t: `+` wraps at 32 bits, a carry
// out of a word is s1 < a || s < s1 (unsigned), shifts are logical.  No
// shift reaches 32: a word's mask is ~0u at 32 bits, and a pattern's top
// bit (word (m - 1) / 32, bit (m - 1) % 32) exists only for 1 <= m <=
// 32 W; m = 0 has no top bit and empty masks, as in the plain version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 64;
constexpr int kSmemBytes = 48 * 1024;
constexpr int kRegWords = 8;
constexpr int kBest0 = 0x3FFFFFFF;

struct Args {
  const uint32_t* peq;      // [P][W][n_alpha]
  const int32_t* pat_len;   // [P]
  const uint8_t* reads;     // [R][L] codes
  const int32_t* read_len;  // [R]
  int64_t R, P, L;
  int n_alpha, W, tile;
  bool p_on_x;              // pattern tiles on gridDim.x
  int max_e;
  uint32_t* scratch;        // [2][W][R * P] (myers_scratch only)
  int32_t* out;             // [R][P]
};

// the word masks of a pattern of m bases: its bits in word w, and its top
// bit when word w holds it
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

__device__ __forceinline__ void score_step(const Ripple& k, int& score,
                                           int& best, int& cnt) {
  score += k.inc - k.dec;
  if (score < best) {
    best = score;
    cnt = 1;
  } else if (score == best) {
    ++cnt;
  }
}

// this thread's lane: (r, p), or false past the batch's edge
__device__ __forceinline__ bool lane_of(const Args& a, int64_t& r,
                                        int64_t& p, int64_t& p0) {
  const int64_t pb = a.p_on_x ? blockIdx.x : blockIdx.y;
  const int64_t rb = a.p_on_x ? blockIdx.y : blockIdx.x;
  p0 = pb * a.tile;
  p = p0 + threadIdx.x;
  r = rb * blockDim.y + threadIdx.y;
  return p < a.P && r < a.R;
}

__device__ __forceinline__ int steps_of(const Args& a, int64_t r) {
  const int64_t n = a.read_len[r];
  return static_cast<int>(n < 0 ? 0 : (n < a.L ? n : a.L));
}

template <int W>
__global__ void __launch_bounds__(kThreads) myers_regs(Args a) {
  extern __shared__ uint32_t tab[];  // [W][n_alpha + 1][tile]
  int64_t r, p, p0;
  const bool mine = lane_of(a, r, p, p0);
  // stage the block's Peq columns: one contiguous run of device memory
  const int rows = a.n_alpha + 1;
  const int span = W * a.n_alpha;
  const int64_t left = a.P - p0;
  const int np = left < a.tile ? static_cast<int>(left) : a.tile;
  const int me = threadIdx.y * blockDim.x + threadIdx.x;
  const uint32_t* src = a.peq + p0 * span;
  for (int i = me; i < np * span; i += kThreads) {
    const int q = i / span;
    const int rest = i - q * span;
    const int w = rest / a.n_alpha;
    const int code = rest - w * a.n_alpha;
    tab[(w * rows + code) * a.tile + q] = src[i];
  }
  for (int i = me; i < W * a.tile; i += kThreads) {
    const int w = i / a.tile;
    tab[(w * rows + a.n_alpha) * a.tile + (i - w * a.tile)] = 0u;
  }
  __syncthreads();
  if (!mine) return;

  const int m = a.pat_len[p];
  uint32_t full[W], top[W], pv[W], mv[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    full[w] = word_full(m, w);
    top[w] = word_top(m, w);
    pv[w] = full[w];
    mv[w] = 0u;
  }
  int score = m, best = kBest0, cnt = 0;
  const uint8_t* row = a.reads + r * a.L;
  const uint32_t* col = tab + threadIdx.x;
  const uint32_t cmax = static_cast<uint32_t>(a.n_alpha);
  const int n = steps_of(a, r);
  for (int t = 0; t < n; ++t) {
    uint32_t c = row[t];
    c = c < cmax ? c : cmax;
    Ripple k;
#pragma unroll
    for (int w = 0; w < W; ++w)
      word_step(col[(w * rows + c) * a.tile], full[w], top[w], pv[w],
                mv[w], k);
    score_step(k, score, best, cnt);
  }
  a.out[r * a.P + p] = best <= a.max_e ? cnt : 0;
}

__global__ void __launch_bounds__(kThreads) myers_scratch(Args a) {
  int64_t r, p, p0;
  if (!lane_of(a, r, p, p0)) return;
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
    score_step(k, score, best, cnt);
  }
  a.out[lane] = best <= a.max_e ? cnt : 0;
}

int launch(Args a, cudaStream_t s) {
  if (a.R <= 0 || a.P <= 0) return cudaSuccess;
  if (a.n_alpha < 0 || a.n_alpha > 256 || a.W < 1 || a.L < 0 ||
      a.L > INT32_MAX)
    return cudaErrorInvalidValue;
  size_t smem = 0;
  a.tile = kMaxTile;
  if (a.W <= kRegWords) {
    const size_t per = static_cast<size_t>(a.W) * (a.n_alpha + 1) * 4;
    while (a.tile > 1 && per * a.tile > kSmemBytes) a.tile /= 2;
    smem = per * a.tile;
  }
  const dim3 block(a.tile, kThreads / a.tile);
  const int64_t nbp = (a.P + a.tile - 1) / a.tile;
  const int64_t nbr = (a.R + block.y - 1) / block.y;
  a.p_on_x = nbp >= nbr;
  const int64_t nx = a.p_on_x ? nbp : nbr;
  const int64_t ny = a.p_on_x ? nbr : nbp;
  if (nx > INT32_MAX || ny > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(nx), static_cast<unsigned>(ny));
  switch (a.W) {
    case 1: myers_regs<1><<<grid, block, smem, s>>>(a); break;
    case 2: myers_regs<2><<<grid, block, smem, s>>>(a); break;
    case 3: myers_regs<3><<<grid, block, smem, s>>>(a); break;
    case 4: myers_regs<4><<<grid, block, smem, s>>>(a); break;
    case 5: myers_regs<5><<<grid, block, smem, s>>>(a); break;
    case 6: myers_regs<6><<<grid, block, smem, s>>>(a); break;
    case 7: myers_regs<7><<<grid, block, smem, s>>>(a); break;
    case 8: myers_regs<8><<<grid, block, smem, s>>>(a); break;
    default: myers_scratch<<<grid, block, 0, s>>>(a); break;
  }
  return cudaGetLastError();
}

}  // namespace

// One word a pattern.  peq: uint32[P][n_alpha] (0 <= n_alpha <= 256);
// pat_len: int32[P]; reads: uint8[R][L]; read_len: int32[R]; out:
// int32[R][P].  Launches nothing when R or P is 0.
extern "C" int ktt_myers(const void* peq, const void* pat_len,
                         const void* reads, const void* read_len, int64_t R,
                         int64_t P, int64_t L, int n_alpha, int max_e,
                         void* out, void* stream) {
  return launch(Args{static_cast<const uint32_t*>(peq),
                     static_cast<const int32_t*>(pat_len),
                     static_cast<const uint8_t*>(reads),
                     static_cast<const int32_t*>(read_len), R, P, L, n_alpha,
                     1, 0, false, max_e, nullptr, static_cast<int32_t*>(out)},
                static_cast<cudaStream_t>(stream));
}

// W = n_words words a pattern.  peq: uint32[P][W][n_alpha]; scratch:
// uint32[2][W][R * P] when W > kRegWords, else unused; the rest as
// ktt_myers.
extern "C" int ktt_myers_multiword(const void* peq, const void* pat_len,
                                   const void* reads, const void* read_len,
                                   int64_t R, int64_t P, int64_t L,
                                   int n_alpha, int n_words, int max_e,
                                   void* scratch, void* out, void* stream) {
  return launch(Args{static_cast<const uint32_t*>(peq),
                     static_cast<const int32_t*>(pat_len),
                     static_cast<const uint8_t*>(reads),
                     static_cast<const int32_t*>(read_len), R, P, L, n_alpha,
                     n_words, 0, false, max_e,
                     static_cast<uint32_t*>(scratch),
                     static_cast<int32_t*>(out)},
                static_cast<cudaStream_t>(stream));
}
