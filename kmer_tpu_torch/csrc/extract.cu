// Fused k-mer extraction: ASCII block -> sentinelized hash64 keys.
//
// Replaces the Pallas kernel kmer_tpu/kernels/extract_tpu.py:111
// (_extract_kernel, reached via extract_hashed_tpu).  Per flat position
// i: the canonical k-mer ending at i (min of the 2-bit forward word, base
// i least significant, and the reverse complement, base i most
// significant), hashed by hash64 mod 2^(2k), written as a biased int64
// key (key ^ 2^63, see kernels/keys.py); INT64_MAX (the biased all-ones
// sentinel) when the window holds a non-ACGTU byte or i < k-1.  k = 32
// collapses every canonical key to 0 (the reference's x86 mask).  Also
// counts the valid lanes, exactly, over the whole input.
//
// Two forms share one kernel:
//   ktt_extract       one key per input position (the flat plane);
//   ktt_extract_rows  uniform-length reads, row_bytes = L + 1 bytes a
//                     read: only in-row offsets k-1 .. row_bytes-2 of the
//                     first n / row_bytes rows are written, packed row by
//                     row (row_bytes - k keys a row): the plane that
//                     pipeline/counter.py used to cut out of the flat one
//                     with a slice and a copy.  The valid count still
//                     covers every input position.
//
// Bound on the H100: each lane reads 1 byte and writes 8, 27 us for a
// 10 Mbase block at 3.35 TB/s; the hash alone is some 30 integer
// instructions a lane, and at 132 SMs x 4 warp-issues a clock every 10
// instructions a lane cost about 3 us on such a block, so the issue side
// binds unless the rest of a lane stays near the hash.  The first port
// rebuilt each lane's k-base window from shared memory, k steps of
// 64-bit shifts a lane, and took 13x the byte bound.
//
// Design: no per-lane window loop and no per-lane variable shift.  A
// block of 256 threads owns 4096 positions.  Its threads load 16 bytes
// each (260 words: the block, a 32-byte left halo and 32 spare bytes)
// and pack them through a 256-entry shared table into one 32-bit word of
// 2-bit codes (16 positions in order, base 16w + m at bits 2m) and one
// of "not a base" pairs.  Any 32 consecutive positions are then three
// words and two 32-bit funnel shifts, and the shift is the same for all
// of a thread's positions (t, t + 256, ...: a warp's stores are 256
// contiguous bytes).  With W_end the 32 positions ending at i and
// W_start the 32 starting at i - k + 1:
//   fwd   = pair_reverse(W_end) & (4^k - 1)   (bit reversal, pairs kept)
//   rev   = ~W_start & (4^k - 1)              (complement, base i on top)
//   valid = (invalid pairs of W_start & (4^k - 1)) == 0
// The rows form walks (row, column) by constant steps and skips the hash
// where the column is not kept.  The valid count is a warp ballot, a
// block sum and one integer atomicAdd per block (the TPU kernel's SMEM
// accumulator, extract_tpu.py:115-117,210-214).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;
constexpr int kBlock = kThreads * kPerThread;  // positions a block owns
constexpr int kHalo = 32;                       // >= k - 1, word-aligned
// staged positions: the halo, the block, and 32 spare positions, since
// the window starting at the last position (k = 1) reaches 31 past it
// and a window read takes one word more
constexpr int kWords = (kHalo + kBlock + 32) / 16;  // 16 positions each
constexpr uint64_t kTop = 1ull << 63;
constexpr uint32_t kLowBits = 0x55555555u;

// hash64 (kmer_tpu/kernels/hash64.py) with its shift-and-add steps
// written as the products they are, mod 2^64 like the shifts:
// ~x + (x << 21) = x (2^21 - 1) - 1, x + (x << 3) + (x << 8) = 265 x,
// x + (x << 2) + (x << 4) = 21 x, x + (x << 31) = (2^31 + 1) x.
__device__ __forceinline__ uint64_t hash64(uint64_t key, uint64_t mask) {
  key = (key * 0x1FFFFFull - 1) & mask;
  key = key ^ key >> 24;
  key = (key * 265) & mask;
  key = key ^ key >> 14;
  key = (key * 21) & mask;
  key = key ^ key >> 28;
  key = (key * 0x80000001ull) & mask;
  return key;
}

// The order of the 32 two-bit groups reversed, each group kept as it is.
__device__ __forceinline__ uint64_t pair_reverse(uint32_t lo, uint32_t hi) {
  const uint32_t a = __brev(hi), b = __brev(lo);  // a: the new low word
  return (static_cast<uint64_t>(((b >> 1) & kLowBits) | ((b & kLowBits) << 1))
          << 32) |
         (((a >> 1) & kLowBits) | ((a & kLowBits) << 1));
}

// 64 plane bits: the 32 positions from staged word a, bit offset off
// (0..30), on.
struct Win {
  uint32_t lo, hi;
};
__device__ __forceinline__ Win window(const uint32_t* plane, int a, int off) {
  const uint32_t w0 = plane[a], w1 = plane[a + 1], w2 = plane[a + 2];
  return {__funnelshift_r(w0, w1, off), __funnelshift_r(w1, w2, off)};
}

__device__ __forceinline__ uint64_t bits(Win w) {
  return (static_cast<uint64_t>(w.hi) << 32) | w.lo;
}

template <bool kRows>
__global__ void __launch_bounds__(kThreads)
extract_kernel(const uint8_t* __restrict__ ascii, int64_t n, int k,
               int row_bytes, int n_rows, int64_t* __restrict__ keys,
               unsigned long long* __restrict__ n_valid) {
  // base x -> code | 0xC when x is not a base (the "invalid" pair)
  __shared__ uint8_t lut[256];
  __shared__ uint32_t codes[kWords], invalid[kWords];
  __shared__ unsigned warp_valid[kWarps];
  __shared__ int row0, col0;  // rows form: row and column of position base
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlock;
  const int64_t first = base - kHalo;  // the position of staged word 0
  static_assert(kThreads == 256, "one table entry a thread");
  {
    const unsigned x = threadIdx.x, up = x & 0xDF;
    const unsigned g = (x >> 1) & 3;
    const bool ok = up == 'A' || up == 'C' || up == 'G' || up == 'T' ||
                    up == 'U';
    lut[x] = static_cast<uint8_t>((g ^ (g >> 1)) | (ok ? 0 : 0xC));
  }
  if (kRows && threadIdx.x == 0) {
    row0 = static_cast<int>(base / row_bytes);
    col0 = static_cast<int>(base - static_cast<int64_t>(row0) * row_bytes);
  }
  __syncthreads();  // the table
  const bool aligned = (reinterpret_cast<uintptr_t>(ascii) & 15) == 0;
  for (int w = threadIdx.x; w < kWords; w += kThreads) {
    // word w: 16 bytes, those outside [0, n) read as 0
    uint32_t x[4] = {0, 0, 0, 0};
    const int64_t p16 = first + 16 * w;
    if (aligned && p16 >= 0 && p16 + 16 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(ascii + p16);
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    } else {
      for (int j = 0; j < 16; ++j)
        if (p16 + j >= 0 && p16 + j < n)
          x[j >> 2] |= static_cast<uint32_t>(ascii[p16 + j]) << (8 * (j & 3));
    }
    uint32_t cw = 0, iw = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t e = lut[(x[j >> 2] >> (8 * (j & 3))) & 0xFF];
      cw |= (e & 3) << (2 * j);
      iw |= (e >> 2) << (2 * j);
    }
    codes[w] = cw;
    invalid[w] = iw;
  }
  __syncthreads();

  const uint64_t mask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  // the windows of position p = t + 256 j start at staged positions
  // p + 1 (ending at i) and p + 33 - k (starting at i - k + 1): word
  // a + 16 j, the same bit offset for every j
  const int s_end = threadIdx.x + 1, s_start = threadIdx.x + kHalo + 1 - k;
  const int a_end = s_end >> 4, off_end = 2 * (s_end & 15);
  const int a_start = s_start >> 4, off_start = 2 * (s_start & 15);
  // rows form: (row, column) of position base + t, and the step to
  // position base + t + 256
  const int kept = row_bytes - k;  // keys a row
  int row = 0, col = 0, d_row = 0, d_col = 0;
  if (kRows) {
    const int c0 = col0 + threadIdx.x;
    row = row0 + c0 / row_bytes;
    col = c0 % row_bytes;
    d_row = kThreads / row_bytes;
    d_col = kThreads % row_bytes;
  }
  unsigned count = 0;  // this warp's valid lanes

  // position base + t + 256 j, which lies in [0, n) when in_range
  auto position = [&](int j, bool in_range) {
    bool valid = false;
    if (in_range) {
      const uint64_t bad = bits(window(invalid, a_start + 16 * j, off_start));
      valid = (bad & mask) == 0;
      int64_t out = base + threadIdx.x + j * kThreads;
      bool keep = true;
      if (kRows) {
        keep = row < n_rows && col >= k - 1 && col < row_bytes - 1;
        out = static_cast<int64_t>(row) * kept + (col - (k - 1));
      }
      if (keep) {
        uint64_t canon = 0;
        if (k < 32) {
          const Win we = window(codes, a_end + 16 * j, off_end);
          const uint64_t fwd = pair_reverse(we.lo, we.hi) & mask;
          const uint64_t rev =
              ~bits(window(codes, a_start + 16 * j, off_start)) & mask;
          canon = fwd < rev ? fwd : rev;
        }
        keys[out] = valid ? static_cast<int64_t>(hash64(canon, mask) ^ kTop)
                          : INT64_MAX;
      }
    }
    if (kRows) {
      row += d_row;
      col += d_col;
      if (col >= row_bytes) {
        col -= row_bytes;
        ++row;
      }
    }
    count += __popc(__ballot_sync(0xffffffffu, valid));
  };
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    position(j, base + threadIdx.x + j * kThreads < n);
  if (lane == 0) warp_valid[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_valid[w];
    if (s) atomicAdd(n_valid, static_cast<unsigned long long>(s));
  }
}

template <bool kRows>
int launch(const void* ascii, int64_t n, int k, int row_bytes, void* keys,
           void* n_valid, void* stream) {
  if (n > 0) {
    const int64_t blocks = (n + kBlock - 1) / kBlock;
    extract_kernel<kRows><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(ascii), n, k, row_bytes,
        kRows ? static_cast<int>(n / row_bytes) : 0,
        static_cast<int64_t*>(keys),
        static_cast<unsigned long long*>(n_valid));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Positions a thread handles (the static SASS count / this = the
// instructions a position).
extern "C" int ktt_extract_per_thread() { return kPerThread; }

// keys: int64[n]; n_valid: int64 scalar, zeroed by the caller.
extern "C" int ktt_extract(const void* ascii, int64_t n, int k, void* keys,
                           void* n_valid, void* stream) {
  return launch<false>(ascii, n, k, 0, keys, n_valid, stream);
}

// k < row_bytes, n / row_bytes < 2^31;
// keys: int64[(n / row_bytes) * (row_bytes - k)];
// n_valid: int64 scalar, zeroed by the caller.
extern "C" int ktt_extract_rows(const void* ascii, int64_t n, int k,
                                int row_bytes, void* keys, void* n_valid,
                                void* stream) {
  return launch<true>(ascii, n, k, row_bytes, keys, n_valid, stream);
}
