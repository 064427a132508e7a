// A streaming gzip/DEFLATE decoder (RFC 1951/1952) for the block reader,
// written for its input: gzipped FASTA/FASTQ, in one stream or in
// full-flush pieces.  See gzinflate.h for what it serves.  Reads are
// text of four letters, so even level 1 finds a match of 3-4 bases
// about every 4 bytes inside the 32 KiB window: the match path, not
// literals, sets the pace, and literal codes are long (a table entry
// holding two literals never forms on such blocks, so there is none).
//
// - A 64-bit bit buffer, refilled with one unaligned 8-byte load and no
//   branch; the fast loop runs while 64 input bytes and 320 output bytes
//   remain, with no other check per symbol, and a careful loop, one
//   symbol at a time with every check, takes the ends.
// - One lookup of the literal/length table gives a literal, or a length
//   base with its extra bits, or the end of the block; codes longer than
//   11 bits go through a sub-table.  The next lookup is made before the
//   refill and the match copy, so that they overlap.
// - Matches copy 8 bytes at a time; a distance under 8 copies a byte at
//   a time (1: a repeated byte).
// - Output goes straight into the text buffer the scanner reads, which
//   keeps the last 32 KiB as the window when it drops consumed bytes.
// - CRC32 over the output by PCLMUL folding where the CPU has it
//   (zlib's crc32 otherwise); BMI2 for the fast loop where the CPU has
//   it.  Single-thread, no setting.

#include "gzinflate.h"

#include <fcntl.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <cerrno>
#include <cstring>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define KTP_X86 1
#endif

namespace ktp {
namespace {

// gzread's buffering with gzbuffer(1 MiB): each gz_fetch decodes up to
// 2 MiB into its output buffer, starting afresh at each member, and a
// data error throws away that fetch and the whole gzread call that
// asked for it.
constexpr int64_t kCall = 1 << 20;
constexpr int64_t kFetch = 2 << 20;

constexpr size_t kRound = 1 << 20;     // output decoded per round
constexpr size_t kTextMin = 16 << 20;  // the text buffer's first size
constexpr size_t kInCap = 1 << 20;     // input bytes per top-up
constexpr size_t kPad = 64;            // zero bytes after the input
constexpr size_t kInMargin = 64;       // input the fast loop needs
constexpr size_t kOutMargin = 320;     // a 258-byte match, 16 over
constexpr size_t kWindow = 32768;

// Root bits of the tables; a complete code of 15-bit codes needs at most
// 2342 literal/length and 402 distance entries with its sub-tables at
// these roots (zlib's enough.c), and only complete codes get sub-tables.
constexpr int kLitRoot = 11, kDistRoot = 8, kClRoot = 7;
constexpr size_t kLitSize = (1 << kLitRoot) + 2048;
constexpr size_t kDistSize = (1 << kDistRoot) + 1024;

// Table entries, 64 bits:
//   [0, 8)    bits the entry consumes: a code with its extra bits
//   [8, 16)   the code's length (its extra bits start there); a
//             sub-table's index bits
//   [16, 20)  kind
//   [32, 64)  a literal; a length or distance base; a code-length
//             symbol; a sub-table's offset
enum Kind : uint32_t { kLit = 0, kVal = 1, kEob = 2, kSub = 3, kBad = 4 };

constexpr uint64_t mk(uint32_t nbits, uint32_t aux, uint32_t kind,
                      uint64_t val) {
  return nbits | (aux << 8) | (kind << 16) | (val << 32);
}
inline uint32_t nbits(uint64_t e) { return (uint8_t)e; }
inline uint32_t aux(uint64_t e) { return (uint8_t)(e >> 8); }
inline uint32_t kind(uint64_t e) { return (e >> 16) & 15; }
// base + the extra bits that follow the code
inline uint32_t value(uint64_t e, uint64_t bb) {
  return (uint32_t)(e >> 32) +
         (uint32_t)((bb & ((1ull << nbits(e)) - 1)) >> aux(e));
}
inline uint64_t lookup(const uint64_t* t, int root, uint64_t bb) {
  uint64_t e = t[bb & ((1u << root) - 1)];
  if (kind(e) == kSub)
    e = t[(e >> 32) + ((bb >> root) & ((1u << aux(e)) - 1))];
  return e;
}

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10,  11, 13,
                               15, 17, 19, 23, 27, 31, 35, 43,  51, 59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {
    1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
    33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
    1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5, 5, 6,
                                6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
const uint8_t kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                              11, 4,  12, 3, 13, 2, 14, 1, 15};

enum TableType { kClT, kLitT, kDistT };

uint64_t leaf(TableType type, int s, uint32_t len) {
  if (type == kClT) return mk(len, len, kVal, s);
  if (type == kDistT)
    return s < 30 ? mk(len + kDistExtra[s], len, kVal, kDistBase[s])
                  : mk(len, len, kBad, 0);
  if (s < 256) return mk(len, len, kLit, s);
  if (s == 256) return mk(len, len, kEob, 0);
  if (s < 286)
    return mk(len + kLenExtra[s - 257], len, kVal, kLenBase[s - 257]);
  return mk(len, len, kBad, 0);  // 286, 287: zlib's invalid codes
}

uint32_t reverse(uint32_t code, uint32_t len) {
  uint32_t r = 0;
  for (uint32_t i = 0; i < len; ++i, code >>= 1) r = (r << 1) | (code & 1);
  return r;
}

// Builds a decoding table from code lengths, accepting exactly the sets
// zlib's inflate_table accepts: no over-subscribed set, and an
// incomplete one only for literals/lengths or distances whose longest
// code is 1 bit.  A set with no code at all decodes every symbol as
// invalid, 1 bit long (zlib's marker), and is accepted.
bool build(uint64_t* t, int root, const uint8_t* lens, int n,
           TableType type) {
  uint32_t count[16] = {0};
  for (int s = 0; s < n; ++s) count[lens[s]]++;
  int max = 15;
  while (max >= 1 && count[max] == 0) --max;
  const uint32_t size = 1u << root;
  const uint64_t bad = mk(1, 1, kBad, 0);
  if (max == 0) {
    std::fill(t, t + size, bad);
    return true;
  }
  int left = 1;
  for (int len = 1; len <= 15; ++len) {
    left = (left << 1) - (int)count[len];
    if (left < 0) return false;
  }
  if (left > 0) {
    if (type == kClT || max != 1) return false;
    std::fill(t, t + size, bad);
  }
  uint32_t next[16];
  uint32_t code = 0;
  count[0] = 0;
  for (int len = 1; len <= 15; ++len) {
    code = (code + count[len - 1]) << 1;
    next[len] = code;
  }
  uint16_t rcode[288];
  for (int s = 0; s < n; ++s)
    if (lens[s]) rcode[s] = (uint16_t)reverse(next[lens[s]]++, lens[s]);
  for (int s = 0; s < n; ++s) {
    uint32_t len = lens[s];
    if (len == 0 || (int)len > root) continue;
    const uint64_t e = leaf(type, s, len);
    for (uint32_t i = rcode[s]; i < size; i += 1u << len) t[i] = e;
  }
  if (max > root) {  // sub-tables, one for each root prefix of long codes
    uint8_t longest[1 << kLitRoot] = {0};
    for (int s = 0; s < n; ++s)
      if (lens[s] > root) {
        uint8_t& m = longest[rcode[s] & (size - 1)];
        m = std::max(m, lens[s]);
      }
    uint32_t off = size;
    for (uint32_t p = 0; p < size; ++p)
      if (longest[p]) {
        uint32_t sub = longest[p] - root;
        t[p] = mk(root, sub, kSub, off);
        off += 1u << sub;
      }
    for (int s = 0; s < n; ++s) {
      uint32_t len = lens[s];
      if ((int)len <= root) continue;
      const uint64_t p = t[rcode[s] & (size - 1)];
      const uint64_t e = leaf(type, s, len);
      const uint32_t base = (uint32_t)(p >> 32), sub = 1u << aux(p);
      for (uint32_t j = rcode[s] >> root; j < sub; j += 1u << (len - root))
        t[base + j] = e;
    }
  }
  return true;
}

struct FixedTables {
  uint64_t lit[kLitSize];
  uint64_t dist[kDistSize];
  FixedTables() {
    uint8_t lens[288];
    std::fill(lens, lens + 144, 8);
    std::fill(lens + 144, lens + 256, 9);
    std::fill(lens + 256, lens + 280, 7);
    std::fill(lens + 280, lens + 288, 8);
    build(lit, kLitRoot, lens, 288, kLitT);
    std::fill(lens, lens + 32, 5);
    build(dist, kDistRoot, lens, 32, kDistT);
  }
};

const FixedTables& fixed_tables() {
  static const FixedTables t;
  return t;
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86-64, aarch64)
}
inline void store64(uint8_t* p, uint64_t v) { std::memcpy(p, &v, 8); }

// LZ77 copy of `len` bytes from `dist` back; writes up to 15 bytes past
// the end (the output margin holds them).
inline uint8_t* copy_match(uint8_t* out, uint32_t dist, uint32_t len) {
  const uint8_t* src = out - dist;
  uint8_t* dst = out;
  uint8_t* const stop = out + len;
  if (dist >= 8) {
    store64(dst, load64(src));
    store64(dst + 8, load64(src + 8));
    dst += 16;
    src += 16;
    while (dst < stop) {
      store64(dst, load64(src));
      dst += 8;
      src += 8;
    }
  } else if (dist == 1) {
    const uint64_t v = src[0] * 0x0101010101010101ull;
    do {
      store64(dst, v);
      dst += 8;
    } while (dst < stop);
  } else {
    do *dst++ = *src++;
    while (dst < stop);
  }
  return stop;
}

uint32_t crc_zlib(uint32_t crc, const uint8_t* p, size_t n) {
  while (n > 0) {
    uInt m = (uInt)std::min<size_t>(n, 1u << 30);
    crc = (uint32_t)crc32(crc, p, m);
    p += m;
    n -= m;
  }
  return crc;
}

#if defined(KTP_X86)
// CRC32 by carry-less multiplication, folding 64 bytes at a time, then
// 16 (the folding constants of the gzip polynomial, x^(512+-32) and
// x^(128+-32) mod P, bit-reflected); the last 16-byte block and the
// tail go through zlib's crc32.
#define KTP_FOLD(x, k, d)                                        \
  _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x, k, 0x00),  \
                              _mm_clmulepi64_si128(x, k, 0x11)), \
                d)

__attribute__((target("pclmul,sse4.1"))) uint32_t crc_clmul(
    uint32_t crc, const uint8_t* p, size_t n) {
  if (n < 64) return crc_zlib(crc, p, n);
  const __m128i k512 = _mm_set_epi64x(0x1c6e41596LL, 0x154442bd4LL);
  const __m128i k128 = _mm_set_epi64x(0x0ccaa009eLL, 0x1751997d0LL);
  __m128i x0 = _mm_xor_si128(_mm_loadu_si128((const __m128i*)p),
                             _mm_cvtsi32_si128((int)~crc));
  __m128i x1 = _mm_loadu_si128((const __m128i*)(p + 16));
  __m128i x2 = _mm_loadu_si128((const __m128i*)(p + 32));
  __m128i x3 = _mm_loadu_si128((const __m128i*)(p + 48));
  p += 64;
  n -= 64;
  for (; n >= 64; p += 64, n -= 64) {
    x0 = KTP_FOLD(x0, k512, _mm_loadu_si128((const __m128i*)p));
    x1 = KTP_FOLD(x1, k512, _mm_loadu_si128((const __m128i*)(p + 16)));
    x2 = KTP_FOLD(x2, k512, _mm_loadu_si128((const __m128i*)(p + 32)));
    x3 = KTP_FOLD(x3, k512, _mm_loadu_si128((const __m128i*)(p + 48)));
  }
  x0 = KTP_FOLD(x0, k128, x1);
  x0 = KTP_FOLD(x0, k128, x2);
  x0 = KTP_FOLD(x0, k128, x3);
  for (; n >= 16; p += 16, n -= 16)
    x0 = KTP_FOLD(x0, k128, _mm_loadu_si128((const __m128i*)p));
  uint8_t last[16];
  _mm_storeu_si128((__m128i*)last, x0);
  // the folded block's CRC from a zero register, then the tail
  return crc_zlib(crc_zlib(0xFFFFFFFFu, last, 16), p, n);
}
#undef KTP_FOLD
#endif

uint32_t crc_update(uint32_t crc, const uint8_t* p, size_t n) {
#if defined(KTP_X86)
  static const bool clmul =
      __builtin_cpu_supports("pclmul") && __builtin_cpu_supports("sse4.1");
  if (clmul) return crc_clmul(crc, p, n);
#endif
  return crc_zlib(crc, p, n);
}

enum Step { kGo, kEnd, kFull, kStop };

}  // namespace

struct Inflater {
  enum Phase { kLook, kHeader, kBlock, kHuff, kStored, kTrailer, kNext,
               kPlain, kDone };

  int fd;
  std::vector<char>& text;
  std::vector<uint8_t>& input;

  // input: [in, in_end) unread, kPad zero bytes after it
  const uint8_t* in;
  const uint8_t* in_end;
  bool in_eof = false;
  uint64_t bitbuf = 0;  // bits past bitcnt repeat the bytes at `in`
  uint32_t bitcnt = 0;

  // output: text[0, safe) served, [safe, end) decoded and held back
  size_t end = 0, safe = 0, crc_pos = 0;
  int64_t base = 0;     // stream offset of text[0]
  int64_t mstart = 0;   // stream offset of the member's first byte
  int64_t served = 0;   // after an error, where the stream stops
  uint32_t crc = 0, stored_left = 0;
  Phase phase = kLook;
  bool gzip = false, last = false, failed = false;

  const uint64_t* lit = nullptr;
  const uint64_t* dist = nullptr;
  uint64_t dyn_lit[kLitSize];
  uint64_t dyn_dist[kDistSize];
  uint8_t lens[320];

  Inflater(int f, std::vector<char>* t, std::vector<uint8_t>* i)
      : fd(f), text(*t), input(*i) {
    if (input.size() < kInCap + kPad) input.resize(kInCap + kPad);
    if (text.size() < kTextMin) text.resize(kTextMin);
    in = in_end = input.data();
    std::memset(input.data(), 0, kPad);
  }

  uint8_t* tb() { return reinterpret_cast<uint8_t*>(text.data()); }

  // Reads until the input buffer is full or the file ends, keeping the
  // 8 bytes before `in` (the bit buffer's, for unload()).
  void top_up() {
    uint8_t* ib = input.data();
    const size_t keep = std::min<size_t>(8, in - ib);
    const size_t live = in_end - (in - keep);
    std::memmove(ib, in - keep, live);
    in = ib + keep;
    uint8_t* e = ib + live;
    while (!in_eof && e < ib + kInCap) {
      ssize_t r = read(fd, e, ib + kInCap - e);
      if (r < 0 && errno == EINTR) continue;
      if (r <= 0) in_eof = true;  // a read error ends the stream too
      else e += r;
    }
    in_end = e;
    std::memset(e, 0, kPad);
  }

  inline void refill() {
    bitbuf |= load64(in) << bitcnt;
    in += (63 - bitcnt) >> 3;
    bitcnt |= 56;
  }
  // Refill for the careful paths: top up first when the input runs low.
  void refill_careful() {
    if (!in_eof && (size_t)(in_end - in) < kInMargin) top_up();
    refill();
  }
  // Bits of the file in the bit buffer (the rest are past its end).
  int64_t real_bits() const {
    const int64_t over = (in - in_end) * 8;
    return over > 0 ? (int64_t)bitcnt - over : (int64_t)bitcnt;
  }
  inline void consume(uint32_t n) {
    bitbuf >>= n;
    bitcnt -= n;
  }
  bool take(uint32_t n, uint32_t* v) {  // n <= 32
    refill_careful();
    if (real_bits() < n) return false;
    *v = (uint32_t)(bitbuf & ((1ull << n) - 1));
    consume(n);
    return true;
  }
  void align() { consume(bitcnt & 7); }
  // Back to byte reads: the bit buffer's whole bytes go back to `in`.
  void unload() {
    in -= bitcnt >> 3;
    bitbuf = 0;
    bitcnt = 0;
  }

  int64_t offset(const uint8_t* out) { return base + (out - tb()); }
  const uint8_t* window_floor() {
    return tb() + std::max<int64_t>(0, mstart - base);
  }

  Step truncated() {  // gzread serves every symbol it completed
    phase = kDone;
    return kStop;
  }
  // A data error before `out`: gzread serves the whole calls before the
  // fetch that meets it.  zlib meets a too-far distance only when it
  // has room for the match; any other error it meets before the fetch
  // that filled its buffer to this point returns.
  Step fail(const uint8_t* out, bool distance_too_far) {
    const int64_t p = offset(out) - mstart;
    const int64_t e =
        mstart + (distance_too_far ? p / kFetch * kFetch
                                   : (p > 0 ? (p - 1) / kFetch * kFetch : 0));
    served = e / kCall * kCall;
    failed = true;
    phase = kDone;
    return kStop;
  }

  // The first bytes: gzip (the magic) or a plain file passed through.
  void look() {
    if (in_end - in < 2 && !in_eof) top_up();
    gzip = in_end - in >= 2 && in[0] == 0x1f && in[1] == 0x8b;
    phase = gzip ? kHeader : kPlain;
  }

  void header(const uint8_t* out) {
    uint32_t hcrc = 0, v;
    auto bytes = [&](uint32_t n) {  // n bytes into v, in the header CRC
      if (!take(8 * n, &v)) return false;
      uint8_t b[4];
      std::memcpy(b, &v, 4);
      hcrc = (uint32_t)crc32(hcrc, b, n);
      return true;
    };
    if (!bytes(2) || !bytes(2)) return (void)truncated();
    const uint32_t flags = v >> 8;
    if ((v & 0xff) != 8 || (flags & 0xe0)) return (void)fail(out, false);
    if (!bytes(4) || !bytes(2)) return (void)truncated();
    if (flags & 4) {
      if (!bytes(2)) return (void)truncated();
      for (uint32_t n = v; n > 0; --n)
        if (!bytes(1)) return (void)truncated();
    }
    for (uint32_t f : {8u, 16u}) {
      if (!(flags & f)) continue;
      do
        if (!bytes(1)) return (void)truncated();
      while (v != 0);
    }
    if (flags & 2) {
      const uint32_t want = hcrc & 0xffff;
      if (!take(16, &v)) return (void)truncated();
      if (v != want) return (void)fail(out, false);
    }
    last = false;
    phase = kBlock;
  }

  void block(const uint8_t* out) {
    if (last) {
      phase = kTrailer;
      return;
    }
    uint32_t v;
    if (!take(3, &v)) return (void)truncated();
    last = v & 1;
    switch (v >> 1) {
      case 0:
        align();
        if (!take(32, &v)) return (void)truncated();
        if ((v & 0xffff) != ((v >> 16) ^ 0xffff)) return (void)fail(out, false);
        stored_left = v & 0xffff;
        unload();
        phase = kStored;
        return;
      case 1:
        lit = fixed_tables().lit;
        dist = fixed_tables().dist;
        phase = kHuff;
        return;
      case 2:
        if (dynamic(out)) phase = kHuff;
        return;
      default:
        fail(out, false);
    }
  }

  // A dynamic block's code lengths and tables; false when the stream
  // stopped there.  The checks and their order are zlib's.
  bool dynamic(const uint8_t* out) {
    uint32_t v;
    if (!take(14, &v)) return truncated(), false;
    const uint32_t nlen = (v & 31) + 257, ndist = ((v >> 5) & 31) + 1,
                   ncl = ((v >> 10) & 15) + 4;
    if (nlen > 286 || ndist > 30) return fail(out, false), false;
    uint8_t cl[19] = {0};
    for (uint32_t i = 0; i < ncl; ++i) {
      if (!take(3, &v)) return truncated(), false;
      cl[kClOrder[i]] = (uint8_t)v;
    }
    uint64_t clt[1 << kClRoot];
    if (!build(clt, kClRoot, cl, 19, kClT)) return fail(out, false), false;
    const uint32_t total = nlen + ndist;
    for (uint32_t n = 0; n < total;) {
      refill_careful();
      const uint64_t e = clt[bitbuf & ((1u << kClRoot) - 1)];
      // zlib reads its empty code's marker as symbol 0, 1 bit long
      const uint32_t sym = kind(e) == kBad ? 0 : (uint32_t)(e >> 32);
      const uint32_t len = nbits(e);
      if (sym < 16) {
        if (real_bits() < len) return truncated(), false;
        consume(len);
        lens[n++] = (uint8_t)sym;
        continue;
      }
      const uint32_t xb = sym == 16 ? 2 : sym == 17 ? 3 : 7;
      if (real_bits() < len + xb) return truncated(), false;
      consume(len);
      if (sym == 16 && n == 0) return fail(out, false), false;
      const uint32_t rep =
          (uint32_t)(bitbuf & ((1u << xb) - 1)) + (sym == 18 ? 11 : 3);
      consume(xb);
      const uint8_t fill = sym == 16 ? lens[n - 1] : 0;
      if (n + rep > total) return fail(out, false), false;
      std::memset(lens + n, fill, rep);
      n += rep;
    }
    if (lens[256] == 0 || !build(dyn_lit, kLitRoot, lens, nlen, kLitT) ||
        !build(dyn_dist, kDistRoot, lens + nlen, ndist, kDistT))
      return fail(out, false), false;
    lit = dyn_lit;
    dist = dyn_dist;
    return true;
  }

  // One symbol with every check: near the input's end (a code cut short
  // there is a truncation, as zlib sees it), or near the round's output
  // end.
  Step careful(uint8_t*& out, uint8_t* target) {
    if (out >= target) return kFull;
    refill_careful();
    const uint64_t e = lookup(lit, kLitRoot, bitbuf);
    switch (kind(e)) {
      case kLit:
        if (real_bits() < nbits(e)) return truncated();
        *out++ = (uint8_t)(e >> 32);
        consume(nbits(e));
        return kGo;
      case kEob:
        if (real_bits() < nbits(e)) return truncated();
        consume(nbits(e));
        return kEnd;
      case kVal: {
        if (real_bits() < nbits(e)) return truncated();
        const uint32_t len = value(e, bitbuf);
        consume(nbits(e));
        const uint64_t d = lookup(dist, kDistRoot, bitbuf);
        if (real_bits() < nbits(d)) return truncated();
        if (kind(d) != kVal) return fail(out, false);
        const uint32_t dst = value(d, bitbuf);
        consume(nbits(d));
        if (dst > (size_t)(out - window_floor())) return fail(out, true);
        out = copy_match(out, dst, len);
        return kGo;
      }
      default:
        if (real_bits() < nbits(e)) return truncated();
        return fail(out, false);
    }
  }

  Step huffman(uint8_t*& out, uint8_t* target);

  void stored(uint8_t*& out, uint8_t* target) {
    while (stored_left > 0 && out < target) {
      if (in == in_end) {
        if (in_eof) return (void)truncated();
        top_up();
        continue;
      }
      const size_t n = std::min<size_t>(
          {stored_left, (size_t)(in_end - in), (size_t)(target - out)});
      std::memcpy(out, in, n);
      out += n;
      in += n;
      stored_left -= (uint32_t)n;
    }
    if (stored_left == 0) phase = kBlock;
  }

  void trailer(const uint8_t* out) {
    uint32_t v;
    align();
    if (!take(32, &v)) return (void)truncated();
    crc = crc_update(crc, tb() + crc_pos, out - (tb() + crc_pos));
    crc_pos = out - tb();
    if (v != crc) return (void)fail(out, false);
    if (!take(32, &v)) return (void)truncated();
    if (v != (uint32_t)(offset(out) - mstart)) return (void)fail(out, false);
    unload();
    mstart = offset(out);
    crc = 0;
    phase = kNext;
  }

  // After a member: another member, or the end (trailing bytes that do
  // not start with the magic are ignored, as gzread ignores them).
  void next() {
    if (in_end - in < 2 && !in_eof) top_up();
    phase = in_end - in >= 2 && in[0] == 0x1f && in[1] == 0x8b ? kHeader
                                                                : kDone;
  }

  void plain(uint8_t*& out, uint8_t* target) {
    while (out < target) {
      if (in == in_end) {
        if (in_eof) return (void)(phase = kDone);
        top_up();
        continue;
      }
      const size_t n =
          std::min<size_t>((size_t)(in_end - in), (size_t)(target - out));
      std::memcpy(out, in, n);
      out += n;
      in += n;
    }
  }

  // Drops text before *pos that neither the scanner nor the window
  // needs, when the buffer lacks room for a round; grows it when what
  // stays fills more than half of it.
  void reserve(size_t* pos) {
    const size_t need = kRound + kOutMargin + 16;
    if (end + need <= text.size()) return;
    const size_t drop = std::min(*pos, end > kWindow ? end - kWindow : 0);
    if (drop > 0) {
      std::memmove(text.data(), text.data() + drop, end - drop);
      end -= drop;
      safe -= drop;
      crc_pos -= drop;
      *pos -= drop;
      base += (int64_t)drop;
    }
    if (2 * (end + need) > text.size())
      text.resize(std::max(2 * text.size(), 2 * (end + need)));
  }

  void decode() {
    uint8_t* out = tb() + end;
    uint8_t* const target = out + kRound;
    while (phase != kDone && out < target) {
      switch (phase) {
        case kLook: look(); break;
        case kHeader: header(out); break;
        case kBlock: block(out); break;
        case kHuff:
          if (huffman(out, target) == kEnd) phase = kBlock;
          break;
        case kStored: stored(out, target); break;
        case kTrailer: trailer(out); break;
        case kNext: next(); break;
        case kPlain: plain(out, target); break;
        case kDone: break;
      }
    }
    if (gzip && !failed)
      crc = crc_update(crc, tb() + crc_pos, out - (tb() + crc_pos));
    end = crc_pos = out - tb();
  }

  // Decodes a round (unless the stream has ended) and serves what no
  // later error can take back; returns the bytes newly served.
  int64_t round(size_t* pos) {
    if (phase != kDone) reserve(pos);
    const size_t before = safe;
    if (phase != kDone) decode();
    return serve() - before;
  }

  size_t serve() {
    const int64_t g_end = base + (int64_t)end;
    int64_t g;
    if (phase == kDone) {
      g = failed ? served : g_end;
    } else if (!gzip) {
      g = g_end;
    } else {  // the first byte a later error could take back
      const int64_t p = g_end - mstart;
      g = (mstart + (p > 0 ? (p - 1) / kFetch * kFetch : 0)) / kCall * kCall;
    }
    safe = std::max<size_t>(safe, (size_t)std::max<int64_t>(g - base, 0));
    return safe;
  }
};

namespace {

// The fast loop: while 64 input bytes and a match's room remain, no
// check but the code's own kind.  A refill leaves >= 56 bits in the
// buffer and all 64 of it stream bits; a literal lookup takes <= 15, a
// length <= 20, a distance <= 28, so after a match >= 16 stream bits
// remain for the next lookup, made before the refill and the copy so
// that they overlap.  The entry `e` is always looked up and not yet
// consumed.
__attribute__((always_inline)) inline Step fast_loop(Inflater& d,
                                                     uint8_t*& out_ref,
                                                     uint8_t* target) {
  const uint64_t* const lt = d.lit;
  const uint64_t* const dt = d.dist;
  const uint8_t* const wfloor = d.window_floor();
  const uint8_t* const in_stop =
      d.in_end - std::min<size_t>(kInMargin, d.in_end - d.input.data());
  const uint8_t* in = d.in;
  uint64_t bb = d.bitbuf;
  uint32_t bc = d.bitcnt;
  uint8_t* out = out_ref;
  Step r = kGo;
#define KTP_REFILL()             \
  do {                           \
    bb |= load64(in) << bc;      \
    in += (63 - bc) >> 3;        \
    bc |= 56;                    \
  } while (0)
#define KTP_LITS(e)                        \
  do {                                     \
    *out++ = (uint8_t)((e) >> 32);         \
    bb >>= (uint8_t)(e);                   \
    bc -= (uint8_t)(e);                    \
  } while (0)
  if (in < in_stop) KTP_REFILL();
  uint64_t e = lookup(lt, kLitRoot, bb);
  while (in < in_stop && out < target) {
    if (kind(e) == kLit) {
      KTP_LITS(e);
      e = lookup(lt, kLitRoot, bb);
      if (kind(e) == kLit) {
        KTP_LITS(e);
        e = lookup(lt, kLitRoot, bb);
        if (kind(e) == kLit) {
          KTP_LITS(e);
          KTP_REFILL();
          e = lookup(lt, kLitRoot, bb);
          continue;
        }
      }
      KTP_REFILL();  // e's bits stay where they are
    }
    if (kind(e) != kVal) {
      if (kind(e) == kEob) {
        bb >>= (uint8_t)e;
        bc -= (uint8_t)e;
        r = kEnd;
      } else {
        r = kStop;
      }
      break;
    }
    // a fault leaves the bits at the length, for the careful step
    const uint64_t rest = bb >> (uint8_t)e;
    const uint64_t de = lookup(dt, kDistRoot, rest);
    if (kind(de) != kVal) {
      r = kStop;
      break;
    }
    const uint32_t dist = value(de, rest);
    if (dist > (size_t)(out - wfloor)) {
      r = kStop;
      break;
    }
    const uint32_t len = value(e, bb);
    bb = rest >> (uint8_t)de;
    bc -= (uint8_t)e + (uint8_t)de;
    e = lookup(lt, kLitRoot, bb);
    KTP_REFILL();
    out = copy_match(out, dist, len);
  }
#undef KTP_LITS
#undef KTP_REFILL
  d.in = in;
  d.bitbuf = bb;
  d.bitcnt = bc;
  out_ref = out;
  return r;
}

Step fast_generic(Inflater& d, uint8_t*& out, uint8_t* target) {
  return fast_loop(d, out, target);
}

#if defined(KTP_X86)
__attribute__((target("bmi2"))) Step fast_bmi2(Inflater& d, uint8_t*& out,
                                               uint8_t* target) {
  return fast_loop(d, out, target);
}
#endif

}  // namespace

Step Inflater::huffman(uint8_t*& out, uint8_t* target) {
#if defined(KTP_X86)
  static const bool bmi2 = __builtin_cpu_supports("bmi2");
  Step (*const fast)(Inflater&, uint8_t*&, uint8_t*) =
      bmi2 ? fast_bmi2 : fast_generic;
#else
  Step (*const fast)(Inflater&, uint8_t*&, uint8_t*) = fast_generic;
#endif
  for (;;) {
    Step r = fast(*this, out, target);
    if (r == kEnd) return r;
    // kStop: a fault the careful step finds again and judges; kGo: an
    // end of the input or of the round
    r = careful(out, target);
    if (r != kGo) return r;
  }
}

TextStream::TextStream(int fd, std::vector<char>* text,
                       std::vector<uint8_t>* input)
    : dec_(new Inflater(fd, text, input)) {
  text_ = text->data();
}

TextStream::~TextStream() {
  if (dec_->fd >= 0) close(dec_->fd);
}

size_t TextStream::find(char c, size_t from) const {
  if (from >= size_) return npos;
  const void* p = std::memchr(text_ + from, c, size_ - from);
  return p ? (size_t)(static_cast<const char*>(p) - text_) : npos;
}

bool TextStream::fill(size_t* pos) {
  Inflater& d = *dec_;
  for (;;) {
    const int64_t n = d.round(pos);
    text_ = d.text.data();
    size_ = d.safe;
    if (n > 0) {
      text_bytes += n;
      if (d.gzip) inflate_bytes += n;
      return true;
    }
    if (d.phase == Inflater::kDone) return false;
  }
}

}  // namespace ktp
