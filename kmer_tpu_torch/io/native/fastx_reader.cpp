// Native FASTA/FASTQ block reader for kmer_tpu_torch (a copy of
// kmer_tpu/io/native/fastx_reader.cpp, so that the port imports and
// builds nothing of the JAX package).
//
// Fills fixed-capacity byte buffers with NUL-separated read sequences,
// ready for device upload — the host side of the counting pipeline
// (the role kseq.h + the kt_pipeline read step play in the reference:
// the reference's kc-c4.c:133-155).  Fresh implementation: a chunked
// scanner with a small record state machine over the text that
// gzinflate.cpp decodes (gzread's bytes); sequences shorter than k are
// skipped, sequences longer than the buffer are split into (k-1)-overlap
// chunks so no k-mer window is lost or duplicated.
//
// C ABI for ctypes.
//
// Each Reader keeps plain int64 counters, always on (ktp_stats): the
// nanoseconds in the decoder (file reads included), the nanoseconds
// inside ktp_read_block, ktp_read_block_packed and ktp_read_records, the
// text bytes the DEFLATE decoder served and all text bytes served.  Two
// steady_clock reads a decoder fill (a 1 MiB round) and two a block call.

#include <fcntl.h>

#include "gzinflate.h"

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define KTP_X86 1
#endif

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Reusable big-buffer arena.  Each Reader holds MB-scale buffers (the
// decoded text with its window, the compressed input, block staging);
// on some VMs the FIRST touch of fresh anonymous pages runs 5-10x
// slower than reuse (measured 146 MB/s first-touch vs 2.3+ GB/s
// refault), and glibc munmaps huge frees — so per-pass Reader churn
// re-paid the fault cost every pass.  A small process-global pool keeps
// the pages alive across Reader lifetimes.
struct Arena {
  std::vector<char> text;        // decoded text (TextStream)
  std::vector<uint8_t> input;    // compressed input (TextStream)
  std::vector<uint8_t> scratch;  // ASCII staging for the packed path
};

std::mutex g_arena_m;
std::vector<Arena*> g_arena_pool;

Arena* arena_acquire() {
  std::lock_guard<std::mutex> lk(g_arena_m);
  if (!g_arena_pool.empty()) {
    Arena* a = g_arena_pool.back();
    g_arena_pool.pop_back();
    return a;
  }
  return new Arena();
}

void arena_release(Arena* a) {
  if (!a) return;
  std::lock_guard<std::mutex> lk(g_arena_m);
  if (g_arena_pool.size() < 2) {
    g_arena_pool.push_back(a);
  } else {
    delete a;
  }
}

struct Reader {
  Arena* ar;
  ktp::TextStream buf;  // the text: [pos, buf.size()) unconsumed
  size_t pos = 0;       // cursor into buf
  bool eof = false;

  // ktp_stats' counters (and buf's inflate_bytes, text_bytes)
  int64_t inflate_ns = 0;  // in the decoder
  int64_t native_ns = 0;   // in the block and record calls
  std::vector<uint8_t>& scratch;  // packed-path staging

  Reader(int fd, Arena* a)
      : ar(a), buf(fd, &a->text, &a->input), scratch(a->scratch) {}
  ~Reader() { arena_release(ar); }

  // carry-over sequence that did not fit the caller's buffer
  std::string carry;
  size_t carry_off = 0;

  bool stopped = false;  // kseq -2 (malformed quality): latch EOF

  // ktp_read_records: a whole record that did not fit the last call;
  // and its scan, which reads as io/fastx.py FastxReader does where the
  // block reader's differs (a last line without its newline keeps its
  // '\r'; a sequence line that starts with '>', '@' or '+' is never
  // taken by the fast path)
  std::string pending;
  bool has_pending = false;
  bool whole_records = false;

  // reference batch accounting for ktp_read_block's fill rule: the
  // reference's pipeline step 0 sums the lengths of kept reads and
  // breaks after the read that reaches the chunk size
  // (yak-count.c:381-383, kc-c4.c:151); batch_sum persists across
  // calls while one batch spans several output buffers (capacity or
  // carry splits).
  int64_t batch_sum = 0;

  // malformed-quality policy (see io/fastx.py FastxReader):
  // stop (kc-c1/c2-style) vs flush-and-resume with empty-virtual-block
  // stop (kc-c3/c4/yak/vaf pipelines)
  bool qual_resume = false;
  int64_t ref_block = 0;    // the reference tool's block/chunk bases
  int64_t sum_min_len = 0;  // reads shorter than this skip the sum
  int64_t ref_sum = 0;
  int64_t workers = 0;      // kt_pipeline workers: NULL budget
  int64_t nulls = 0;

  bool fill() {
    if (eof) return false;
    int64_t t0 = now_ns();
    bool ok = buf.fill(&pos);
    inflate_ns += now_ns() - t0;
    if (!ok) eof = true;
    return ok;
  }

  // next line (without newline); returns false at EOF with no data
  bool getline(std::string* out) {
    out->clear();
    for (;;) {
      size_t nl = buf.find('\n', pos);
      if (nl != ktp::TextStream::npos) {
        size_t len = nl - pos;
        if (len && buf[nl - 1] == '\r') --len;
        out->assign(buf.data() + pos, len);
        pos = nl + 1;
        return true;
      }
      if (!fill()) {
        if (pos < buf.size()) {
          out->assign(buf.data() + pos, buf.size() - pos);
          if (!whole_records && !out->empty() && out->back() == '\r')
            out->pop_back();
          pos = buf.size();
          return !out->empty();
        }
        return false;
      }
    }
  }

  bool peek_char(char* c) {
    while (pos >= buf.size()) {
      if (!fill()) return false;
    }
    *c = buf[pos];
    return true;
  }

  // Fast path: one clean 4-line FASTQ record ('@hdr\nSEQ\n+x\nQUAL\n')
  // fully buffered, single-line seq and qual, no CR, qual length ==
  // seq length.  Returns false with `pos` untouched for anything else
  // (partial buffering, FASTA, multiline, CR, malformed quality) — the
  // generic scanner below keeps the exact kseq edge semantics.
  bool fastq_fast(std::string* seq) {
    size_t p = pos;
    if (p >= buf.size() || buf[p] != '@') return false;
    const char* base = buf.data();
    const char* e = base + buf.size();
    const char* h = base + p;
    const char* nl1 = (const char*)memchr(h, '\n', e - h);
    if (!nl1) return false;
    const char* s0 = nl1 + 1;
    const char* nl2 = (const char*)memchr(s0, '\n', e - s0);
    if (!nl2 || nl2 == s0 || nl2[-1] == '\r') return false;
    if (whole_records && (*s0 == '>' || *s0 == '@' || *s0 == '+'))
      return false;
    size_t slen = nl2 - s0;
    const char* plus = nl2 + 1;
    if (plus >= e || *plus != '+') return false;
    const char* nl3 = (const char*)memchr(plus, '\n', e - plus);
    if (!nl3) return false;
    const char* q0 = nl3 + 1;
    if ((size_t)(e - q0) < slen + 1) return false;
    const char* nl4 = q0 + slen;
    if (*nl4 != '\n' || nl4[-1] == '\r') return false;
    if (memchr(q0, '\n', slen) != nullptr) return false;  // short qual line
    seq->assign(s0, slen);
    pos = (size_t)(nl4 + 1 - base);
    if (qual_resume) {
      if ((int64_t)slen >= sum_min_len) ref_sum += slen;
      if (ref_block > 0 && ref_sum >= ref_block) ref_sum = 0;
    }
    return true;
  }

  // read the next record's sequence into *seq; false at EOF
  bool next_seq(std::string* seq) {
    while (!stopped) {
      if (fastq_fast(seq)) return true;
      std::string line;
      char c;
      // find header
      for (;;) {
        if (!peek_char(&c)) return false;
        if (c == '>' || c == '@') break;
        if (!getline(&line)) return false;  // skip junk line
      }
      if (!getline(&line)) return false;  // header line
      seq->clear();
      bool at_eof = false;
      for (;;) {
        if (!peek_char(&c)) { at_eof = true; break; }
        if (c == '>' || c == '@' || c == '+') break;
        if (!getline(&line)) { at_eof = true; break; }
        seq->append(line);
      }
      if (!at_eof && c == '+') {
        // '+' starts the quality section regardless of the header char
        // (kseq.h:222); a length mismatch or EOF is kseq's -2: the
        // record is dropped, then the stream stops (single-loop tools)
        // or resumes unless the reference's virtual block was empty
        // (pipelined tools; see fastx.py FastxReader for the mapping)
        getline(&line);  // '+' line
        size_t need = seq->size(), got = 0;
        // kseq always attempts one quality line before the length
        // check (kseq.h:229): an empty sequence with a non-empty
        // quality line is still a -2
        if (getline(&line)) {
          got = line.size();
          while (got < need && getline(&line)) got += line.size();
        }
        if (got != need) {  // -2
          if (!qual_resume) {
            stopped = true;
            return false;
          }
          if (ref_sum == 0 && ++nulls >= workers) {
            // empty reference block: step 0 NULL retires one pipeline
            // worker (kthread.c:120); the last one ends the stream
            stopped = true;
            return false;
          }
          ref_sum = 0;
          continue;  // drop record, read the next one
        }
      }
      if (qual_resume) {
        if ((int64_t)seq->size() >= sum_min_len) ref_sum += seq->size();
        if (ref_block > 0 && ref_sum >= ref_block) ref_sum = 0;
      }
      return true;
    }
    return false;
  }
};

#if defined(KTP_X86)
// 32 ASCII bytes -> 8 packed bytes + 32 mask bits per iteration.
// Codes via bit tricks instead of the table: (c>>1)&3 maps
// A,C,T/U,G -> 0,1,2,3; its 2-bit gray code x^(x>>1) is exactly
// seq_nt4 (A0 C1 G2 T3).  Validity = uppercase in {A,C,G,T,U}.
// Returns how many input bytes were consumed (a multiple of 32).
__attribute__((target("avx2")))
int64_t pack_avx2(const uint8_t* s, int64_t used, uint8_t* packed,
                  uint8_t* mask) {
  const __m256i vDF = _mm256_set1_epi8((char)0xDF);
  const __m256i vA = _mm256_set1_epi8('A'), vC = _mm256_set1_epi8('C');
  const __m256i vG = _mm256_set1_epi8('G'), vT = _mm256_set1_epi8('T');
  const __m256i vU = _mm256_set1_epi8('U');
  const __m256i v3 = _mm256_set1_epi8(3), v1 = _mm256_set1_epi8(1);
  const __m256i w14 = _mm256_set1_epi16(0x0401);   // bytes [1,4]
  const __m256i w116 = _mm256_set1_epi32(0x00100001);  // i16 [1,16]
  const __m256i pick0 = _mm256_setr_epi8(
      0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
      0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1);
  int64_t i = 0;
  for (; i + 32 <= used; i += 32) {
    __m256i v = _mm256_loadu_si256((const __m256i*)(s + i));
    __m256i up = _mm256_and_si256(v, vDF);
    __m256i valid = _mm256_or_si256(
        _mm256_or_si256(_mm256_cmpeq_epi8(up, vA), _mm256_cmpeq_epi8(up, vC)),
        _mm256_or_si256(
            _mm256_or_si256(_mm256_cmpeq_epi8(up, vG),
                            _mm256_cmpeq_epi8(up, vT)),
            _mm256_cmpeq_epi8(up, vU)));
    uint32_t inv = ~(uint32_t)_mm256_movemask_epi8(valid);
    std::memcpy(mask + (i >> 3), &inv, 4);
    __m256i code2 =
        _mm256_and_si256(_mm256_srli_epi16(v, 1), v3);
    __m256i gray = _mm256_xor_si256(
        code2, _mm256_and_si256(_mm256_srli_epi16(code2, 1), v1));
    __m256i code = _mm256_and_si256(gray, valid);
    __m256i t16 = _mm256_maddubs_epi16(code, w14);
    __m256i t32 = _mm256_madd_epi16(t16, w116);
    __m256i b = _mm256_shuffle_epi8(t32, pick0);
    __m128i lo = _mm256_castsi256_si128(b);
    __m128i hi = _mm256_extracti128_si256(b, 1);
    uint32_t p0 = (uint32_t)_mm_cvtsi128_si32(lo);
    uint32_t p1 = (uint32_t)_mm_cvtsi128_si32(hi);
    std::memcpy(packed + (i >> 2), &p0, 4);
    std::memcpy(packed + (i >> 2) + 4, &p1, 4);
  }
  return i;
}
#endif

int64_t read_block(Reader* r, uint8_t* out, int64_t capacity, int32_t k,
                   int64_t target_bases, int64_t* n_seqs, int64_t* n_bases,
                   int64_t* row_bytes, int64_t* batch_end);

}  // namespace

extern "C" {

// A handle on a FASTA/FASTQ file, gzipped or plain (a FIFO too: the
// first read tells them apart); null when it cannot be opened.
void* ktp_open(const char* path) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return nullptr;
  return new Reader(fd, arena_acquire());
}

// Configure the malformed-quality policy (must precede reads).
void ktp_set_policy(void* h, int32_t qual_resume, int64_t ref_block,
                    int64_t sum_min_len, int64_t workers) {
  auto* r = static_cast<Reader*>(h);
  r->qual_resume = qual_resume != 0;
  r->ref_block = ref_block;
  r->sum_min_len = sum_min_len;
  r->workers = workers;
}

void ktp_close(void* h) {
  delete static_cast<Reader*>(h);
}

// Fill `out` (capacity bytes) with NUL-separated sequences.
// Returns bytes used (sequences + separators), 0 at EOF.
// The fill rule is the reference pipeline's batch rule: whole reads
// accumulate until their summed LENGTH reaches target_bases
// (yak-count.c:381-383) — then *batch_end is set to 1.  A batch whose
// bytes (bases + separators) exceed `capacity` spans several calls via
// the carry buffer; only the call emitting its final read reports
// batch_end.  This makes per-batch stderr progress (yak's
// "[M] processed N sequences", yak-count.c:427) reconstructible by
// the caller with the reference's exact batch composition.
// n_seqs/n_bases report TRUE read counts: each read >= k counts once
// (at its first emitted piece) and its bases count once — a split
// piece's (k-1)-base halo is not re-counted.  This matches the
// reference's per-read accounting (vaf-counter.c:505-507 total_bases
// += l / total_seqs++ per kseq read) no matter how pieces land in
// buffers.  Sequences shorter than k are skipped; sequences longer
// than the remaining room are emitted in (k-1)-overlap chunks
// (possibly across calls via the carry buffer).
// row_bytes (may be null): set to L+1 when every piece packed this call
// had the same length L (uniform Illumina reads — enables the caller's
// fixed-row window slicing), else 0.
int64_t ktp_read_block(void* h, uint8_t* out, int64_t capacity, int32_t k,
                       int64_t target_bases, int64_t* n_seqs,
                       int64_t* n_bases, int64_t* row_bytes,
                       int64_t* batch_end) {
  auto* r = static_cast<Reader*>(h);
  int64_t t0 = now_ns();
  int64_t used = read_block(r, out, capacity, k, target_bases, n_seqs,
                            n_bases, row_bytes, batch_end);
  r->native_ns += now_ns() - t0;
  return used;
}

// Whole records, for a caller that needs each read whole with its raw
// bytes (ed-vaf-counter): the records' sequences back to back in `out`
// with no separator, and each one's length in `lens`.  No record is
// skipped (empty ones included) or split, and a NUL byte in a sequence
// is only a byte.  Stops after `max_reads` records, or after the record
// that brings the bases to `target_bases`, or before a record that does
// not fit the room left (it waits in the reader for the next call).
// Returns the bytes used and sets *n_reads, which is 0 only at the end
// of the stream; a first record longer than `capacity` returns minus
// its length and writes nothing, so that the caller can grow `out` and
// call again.  Shares next_seq, the record scanner, with ktp_read_block,
// and reads as io/fastx.py FastxReader does (Reader::whole_records); the
// stream stops at a malformed quality section unless ktp_set_policy
// said otherwise.  A handle takes one of the two calls.
int64_t ktp_read_records(void* h, uint8_t* out, int64_t capacity,
                         int64_t target_bases, int64_t max_reads,
                         int64_t* lens, int64_t* n_reads) {
  auto* r = static_cast<Reader*>(h);
  int64_t t0 = now_ns();
  r->whole_records = true;
  int64_t used = 0, n = 0;
  std::string seq;
  while (n < max_reads && used < target_bases) {
    if (r->has_pending) {
      seq.swap(r->pending);
      r->has_pending = false;
    } else if (!r->next_seq(&seq)) {
      break;
    }
    int64_t len = (int64_t)seq.size();
    if (len > capacity - used) {
      r->pending.swap(seq);
      r->has_pending = true;
      if (n == 0) used = -len;
      break;
    }
    std::memcpy(out + used, seq.data(), len);
    used += len;
    lens[n++] = len;
  }
  *n_reads = n;
  r->native_ns += now_ns() - t0;
  return used;
}

// The Reader's counters, cumulative since ktp_open: out[0] nanoseconds
// in the decoder, out[1] nanoseconds inside the block calls (the decoder
// included), out[2] text bytes served from the DEFLATE decoder, out[3]
// all text bytes served (a plain file's too).
void ktp_stats(void* h, int64_t* out) {
  auto* r = static_cast<Reader*>(h);
  out[0] = r->inflate_ns;
  out[1] = r->native_ns;
  out[2] = r->buf.inflate_bytes;
  out[3] = r->buf.text_bytes;
}

// The text itself, as the record scanner sees it: up to `capacity`
// bytes, 0 at the end.  A handle takes this call or the record calls.
int64_t ktp_read_text(void* h, uint8_t* out, int64_t capacity) {
  auto* r = static_cast<Reader*>(h);
  while (r->pos >= r->buf.size())
    if (!r->fill()) return 0;
  int64_t n = std::min<int64_t>(capacity, r->buf.size() - r->pos);
  std::memcpy(out, r->buf.data() + r->pos, n);
  r->pos += n;
  return n;
}

}  // extern "C"

namespace {

int64_t read_block(Reader* r, uint8_t* out, int64_t capacity, int32_t k,
                   int64_t target_bases, int64_t* n_seqs, int64_t* n_bases,
                   int64_t* row_bytes, int64_t* batch_end) {
  int64_t used = 0;
  *n_seqs = 0;
  *n_bases = 0;
  if (batch_end) *batch_end = 0;
  int64_t first_len = -1;
  bool uniform = true;
  const int64_t max_piece = capacity - 1;
  std::string seq;
  for (;;) {
    const std::string* src;
    size_t off;
    if (!r->carry.empty()) {
      src = &r->carry;
      off = r->carry_off;
    } else {
      if (!r->next_seq(&seq)) break;
      if ((int64_t)seq.size() < k) continue;
      src = &seq;
      off = 0;
      // the reference adds the WHOLE read to the batch when it is
      // read, then breaks once the batch total reaches the chunk size
      // (yak-count.c:381-383) — so a batch always ends on a complete
      // read, after the read that crossed the threshold
      r->batch_sum += (int64_t)seq.size();
    }
    int64_t remain = (int64_t)src->size() - (int64_t)off;
    int64_t room = capacity - used - 1;  // leave room for separator
    if (remain <= room) {
      std::memcpy(out + used, src->data() + off, remain);
      used += remain;
      out[used++] = 0;
      // off > 0 means this piece continues a split read: its first
      // k-1 bases are the halo already counted with the previous piece
      *n_bases += off == 0 ? remain : remain - (k - 1);
      if (off == 0) ++*n_seqs;
      if (first_len < 0) first_len = remain;
      else if (remain != first_len) uniform = false;
      if (src == &r->carry) {
        r->carry.clear();
        r->carry_off = 0;
      }
      if (r->batch_sum >= target_bases) {  // batch complete
        r->batch_sum = 0;
        if (batch_end) *batch_end = 1;
        break;
      }
    } else {
      // split: emit a max_piece chunk (or what fits) with k-1 overlap
      int64_t piece = room < k ? 0 : (room > max_piece ? max_piece : room);
      if (piece >= k) {
        std::memcpy(out + used, src->data() + off, piece);
        used += piece;
        out[used++] = 0;
        *n_bases += off == 0 ? piece : piece - (k - 1);
        if (off == 0) ++*n_seqs;
        if (first_len < 0) first_len = piece;
        else if (piece != first_len) uniform = false;
        off += piece - (k - 1);
      }
      if (src != &r->carry) {
        r->carry.assign(*src);
      }
      r->carry_off = off;
      break;  // buffer full
    }
  }
  if (row_bytes) {
    *row_bytes = (uniform && *n_seqs > 0) ? first_len + 1 : 0;
  }
  return used;
}

}  // namespace

extern "C" {

// Packed variant of ktp_read_block for bandwidth-limited host->device
// links: emits 2-bit base codes (A/C/G/T -> 0..3, 4 per byte,
// little-endian within the byte) plus a 1-bit-per-base invalid mask
// (N / separators / anything non-ACGT, and every slot past the packed
// region).  0.375 bytes per base instead of 1 — the device unpacks
// (kmer_tpu/pipeline/counter.py _unpack_ascii) into the exact byte
// stream ktp_read_block would have produced, modulo non-ACGT letters
// all becoming NUL (their base code is 4 either way).
// `capacity` must be a multiple of 8; packed/mask must hold
// capacity/4 and capacity/8 bytes and arrive zeroed.
int64_t ktp_read_block_packed(void* h, uint8_t* packed, uint8_t* mask,
                              int64_t capacity, int32_t k,
                              int64_t target_bases, int64_t* n_seqs,
                              int64_t* n_bases, int64_t* row_bytes,
                              int64_t* batch_end) {
  auto* r = static_cast<Reader*>(h);
  int64_t t0 = now_ns();
  if ((int64_t)r->scratch.size() < capacity) r->scratch.resize(capacity);
  int64_t used = read_block(r, r->scratch.data(), capacity, k, target_bases,
                            n_seqs, n_bases, row_bytes, batch_end);
  if (used <= 0) {
    r->native_ns += now_ns() - t0;
    return used;
  }
  static uint8_t nt4[256];
  static bool init = false;
  if (!init) {
    // seq_nt4_table semantics (kc-c1.c:12-29): T and U both map to 3
    memset(nt4, 4, sizeof(nt4));
    nt4['A'] = nt4['a'] = 0;
    nt4['C'] = nt4['c'] = 1;
    nt4['G'] = nt4['g'] = 2;
    nt4['T'] = nt4['t'] = 3;
    nt4['U'] = nt4['u'] = 3;
    init = true;
  }
  const uint8_t* s = r->scratch.data();
  int64_t i = 0;
#if defined(KTP_X86)
  // runtime-dispatched (the .so is built WITHOUT -mavx2 so it loads and
  // runs on any x86-64; the target attribute scopes AVX2 codegen to
  // this one function, and __builtin_cpu_supports gates the call)
  if (__builtin_cpu_supports("avx2")) i = pack_avx2(s, used, packed, mask);
#endif
  for (; i < used; ++i) {
    uint8_t c = nt4[s[i]];
    if (c > 3)
      mask[i >> 3] |= (uint8_t)(1u << (i & 7));
    else
      packed[i >> 2] |= (uint8_t)(c << (2 * (i & 3)));
  }
  // everything past the packed region is invalid
  for (i = used; i < capacity && (i & 7); ++i)
    mask[i >> 3] |= (uint8_t)(1u << (i & 7));
  if (i < capacity) memset(mask + (i >> 3), 0xFF, (capacity - i) >> 3);
  r->native_ns += now_ns() - t0;
  return used;
}

}  // extern "C"
