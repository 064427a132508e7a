// Native sequential BAM scan for bam-vaf-counter (a copy of
// kmer_tpu/io/native/bam_count.cpp, so that the port imports and builds
// nothing of the JAX package).
//
// The reference keeps this loop in C (htslib sam_read1 + a CIGAR walk,
// the reference's bam-vaf-counter.c:238-317); the pure-Python reader in
// io/bam.py is semantically identical but ~6x slower per
// record.  This module is the native runtime analog: BGZF inflate +
// BAM record parse + per-overlap CIGAR walk, updating ref/alt counts
// for a (tid, start)-sorted SNP pattern array.
//
// Semantics mirror tools/bam_vaf_counter.py exactly:
//   - skip reads with flag & (UNMAP|QCFAIL|DUP)
//   - end_pos = pos + max(ref-consumed length, 1)
//   - for each pattern with pat.start in [pos, end_pos): CIGAR walk;
//     M/=/X containing the SNP yields the read base (None if index
//     beyond stored SEQ), D/N containing it yields nothing,
//     I/S advance the read only.
//   - base compared as ASCII via the nt16 decode string.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

const char SEQ_NT16_STR[] = "=ACMGRSVTWYHKDBN";

constexpr uint32_t FLAG_SKIP = 0x4 | 0x200 | 0x400;  // UNMAP|QCFAIL|DUP

// Streaming BGZF decompressor: a FIFO of inflated bytes.
struct BgzfIn {
  FILE* fp = nullptr;
  std::vector<uint8_t> buf;  // decompressed FIFO
  size_t rd = 0;             // read offset into buf
  bool eof = false;

  bool open(const char* path) {
    fp = fopen(path, "rb");
    return fp != nullptr;
  }
  void close() {
    if (fp) fclose(fp);
    fp = nullptr;
  }

  // Inflate one BGZF block onto the FIFO. Returns false at EOF/error.
  bool pump() {
    if (eof) return false;
    uint8_t hdr[12];
    if (fread(hdr, 1, 12, fp) != 12) { eof = true; return false; }
    if (hdr[0] != 0x1f || hdr[1] != 0x8b) { eof = true; return false; }
    uint16_t xlen = (uint16_t)hdr[10] | ((uint16_t)hdr[11] << 8);
    std::vector<uint8_t> extra(xlen);
    if (fread(extra.data(), 1, xlen, fp) != xlen) { eof = true; return false; }
    int bsize = -1;
    for (size_t off = 0; off + 4 <= extra.size();) {
      uint8_t si1 = extra[off], si2 = extra[off + 1];
      uint16_t slen = (uint16_t)extra[off + 2] | ((uint16_t)extra[off + 3] << 8);
      if (si1 == 66 && si2 == 67 && slen == 2 && off + 6 <= extra.size())
        bsize = ((int)extra[off + 4] | ((int)extra[off + 5] << 8)) + 1;
      off += 4 + slen;
    }
    if (bsize < 0) { eof = true; return false; }
    int cdata_len = bsize - 12 - xlen - 8;
    if (cdata_len < 0) { eof = true; return false; }
    std::vector<uint8_t> cdata(cdata_len + 8);
    if (fread(cdata.data(), 1, cdata.size(), fp) != cdata.size()) {
      eof = true;
      return false;
    }
    uint32_t isize = (uint32_t)cdata[cdata_len + 4] |
                     ((uint32_t)cdata[cdata_len + 5] << 8) |
                     ((uint32_t)cdata[cdata_len + 6] << 16) |
                     ((uint32_t)cdata[cdata_len + 7] << 24);
    if (isize == 0) return true;  // empty block (EOF marker) — keep going
    size_t old = buf.size();
    buf.resize(old + isize);
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) { eof = true; return false; }
    zs.next_in = cdata.data();
    zs.avail_in = cdata_len;
    zs.next_out = buf.data() + old;
    zs.avail_out = isize;
    int zr = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (zr != Z_STREAM_END || zs.avail_out != 0) {
      buf.resize(old);
      eof = true;
      return false;
    }
    return true;
  }

  // Ensure n bytes readable at buf[rd..]; compacts the FIFO as needed.
  bool need(size_t n) {
    while (buf.size() - rd < n) {
      if (rd > (1u << 20)) {  // compact
        buf.erase(buf.begin(), buf.begin() + rd);
        rd = 0;
      }
      if (!pump()) return false;
    }
    return true;
  }
  const uint8_t* take(size_t n) {
    const uint8_t* p = buf.data() + rd;
    rd += n;
    return p;
  }
};

inline int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

// lower bound over the (tid, start)-sorted pattern arrays
inline int64_t pat_lower_bound(const int32_t* ptid, const int32_t* pstart,
                               int64_t n, int32_t tid, int32_t pos) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (ptid[mid] < tid || (ptid[mid] == tid && pstart[mid] < pos))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

}  // namespace

extern "C" {

// Sequentially scan a BAM, counting ref/alt bases at SNP positions.
// ptid/pstart must be sorted by (tid, start); pref/palt are ASCII bases.
// ref_counts/alt_counts are int64[n_pat], incremented in place.
// Returns number of records processed, or -1 on open error, -2 when the
// header is unreadable (callers fall back to the Python reader).
// A stream that turns malformed mid-body yields the counts accumulated
// up to the damage — the same stop-at-first-bad-record behavior as
// htslib's sam_read1 loop and our Python BamReader.
int64_t ktp_bam_count(const char* path, const int32_t* ptid,
                      const int32_t* pstart, const uint8_t* pref,
                      const uint8_t* palt, int64_t n_pat,
                      int64_t* ref_counts, int64_t* alt_counts) {
  BgzfIn in;
  if (!in.open(path)) return -1;
  int64_t n_rec = 0;
  // --- header: magic, l_text, text, n_ref, per-ref name+len
  if (!in.need(8)) { in.close(); return -2; }
  const uint8_t* p = in.take(8);
  if (memcmp(p, "BAM\x01", 4) != 0) { in.close(); return -2; }
  int32_t l_text = rd_i32(p + 4);
  if (l_text < 0 || !in.need((size_t)l_text + 4)) { in.close(); return -2; }
  in.take(l_text);
  int32_t n_ref = rd_i32(in.take(4));
  for (int32_t i = 0; i < n_ref; i++) {
    if (!in.need(4)) { in.close(); return -2; }
    int32_t l_name = rd_i32(in.take(4));
    if (l_name < 0 || !in.need((size_t)l_name + 4)) { in.close(); return -2; }
    in.take(l_name + 4);
  }
  // --- records
  std::vector<uint32_t> cigar;
  while (in.need(4)) {
    int32_t block_size = rd_i32(in.take(4));
    if (block_size < 32) break;
    if (!in.need((size_t)block_size)) break;
    const uint8_t* rec = in.take(block_size);
    int32_t tid = rd_i32(rec);
    int32_t pos = rd_i32(rec + 4);
    uint8_t l_read_name = rec[8];
    uint16_t n_cigar = (uint16_t)rec[12] | ((uint16_t)rec[13] << 8);
    uint16_t flag = (uint16_t)rec[14] | ((uint16_t)rec[15] << 8);
    int32_t l_seq = rd_i32(rec + 16);
    n_rec++;
    if (flag & FLAG_SKIP) continue;
    if (tid < 0) continue;
    size_t off = 32 + l_read_name;
    if (off + 4ull * n_cigar > (size_t)block_size) continue;
    const uint8_t* cig = rec + off;
    const uint8_t* nyb = cig + 4ull * n_cigar;
    size_t nyb_avail = block_size - (off + 4ull * n_cigar);
    // end_pos
    int64_t ref_len = 0;
    for (uint16_t i = 0; i < n_cigar; i++) {
      uint32_t v = rd_u32(cig + 4ull * i);
      uint32_t op = v & 0xF, ln = v >> 4;
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) ref_len += ln;
    }
    int64_t end_pos = pos + (ref_len > 1 ? ref_len : 1);
    int64_t i_pat = pat_lower_bound(ptid, pstart, n_pat, tid, pos);
    for (; i_pat < n_pat && ptid[i_pat] == tid && pstart[i_pat] < end_pos;
         i_pat++) {
      int32_t snp = pstart[i_pat];
      // CIGAR walk to the read index carrying reference position `snp`
      int64_t read_pos = 0, cur = pos;
      int64_t idx = -1;
      bool deleted = false;
      for (uint16_t i = 0; i < n_cigar; i++) {
        uint32_t v = rd_u32(cig + 4ull * i);
        uint32_t op = v & 0xF;
        int64_t ln = v >> 4;
        if (op == 0 || op == 7 || op == 8) {  // M,=,X
          if (cur <= snp && snp < cur + ln) {
            idx = read_pos + (snp - cur);
            break;
          }
          read_pos += ln;
          cur += ln;
        } else if (op == 1 || op == 4) {  // I,S
          read_pos += ln;
        } else if (op == 2 || op == 3) {  // D,N
          if (cur <= snp && snp < cur + ln) {
            deleted = true;
            break;
          }
          cur += ln;
        }  // H,P: nothing
      }
      if (deleted || idx < 0 || idx >= l_seq) continue;
      if ((size_t)(idx >> 1) >= nyb_avail) continue;  // truncated record
      uint8_t b = nyb[idx >> 1];
      uint8_t code = (idx & 1) ? (b & 0xF) : (b >> 4);
      char base = SEQ_NT16_STR[code];
      if ((uint8_t)base == pref[i_pat])
        ref_counts[i_pat]++;
      else if ((uint8_t)base == palt[i_pat])
        alt_counts[i_pat]++;
    }
  }
  in.close();
  return n_rec;
}

}  // extern "C"
