// The text of a FASTA/FASTQ file as the block reader scans it
// (fastx_reader.cpp): a gzip file decoded by a table-driven DEFLATE
// decoder (gzinflate.cpp), or a plain file passed through, read from a
// file descriptor in large read() calls.
//
// The served bytes and the point where a damaged stream stops are
// zlib's gzread's (gzopen, gzbuffer 1 MiB, gzread 1 MiB calls): a
// truncated stream serves every symbol it completes; a corrupt one
// (bad code, bad distance, CRC32 or ISIZE mismatch, bad header) serves
// only the whole 1 MiB gzread calls that would have returned before the
// error, so the decoder holds back the output of the 2 MiB gzread fetch
// it is in (and the rest of its 1 MiB call) until no later error can
// take it back.
#pragma once

#include <cstddef>
#include <cstdint>
#include <memory>
#include <vector>

namespace ktp {

struct Inflater;

class TextStream {
 public:
  static constexpr size_t npos = static_cast<size_t>(-1);

  // Reads `fd` (closed by the destructor); `text` and `input` are the
  // caller's pooled buffers, grown as needed and never shrunk.
  TextStream(int fd, std::vector<char>* text, std::vector<uint8_t>* input);
  ~TextStream();
  TextStream(const TextStream&) = delete;
  TextStream& operator=(const TextStream&) = delete;

  // The served text not yet dropped: [0, size()).
  const char* data() const { return text_; }
  size_t size() const { return size_; }
  char operator[](size_t i) const { return text_[i]; }
  size_t find(char c, size_t from) const;

  // Serves more text: drops the bytes before *pos that the decoder no
  // longer needs (moving *pos down by as many) and appends at least one
  // byte.  False when the stream has no more.
  bool fill(size_t* pos);

  int64_t inflate_bytes = 0;  // served bytes the DEFLATE decoder produced
  int64_t text_bytes = 0;     // all served bytes (plain files included)

 private:
  const char* text_ = nullptr;
  size_t size_ = 0;
  std::unique_ptr<Inflater> dec_;
};

}  // namespace ktp
