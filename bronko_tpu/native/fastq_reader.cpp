// Native FASTQ chunk reader: gzip/plain FASTQ -> padded 2-bit-code matrices.
//
// Native replacement for the reference's external KMC3 I/O front end
// (call.rs:1152-1226): the heavy host work (decompress, line split, base
// encode) happens here in C++, producing device-ready (R, L) uint8 code
// matrices (0..3 = ACGT upper/lower, 4 = anything else / padding) plus
// true lengths. Exposed via a C ABI for ctypes.
//
// Build: make -C bronko_tpu/native  (produces libbronko_io.so)

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <vector>

namespace {

struct FastqReader {
  gzFile gz = nullptr;
  std::vector<char> buf;     // carry-over of an incomplete trailing record
  size_t buf_pos = 0;        // consumed prefix of buf
  int64_t total_reads = 0;
  bool eof = false;
  bool read_error = false;   // gzread failure (corrupt/truncated gzip)
  unsigned char code_table[256];

  FastqReader() {
    memset(code_table, 4, sizeof(code_table));
    code_table[(unsigned char)'A'] = 0; code_table[(unsigned char)'a'] = 0;
    code_table[(unsigned char)'C'] = 1; code_table[(unsigned char)'c'] = 1;
    code_table[(unsigned char)'G'] = 2; code_table[(unsigned char)'g'] = 2;
    code_table[(unsigned char)'T'] = 3; code_table[(unsigned char)'t'] = 3;
  }
};

constexpr size_t kReadBlock = 8 << 20;  // 8 MiB decompressed per refill

// Refill reader buffer; returns false at EOF with empty buffer.
bool refill(FastqReader* r) {
  if (r->buf_pos > 0) {
    r->buf.erase(r->buf.begin(), r->buf.begin() + r->buf_pos);
    r->buf_pos = 0;
  }
  if (r->eof) return !r->buf.empty();
  size_t old = r->buf.size();
  r->buf.resize(old + kReadBlock);
  int n = gzread(r->gz, r->buf.data() + old, (unsigned)kReadBlock);
  if (n <= 0) {
    // n < 0 is a zlib error; n == 0 can be EITHER clean EOF or a
    // truncated stream (zlib reports the latter via gzerror, typically
    // Z_BUF_ERROR "unexpected end of file"). Treating truncation as EOF
    // silently accepted a prefix of the sample and called variants on
    // partial data; surface it as malformed input instead.
    if (n < 0) {
      r->read_error = true;
    } else {
      int errnum = Z_OK;
      gzerror(r->gz, &errnum);
      if (errnum != Z_OK && errnum != Z_STREAM_END) r->read_error = true;
    }
    r->eof = true;
    r->buf.resize(old);
  } else {
    r->buf.resize(old + (size_t)n);
    if ((size_t)n < kReadBlock) {
      // short read = EOF or a truncated stream; only gzerror can tell
      int errnum = Z_OK;
      gzerror(r->gz, &errnum);
      if (errnum != Z_OK && errnum != Z_STREAM_END) r->read_error = true;
      r->eof = true;
    }
  }
  return !r->buf.empty();
}

}  // namespace

extern "C" {

void* bronko_fastq_open(const char* path) {
  gzFile gz = gzopen(path, "rb");
  if (!gz) return nullptr;
  gzbuffer(gz, 1 << 20);
  auto* r = new FastqReader();
  r->gz = gz;
  return r;
}

void bronko_fastq_close(void* h) {
  auto* r = static_cast<FastqReader*>(h);
  if (!r) return;
  if (r->gz) gzclose(r->gz);
  delete r;
}

int64_t bronko_fastq_total_reads(void* h) {
  return static_cast<FastqReader*>(h)->total_reads;
}

// Parse up to max_reads 4-line records. codes must hold max_reads*max_len
// bytes (pre-filled by callee with 4), lengths max_reads int32. Sequences
// longer than max_len are encoded truncated but report their true length.
// Returns reads parsed this call, 0 at EOF, -1 on malformed input.
int64_t bronko_fastq_read_chunk(void* h, uint8_t* codes, int32_t* lengths,
                                int64_t max_reads, int64_t max_len) {
  auto* r = static_cast<FastqReader*>(h);
  memset(codes, 4, (size_t)(max_reads * max_len));
  int64_t n_reads = 0;

  while (n_reads < max_reads) {
    // ensure at least one full record (4 newlines) is buffered
    const char* data = r->buf.data() + r->buf_pos;
    size_t avail = r->buf.size() - r->buf_pos;
    const char* nl[4];
    size_t scanned = 0;
    int found = 0;
    for (; found < 4; ++found) {
      const char* p = static_cast<const char*>(
          memchr(data + scanned, '\n', avail - scanned));
      if (!p) break;
      nl[found] = p;
      scanned = (size_t)(p - data) + 1;
    }
    if (found < 4) {
      if (r->eof) {
        // trailing partial record (or none): tolerate missing final newline
        if (avail > 0 && found == 3) {
          nl[3] = data + avail - 1;  // virtual newline at end
          found = 4;
          scanned = avail;
        } else {
          break;
        }
      } else {
        if (!refill(r)) {
          if (r->read_error) return -1;
          break;
        }
        continue;
      }
    }
    // record lines: [0]=header, [1]=seq, [2]=plus, [3]=qual
    const char* seq_start = nl[0] + 1;
    const char* seq_end = nl[1];
    while (seq_end > seq_start && (seq_end[-1] == '\r')) --seq_end;
    int64_t len = seq_end - seq_start;
    if (data[0] != '@') return -1;

    uint8_t* row = codes + n_reads * max_len;
    int64_t enc = len < max_len ? len : max_len;
    for (int64_t i = 0; i < enc; ++i)
      row[i] = r->code_table[(unsigned char)seq_start[i]];
    lengths[n_reads] = (int32_t)len;
    ++n_reads;
    ++r->total_reads;
    r->buf_pos += scanned;
  }
  if (r->read_error) return -1;
  return n_reads;
}

}  // extern "C"
