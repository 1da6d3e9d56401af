// Native samtools-style .fai builder, the port's copy of the JAX package's
// native/fasta_index.cpp (the host-side hot loop of the ETL's
// sequence-join stage: the reference indexes UniRef90's ~60 GB FASTA
// through pyfaidx, reference uniref_dataset.py:274-320; here the index
// format is built directly — etl/fasta.py holds the Python fallback this
// must match byte-for-byte, including its non-uniform-line-width error).
//
// ABI: plain extern "C" over ctypes (see native/build.py — pybind11 is
// not in the image). Parity-tested in tests/test_torch_native.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

constexpr int32_t kAbiVersion = 2;

// Return codes for pbt_build_fai.
constexpr int64_t kErrIo = -1;          // open/read/write failure
constexpr int64_t kErrNonUniform = -2;  // ragged line widths inside a record

struct Record {
  std::string name;
  int64_t rlen = 0;
  int64_t seq_offset = 0;
  int64_t line_bases = 0;
  int64_t line_bytes = 0;
};

bool flush(const Record& r, FILE* out) {
  return std::fprintf(out, "%s\t%lld\t%lld\t%lld\t%lld\n", r.name.c_str(),
                      (long long)r.rlen, (long long)r.seq_offset,
                      (long long)r.line_bases, (long long)r.line_bytes) >= 0;
}

bool is_space(char c) {
  // Python str.split() whitespace (the fallback parses names with it).
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' ||
         c == '\f';
}

}  // namespace

extern "C" {

int32_t pbt_fai_abi_version() { return kAbiVersion; }

// Scan `fasta_path`, write the index to `fai_path`. Returns the record
// count (>= 0) or a kErr* code. On kErrNonUniform: *had_header reports
// whether any '>' header preceded the error (0 mirrors the Python
// fallback's `record None`), and the offending record's name is copied
// into err_name (NUL-terminated, truncated to err_name_cap).
int64_t pbt_build_fai(const char* fasta_path, const char* fai_path,
                      int32_t* had_header, char* err_name,
                      int64_t err_name_cap) {
  FILE* in = std::fopen(fasta_path, "rb");
  if (!in) return kErrIo;
  FILE* out = std::fopen(fai_path, "wb");
  if (!out) {
    std::fclose(in);
    return kErrIo;
  }
  // Large stdio buffers: the loop is getline-bound.
  static thread_local char inbuf[1 << 22];
  static thread_local char outbuf[1 << 20];
  std::setvbuf(in, inbuf, _IOFBF, sizeof(inbuf));
  std::setvbuf(out, outbuf, _IOFBF, sizeof(outbuf));

  char* line = nullptr;
  size_t cap = 0;
  int64_t offset = 0;
  int64_t n_records = 0;
  bool in_record = false;  // a '>' header has been seen
  bool short_line_seen = false;
  Record rec;
  int64_t result = kErrIo;

  ssize_t got;
  while ((got = ::getline(&line, &cap, in)) != -1) {
    if (line[0] == '>') {
      if (in_record) {
        if (!flush(rec, out)) goto done;
        ++n_records;
      }
      // name = first whitespace-delimited word after '>' (leading
      // whitespace skipped, like the fallback's raw[1:].split()).
      int64_t start = 1;
      while (start < got && is_space(line[start])) ++start;
      int64_t end = start;
      while (end < got && !is_space(line[end])) ++end;
      rec = Record{};
      rec.name.assign(line + start, end - start);
      rec.seq_offset = offset + got;
      in_record = true;
      short_line_seen = false;
    } else {
      // Sequence data is validated even before the first header (the
      // Python fallback does — such lines feed its width checks but are
      // never flushed, since flushing requires a header).
      int64_t stripped = got;
      while (stripped > 0 &&
             (line[stripped - 1] == '\n' || line[stripped - 1] == '\r'))
        --stripped;
      if (stripped > 0) {
        // Offset arithmetic in FastaReader.fetch() only holds for
        // uniformly wrapped records (all lines equal width except
        // possibly the last) — reject ragged input, like the Python path.
        if (short_line_seen ||
            (rec.line_bases && stripped > rec.line_bases)) {
          if (had_header) *had_header = in_record ? 1 : 0;
          if (err_name && err_name_cap > 0) {
            int64_t n = (int64_t)rec.name.size();
            if (n > err_name_cap - 1) n = err_name_cap - 1;
            std::memcpy(err_name, rec.name.data(), n);
            err_name[n] = '\0';
          }
          result = kErrNonUniform;
          goto done;
        }
        if (rec.line_bases == 0) {
          rec.line_bases = stripped;
          rec.line_bytes = got;
        } else if (stripped < rec.line_bases) {
          short_line_seen = true;
        }
        rec.rlen += stripped;
      } else if (rec.line_bases) {
        // Blank line inside a record: legal only if nothing follows.
        short_line_seen = true;
      }
    }
    offset += got;
  }
  if (std::ferror(in)) goto done;
  if (in_record) {
    if (!flush(rec, out)) goto done;
    ++n_records;
  }
  result = n_records;

done:
  std::free(line);
  std::fclose(in);
  if (std::fclose(out) != 0 && result >= 0) result = kErrIo;
  return result;
}

}  // extern "C"
