// Fast Criteo TSV parser: multithreaded parse + FNV-1a categorical hashing.
//
// The port's own copy of the JAX package's parser
// (recommender_system_tpu/native/criteo_parser.cpp), the same code: reads the
// tab-separated `label \t I1..I13 \t C1..C26` format, converts dense fields to
// float (0.0 for missing), and hashes each categorical token with 64-bit
// FNV-1a, bit-identical to utils/hashing.hash_strings_np (salt 0), so native
// and Python paths land ids in the same buckets. Missing categoricals emit
// hash 0 (the padding sentinel).
//
// Exposed as a plain C ABI for ctypes. Built on first use by
// recommender_system_tpu_torch/native/__init__.py with g++ -O3.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kDense = 13;
constexpr int kSparse = 26;
constexpr uint64_t kFnvBasis = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001B3ULL;

inline uint64_t fnv1a(const char* s, size_t n) {
  uint64_t h = kFnvBasis;
  for (size_t i = 0; i < n; ++i) {
    h = (h ^ static_cast<unsigned char>(s[i])) * kFnvPrime;
  }
  return h;
}

inline float parse_float(const char* s, size_t n) {
  if (n == 0) return 0.0f;
  char buf[64];
  size_t m = n < sizeof(buf) - 1 ? n : sizeof(buf) - 1;
  memcpy(buf, s, m);
  buf[m] = '\0';
  return strtof(buf, nullptr);
}

// Parse rows in [begin_row, end_row) of the line-index.
void parse_rows(const char* data, const size_t* line_starts,
                const size_t* line_ends, int64_t begin_row, int64_t end_row,
                float* labels, float* dense, uint64_t* sparse) {
  for (int64_t r = begin_row; r < end_row; ++r) {
    const char* p = data + line_starts[r];
    const char* end = data + line_ends[r];
    int field = 0;
    const char* tok = p;
    float* drow = dense + r * kDense;
    uint64_t* srow = sparse + r * kSparse;
    for (const char* c = p;; ++c) {
      if (c == end || *c == '\t') {
        size_t len = static_cast<size_t>(c - tok);
        if (field == 0) {
          labels[r] = parse_float(tok, len);
        } else if (field <= kDense) {
          drow[field - 1] = parse_float(tok, len);
        } else if (field <= kDense + kSparse) {
          srow[field - kDense - 1] = len ? fnv1a(tok, len) : 0ULL;
        }
        ++field;
        tok = c + 1;
        if (c == end) break;
      }
    }
    // short rows: remaining fields already zero-initialized by caller
  }
}

}  // namespace

extern "C" {

// Count data rows (newlines; a trailing partial line counts).
int64_t criteo_count_rows(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t rows = 0;
  bool pending = false;
  std::vector<char> buf(1 << 20);
  size_t n;
  while ((n = fread(buf.data(), 1, buf.size(), f)) > 0) {
    for (size_t i = 0; i < n; ++i) {
      if (buf[i] == '\n') {
        ++rows;
        pending = false;
      } else {
        pending = true;
      }
    }
  }
  fclose(f);
  return rows + (pending ? 1 : 0);
}

// Parse up to max_rows rows. Outputs must be preallocated:
//   labels [max_rows] f32, dense [max_rows*13] f32 (zeroed),
//   sparse [max_rows*26] u64 (zeroed).
// Returns rows parsed, or -1 on IO error.
int64_t criteo_parse(const char* path, int64_t max_rows, int threads,
                     float* labels, float* dense, uint64_t* sparse) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> data(static_cast<size_t>(size));
  if (size > 0 && fread(data.data(), 1, data.size(), f) != data.size()) {
    fclose(f);
    return -1;
  }
  fclose(f);

  std::vector<size_t> starts, ends;
  starts.reserve(1 << 16);
  ends.reserve(1 << 16);
  size_t pos = 0;
  while (pos < data.size() && static_cast<int64_t>(starts.size()) < max_rows) {
    starts.push_back(pos);
    size_t nl = pos;
    while (nl < data.size() && data[nl] != '\n') ++nl;
    size_t e = nl;
    if (e > pos && data[e - 1] == '\r') --e;  // tolerate CRLF
    ends.push_back(e);
    pos = nl + 1;
  }
  int64_t rows = static_cast<int64_t>(starts.size());
  if (rows == 0) return 0;

  int nthreads = threads > 0 ? threads : 1;
  if (nthreads > rows) nthreads = static_cast<int>(rows);
  std::vector<std::thread> pool;
  int64_t per = (rows + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * per;
    int64_t hi = lo + per < rows ? lo + per : rows;
    if (lo >= hi) break;
    pool.emplace_back(parse_rows, data.data(), starts.data(), ends.data(), lo,
                      hi, labels, dense, sparse);
  }
  for (auto& th : pool) th.join();
  return rows;
}

// Streaming chunk parse: read up to max_rows rows starting at byte *offset
// (must be a line start; 0 for the first call). Only the chunk's bytes are
// resident — RSS is bounded by the chunk, not the file. On return *offset is
// the byte position of the first unparsed line (feed back in for the next
// chunk). Outputs preallocated as for criteo_parse. Returns rows parsed
// (0 = EOF), or -1 on IO error.
int64_t criteo_parse_chunk(const char* path, int64_t* offset, int64_t max_rows,
                           int threads, float* labels, float* dense,
                           uint64_t* sparse) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  const int64_t base = *offset;
  if (fseek(f, static_cast<long>(base), SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  // Grow the in-memory window until it spans max_rows complete lines or EOF;
  // RSS is bounded by the chunk (window grows in 4MB reads).
  std::vector<char> data;
  std::vector<size_t> starts, ends;
  size_t pos = 0;  // scan cursor into `data`
  bool eof = false;
  while (static_cast<int64_t>(starts.size()) < max_rows) {
    // index complete lines available in the current window
    while (pos < data.size() &&
           static_cast<int64_t>(starts.size()) < max_rows) {
      size_t nl = pos;
      while (nl < data.size() && data[nl] != '\n') ++nl;
      if (nl == data.size() && !eof) break;  // partial line: need more bytes
      size_t e = nl;
      if (e > pos && data[e - 1] == '\r') --e;
      if (e > pos) {  // skip empty lines
        starts.push_back(pos);
        ends.push_back(e);
      }
      pos = nl < data.size() ? nl + 1 : nl;
    }
    if (eof || static_cast<int64_t>(starts.size()) >= max_rows) break;
    size_t old = data.size();
    data.resize(old + (1 << 22));
    size_t got = fread(data.data() + old, 1, data.size() - old, f);
    data.resize(old + got);
    eof = got == 0;
  }
  fclose(f);
  int64_t rows = static_cast<int64_t>(starts.size());
  if (rows == 0) {
    *offset = base + static_cast<int64_t>(pos);
    return 0;
  }
  // next offset = byte after the last parsed line's terminator
  size_t after = ends.back();
  while (after < data.size() && data[after] != '\n') ++after;
  *offset = base + static_cast<int64_t>(
                       after < data.size() ? after + 1 : data.size());

  int nthreads = threads > 0 ? threads : 1;
  if (nthreads > rows) nthreads = static_cast<int>(rows);
  std::vector<std::thread> pool;
  int64_t per = (rows + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * per;
    int64_t hi = lo + per < rows ? lo + per : rows;
    if (lo >= hi) break;
    pool.emplace_back(parse_rows, data.data(), starts.data(), ends.data(), lo,
                      hi, labels, dense, sparse);
  }
  for (auto& th : pool) th.join();
  return rows;
}

}  // extern "C"
