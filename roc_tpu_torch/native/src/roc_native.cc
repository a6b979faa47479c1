// Host graph builders of the port: graph IO, partitioning, halo maps, the
// CSR transpose and the RCM order, in C++ (roc_tpu/native/src/roc_native.cc,
// the entry points the port uses).
//
// The reference reads its graph natively (load_task.cu: per-partition
// fseeko/fread of the .lux byte ranges; gnn.cc:751-872: header read and
// the greedy edge-balanced partition; load_task.cu:25-74: the feature CSV
// parse).  Python (roc_tpu_torch.native) calls these through ctypes; every
// entry point has a NumPy twin in the Python modules, which is its oracle
// in the tests and the path taken under ROC_TPU_NO_NATIVE=1.
//
// Build: g++ -O3 -fPIC -std=c++17 -shared (roc_tpu_torch/native/__init__.py,
// at first use).  ABI: plain C symbols; every buffer is a caller-allocated
// NumPy array.

#include <fcntl.h>
#include <locale.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// .lux layout (roc_tpu_torch/graph/lux.py): u32 numNodes, u64 numEdges,
// u64 raw_rows[numNodes] (inclusive end offsets), u32 raw_cols[numEdges].
static const long HEADER_SIZE = 12;  // sizeof(u32) + sizeof(u64)

// Returns 0 on success; fills *num_nodes / *num_edges.
int roc_lux_header(const char* path, uint32_t* num_nodes,
                   uint64_t* num_edges) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int ok = fread(num_nodes, sizeof(uint32_t), 1, f) == 1 &&
           fread(num_edges, sizeof(uint64_t), 1, f) == 1;
  fclose(f);
  return ok ? 0 : -2;
}

// Rows [row_lo, row_hi) of the offset section and cols [col_lo, col_hi) of
// the column section: the per-partition seeking of the reference's
// load_graph_impl.  A whole-graph read is one slice.
int roc_lux_read_slice(const char* path, uint64_t row_lo, uint64_t row_hi,
                       uint64_t col_lo, uint64_t col_hi,
                       uint64_t* rows_out, uint32_t* cols_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint32_t nv;
  uint64_t ne;
  if (fread(&nv, sizeof nv, 1, f) != 1 || fread(&ne, sizeof ne, 1, f) != 1) {
    fclose(f);
    return -2;
  }
  if (row_hi > nv || col_hi > ne || row_lo > row_hi || col_lo > col_hi) {
    fclose(f);
    return -3;
  }
  int rc = 0;
  uint64_t nrows = row_hi - row_lo, ncols = col_hi - col_lo;
  if (nrows) {
    if (fseeko(f, HEADER_SIZE + 8 * (off_t)row_lo, SEEK_SET) != 0 ||
        fread(rows_out, 8, nrows, f) != nrows)
      rc = -4;
  }
  if (rc == 0 && ncols) {
    if (fseeko(f, HEADER_SIZE + 8 * (off_t)nv + 4 * (off_t)col_lo,
               SEEK_SET) != 0 ||
        fread(cols_out, 4, ncols, f) != ncols)
      rc = -5;
  }
  fclose(f);
  return rc;
}

// The reference's greedy edge-balanced contiguous cut (gnn.cc:806-829):
// accumulate in-degrees, open a new part when the running count exceeds
// ceil(E/P).  raw_rows are inclusive end offsets (the on-disk form).
// bounds_out: [cap][2] inclusive vertex ranges.  Returns the number of
// parts produced, which may exceed num_parts on a skewed graph (Python
// repairs, where the reference would have assert-failed); only the first
// cap are written, so a caller sizes a second call by the first's count.
int64_t roc_partition(const uint64_t* raw_rows, uint64_t num_nodes,
                      uint64_t num_edges, int64_t num_parts,
                      int64_t* bounds_out, int64_t cap) {
  if (num_parts < 1 || num_nodes == 0) return 0;
  uint64_t edge_cap = (num_edges + num_parts - 1) / num_parts;
  uint64_t cnt = 0, left = 0;
  int64_t p = 0;
  for (uint64_t v = 0; v < num_nodes; v++) {
    cnt += raw_rows[v] - (v ? raw_rows[v - 1] : 0);
    if (cnt > edge_cap) {
      if (p < cap) {
        bounds_out[2 * p] = (int64_t)left;
        bounds_out[2 * p + 1] = (int64_t)v;
      }
      p++;
      cnt = 0;
      left = v + 1;
    }
  }
  if (cnt > 0 || left < num_nodes) {
    if (p < cap) {
      bounds_out[2 * p] = (int64_t)left;
      bounds_out[2 * p + 1] = (int64_t)num_nodes - 1;
    }
    p++;
  }
  return p;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The feature CSV (the reference's cold start before it writes .feats.bin,
// load_task.cu:44-66), read as np.loadtxt(path, delimiter=",",
// dtype=np.float32) reads it, element for element:
//   - lines end at "\n", "\r\n" or "\r" (Python's universal newlines);
//   - a '#' starts a comment that runs to the end of its line, and a line
//     left empty is skipped ("  " is not empty: it is a malformed row);
//   - each field is stripped of Python's ASCII whitespace, then holds
//     Python's float grammar: an optional sign, then digits with an
//     optional point and an optional exponent, or inf, infinity or nan in
//     any case (no hex, no underscores, no "nan(...)");
//   - it is parsed to double, correctly rounded (strtod_l in the C
//     locale), then rounded to float, as NumPy converts to float32.
// The file is mapped and cut into one range of whole lines per core: a
// first pass finds each range's data lines, which fixes every row's index,
// and a second parses them.
// ---------------------------------------------------------------------------

namespace {

struct CsvLine {
  const char* begin;
  const char* end;  // at the terminator or the comment's '#'
};

// str.isspace() in ASCII: what np.loadtxt strips around a field.
inline bool py_space(char c) {
  return c == ' ' || (c >= '\t' && c <= '\r') || (c >= '\x1c' && c <= '\x1f');
}

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// [p, b) is the lower-case word w, in any case.
bool ieq(const char* p, const char* b, const char* w) {
  for (; p < b && *w; p++, w++)
    if ((*p | 0x20) != *w) return false;
  return p == b && !*w;
}

// One field [a, b) as np.loadtxt converts it to float32; false when it is
// not a number.
bool parse_field(const char* a, const char* b, float* out) {
  static const locale_t c_locale = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  while (a < b && py_space(*a)) a++;
  while (b > a && py_space(b[-1])) b--;
  const char* p = a;
  bool neg = false;
  if (p < b && (*p == '+' || *p == '-')) neg = *p++ == '-';
  if (p == b) return false;
  if (!is_digit(*p) && *p != '.') {
    if (ieq(p, b, "inf") || ieq(p, b, "infinity")) {
      *out = neg ? -std::numeric_limits<float>::infinity()
                 : std::numeric_limits<float>::infinity();
      return true;
    }
    if (ieq(p, b, "nan")) {
      *out = std::copysign(std::numeric_limits<float>::quiet_NaN(),
                           neg ? -1.0f : 1.0f);
      return true;
    }
    return false;
  }
  int digits = 0;
  for (; p < b && is_digit(*p); p++) digits++;
  if (p < b && *p == '.')
    for (p++; p < b && is_digit(*p); p++) digits++;
  if (digits == 0) return false;
  if (p < b && (*p == 'e' || *p == 'E')) {
    p++;
    if (p < b && (*p == '+' || *p == '-')) p++;
    int exp_digits = 0;
    for (; p < b && is_digit(*p); p++) exp_digits++;
    if (exp_digits == 0) return false;
  }
  if (p != b) return false;
  // strtod needs a terminated string, and the mapping may end at b
  char buf[64];
  std::string big;
  size_t n = (size_t)(b - a);
  const char* s = buf;
  if (n < sizeof buf) {
    memcpy(buf, a, n);
    buf[n] = '\0';
  } else {
    big.assign(a, n);
    s = big.c_str();
  }
  *out = (float)strtod_l(s, nullptr, c_locale);
  return true;
}

// The line that starts at p: its content into *line, and where the next
// line starts.
const char* next_line(const char* p, const char* end, CsvLine* line) {
  const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
  const char* stop = nl ? nl : end;
  const char* cr = (const char*)memchr(p, '\r', (size_t)(stop - p));
  const char* term = cr ? cr : stop;
  const char* next = cr ? (cr + 1 < end && cr[1] == '\n' ? cr + 2 : cr + 1)
                        : (nl ? nl + 1 : end);
  const char* hash = (const char*)memchr(p, '#', (size_t)(term - p));
  *line = {p, hash ? hash : term};
  return next;
}

// The first line start at or after q.
const char* line_start(const char* base, const char* q, const char* end) {
  for (; q > base && q < end; q++)
    if (q[-1] == '\n' || (q[-1] == '\r' && *q != '\n')) break;
  return q;
}

// Parse data lines into rows [row0, row0 + lines.size()): the first
// malformed row, or -1.
int64_t parse_lines(const std::vector<CsvLine>& lines, int64_t row0,
                    int64_t num_cols, float* out) {
  for (size_t i = 0; i < lines.size(); i++) {
    const char* p = lines[i].begin;
    const char* end = lines[i].end;
    float* row = out + (row0 + (int64_t)i) * num_cols;
    for (int64_t c = 0; c < num_cols; c++) {
      const char* comma = (const char*)memchr(p, ',', (size_t)(end - p));
      const char* b = comma ? comma : end;
      bool last = c + 1 == num_cols;
      if ((last ? comma != nullptr : comma == nullptr) ||
          !parse_field(p, b, row + c))
        return row0 + (int64_t)i;
      p = b + 1;
    }
  }
  return -1;
}

// fn(t) for t in [0, n): on n - 1 threads and this one (a part whose
// thread cannot start runs here).
template <class F>
void run_parallel(int n, F fn) {
  std::vector<std::thread> pool;
  for (int t = 1; t < n; t++) {
    try {
      pool.emplace_back(fn, t);
    } catch (...) {
      fn(t);
    }
  }
  fn(0);
  for (auto& th : pool) th.join();
}

int usable_cores() {
  cpu_set_t set;
  if (sched_getaffinity(0, sizeof set, &set) != 0) return 1;
  return std::max(1, CPU_COUNT(&set));
}

}  // namespace

extern "C" {

// Returns the rows parsed; -1 when the file does not open; -(r + 2) for a
// malformed data row r (an empty or non-numeric field, too few or too many
// fields); the count of data rows when it is not num_rows (nothing is
// parsed then).
int64_t roc_parse_feats_csv(const char* path, int64_t num_rows,
                            int64_t num_cols, float* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  size_t size = (size_t)st.st_size;
  const char* base = nullptr;
  if (size > 0) {
    void* m = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) {
      close(fd);
      return -1;
    }
    base = (const char*)m;
  }
  close(fd);
  const char* end = base + size;
  // one range of whole lines per core, each at least 1 MiB
  int T = (int)std::min<size_t>((size_t)std::min(usable_cores(), 64),
                                std::max<size_t>(1, size >> 20));
  std::vector<const char*> cut(T + 1, end);
  for (int t = 0; t < T; t++)
    cut[t] = line_start(base, base + size / T * t, end);
  std::vector<std::vector<CsvLine>> lines(T);
  run_parallel(T, [&](int t) {
    CsvLine line;
    for (const char* p = cut[t]; p < cut[t + 1];) {
      p = next_line(p, end, &line);
      if (line.end > line.begin) lines[t].push_back(line);
    }
  });
  std::vector<int64_t> row0(T + 1, 0);
  for (int t = 0; t < T; t++)
    row0[t + 1] = row0[t] + (int64_t)lines[t].size();
  int64_t rc = row0[T];
  if (rc == num_rows) {
    std::vector<int64_t> bad(T, -1);
    run_parallel(T, [&](int t) {
      bad[t] = parse_lines(lines[t], row0[t], num_cols, out);
    });
    for (int t = 0; t < T; t++)
      if (bad[t] >= 0) {
        rc = -(bad[t] + 2);
        break;
      }
  }
  if (base) munmap((void*)base, size);
  return rc;
}

// ---------------------------------------------------------------------------
// Halo maps (roc_tpu_torch/parallel/halo.py).  For each destination part p
// the per-(p, q) send lists are the sorted unique remote padded-global
// sources grouped by owner q; each edge source is remapped into the
// combined table [S own rows ++ P*K received rows].  Two calls: the sizes
// (which fix K), then the fill.  A byte mark over the padded id space
// [0, P*S) makes "sorted unique remote sources" a linear scan (padded ids
// are (owner, local)-ordered), and the per-edge remap a direct lookup.
// ---------------------------------------------------------------------------

// sizes_out: [P*P] int64, sizes_out[p*P+q] = rows part p needs from part q.
int roc_halo_sizes(const int64_t* edge_src, int64_t P, int64_t E, int64_t S,
                   int64_t* sizes_out) {
  std::vector<uint8_t> mark((size_t)(P * S));
  for (int64_t p = 0; p < P; p++) {
    memset(mark.data(), 0, mark.size());
    const int64_t* src = edge_src + p * E;
    int64_t own_lo = p * S, own_hi = own_lo + S;
    for (int64_t e = 0; e < E; e++) {
      int64_t s = src[e];
      if (s < 0 || s >= P * S) return -2;
      if (s < own_lo || s >= own_hi) mark[(size_t)s] = 1;
    }
    int64_t* row = sizes_out + p * P;
    for (int64_t q = 0; q < P; q++) {
      const uint8_t* b = mark.data() + q * S;
      int64_t cnt = 0;
      for (int64_t i = 0; i < S; i++) cnt += b[i];
      row[q] = cnt;
    }
  }
  return 0;
}

// send_idx_out: [P*P*K] int32 in (q, p, k) layout, every entry written (the
// pad is S-1).  edge_src_local_out: [P*E] int32 into [0, S + P*K).
int roc_halo_fill(const int64_t* edge_src, int64_t P, int64_t E, int64_t S,
                  int64_t K, int32_t* send_idx_out,
                  int32_t* edge_src_local_out) {
  for (int64_t i = 0; i < P * P * K; i++)
    send_idx_out[i] = (int32_t)(S - 1);
  std::vector<uint8_t> mark((size_t)(P * S));
  std::vector<int32_t> lut((size_t)(P * S));  // padded id -> combined index
  for (int64_t p = 0; p < P; p++) {
    memset(mark.data(), 0, mark.size());
    const int64_t* src = edge_src + p * E;
    int64_t own_lo = p * S, own_hi = own_lo + S;
    for (int64_t e = 0; e < E; e++) {
      int64_t s = src[e];
      if (s < 0 || s >= P * S) return -2;
      if (s < own_lo || s >= own_hi) mark[(size_t)s] = 1;
    }
    for (int64_t q = 0; q < P; q++) {
      if (q == p) continue;
      const uint8_t* b = mark.data() + q * S;
      int32_t* send_row = send_idx_out + (q * P + p) * K;
      int64_t pos = 0;
      for (int64_t i = 0; i < S; i++) {
        if (b[i]) {
          if (pos >= K) return -1;  // K too small
          send_row[pos] = (int32_t)i;
          lut[(size_t)(q * S + i)] = (int32_t)(S + q * K + pos);
          pos++;
        }
      }
    }
    int32_t* out = edge_src_local_out + p * E;
    for (int64_t e = 0; e < E; e++) {
      int64_t s = src[e];
      out[e] = (s >= own_lo && s < own_hi) ? (int32_t)(s - own_lo)
                                           : lut[(size_t)s];
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// CSR transpose (roc_tpu_torch/graph/csr.py): a stable counting sort by
// source, O(E) where the NumPy argsort is O(E log E).  Stable, so the
// transposed cols are the destinations in forward edge order within each
// source, element-equal to the NumPy oracle.  It also writes the edge map
// when t_order is not null: t_order[e'] is the forward edge that edge e' of
// the transpose is, which equals np.argsort(col_idx, kind="stable").
// row_ptr [N+1] int64 exclusive prefix; col_idx [E] int32 sources; outputs
// t_row_ptr [N+1], t_col_idx [E] and t_order [E] int64.  Returns 0, or -1
// when a source lies outside [0, N) (nothing past the check is written).
// ---------------------------------------------------------------------------

int roc_csr_transpose(const int64_t* row_ptr, const int32_t* col_idx,
                      int64_t N, int64_t E, int64_t* t_row_ptr,
                      int32_t* t_col_idx, int64_t* t_order) {
  std::fill(t_row_ptr, t_row_ptr + N + 1, 0);
  for (int64_t e = 0; e < E; e++) {
    int32_t s = col_idx[e];
    if (s < 0 || s >= N) return -1;
    t_row_ptr[s + 1]++;
  }
  for (int64_t v = 0; v < N; v++) t_row_ptr[v + 1] += t_row_ptr[v];
  std::vector<int64_t> pos(t_row_ptr, t_row_ptr + N);
  for (int64_t v = 0; v < N; v++) {  // the destination of edge e is row v
    for (int64_t e = row_ptr[v]; e < row_ptr[v + 1]; e++) {
      int64_t at = pos[col_idx[e]]++;
      t_col_idx[at] = (int32_t)v;
      if (t_order) t_order[at] = e;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// RCM locality order (roc_tpu_torch/graph/reorder.py): a level-synchronous
// BFS from minimum-degree seeds over in- plus out-neighbors, each level
// sorted by (degree, id), isolated vertices appended, the whole order
// reversed.  The (degree, id) order is total, so this matches the NumPy
// oracle element for element.  Inputs: the in-edge CSR and its transpose.
// Output: order_out [N], order[new_id] = old_id.  Returns 0.
// ---------------------------------------------------------------------------

int roc_rcm_order(const int64_t* row_ptr, const int32_t* col_idx,
                  const int64_t* t_row_ptr, const int32_t* t_col_idx,
                  int64_t N, int64_t* order_out) {
  if (N == 0) return 0;
  std::vector<int64_t> deg(N), self_cnt(N, 0);
  for (int64_t v = 0; v < N; v++) {
    deg[v] = (row_ptr[v + 1] - row_ptr[v]) +
             (t_row_ptr[v + 1] - t_row_ptr[v]);
    for (int64_t e = row_ptr[v]; e < row_ptr[v + 1]; e++)
      if (col_idx[e] == v) self_cnt[v]++;
  }
  std::vector<char> visited(N, 0);
  std::vector<int64_t> order;
  order.reserve(N);
  std::vector<int64_t> isolated;
  for (int64_t v = 0; v < N; v++)
    if (deg[v] - 2 * self_cnt[v] == 0) {
      visited[v] = 1;
      isolated.push_back(v);
    }
  // the seed scan in (degree, id) order: a stable sort of ids by degree
  std::vector<int64_t> seeds(N);
  for (int64_t v = 0; v < N; v++) seeds[v] = v;
  std::stable_sort(seeds.begin(), seeds.end(),
                   [&](int64_t a, int64_t b) { return deg[a] < deg[b]; });
  std::vector<int64_t> frontier, next;
  size_t seed_pos = 0;
  while (true) {
    while (seed_pos < (size_t)N && visited[seeds[seed_pos]]) seed_pos++;
    if (seed_pos >= (size_t)N) break;
    frontier.assign(1, seeds[seed_pos]);
    visited[seeds[seed_pos]] = 1;
    while (!frontier.empty()) {
      order.insert(order.end(), frontier.begin(), frontier.end());
      next.clear();
      for (int64_t u : frontier) {
        for (int64_t e = row_ptr[u]; e < row_ptr[u + 1]; e++) {
          int64_t w = col_idx[e];
          if (!visited[w]) { visited[w] = 1; next.push_back(w); }
        }
        for (int64_t e = t_row_ptr[u]; e < t_row_ptr[u + 1]; e++) {
          int64_t w = t_col_idx[e];
          if (!visited[w]) { visited[w] = 1; next.push_back(w); }
        }
      }
      // (degree, id): by id first (the claim order above is arbitrary),
      // then stable by degree
      std::sort(next.begin(), next.end());
      std::stable_sort(next.begin(), next.end(), [&](int64_t a, int64_t b) {
        return deg[a] < deg[b];
      });
      frontier.swap(next);
    }
  }
  order.insert(order.end(), isolated.begin(), isolated.end());
  for (int64_t i = 0; i < N; i++) order_out[i] = order[N - 1 - i];
  return 0;
}

}  // extern "C"
