// Native trial-data runtime: fast DLC-table parsing and threaded batch
// loading.
//
// The PyTorch port's copy of cheetah_pose_estimation_tpu/native/src/
// dlc_loader.cpp, the same code: parsing the per-camera DLC CSV tables and
// packing the gated measurement/weight tensors is pure host work, done here
// in C++ with a thread pool. Both packages' parses agree to the bit.
//
// C ABI (consumed from Python via ctypes):
//   ctl_probe_csv(path, *n_frames, *n_markers)        -> 0 on success
//   ctl_parse_dlc_csv(path, xy, lik, index, cap, nm)  -> rows parsed or <0
//   ctl_load_trials(paths, n, xy, lik, index, caps, nm, n_threads)
//       parallel parse of n tables into caller-provided buffers; returns 0.
//
// Buffers are float32 (xy: rows*nm*2, lik: rows*nm) and int32 frame indices,
// caller-allocated (numpy). No allocations cross the ABI.

#include <atomic>
#include <cctype>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) {
      ::close(fd);
      fd = -1;
      return false;
    }
    size = static_cast<size_t>(st.st_size);
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
      ::close(fd);
      fd = -1;
      return false;
    }
    data = static_cast<const char*>(p);
    return true;
  }

  ~MappedFile() {
    if (data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

// fast float parser for simple decimal/scientific notation (CSV cells);
// falls back to strtod for anything unusual.
inline double parse_float(const char* p, const char* end, const char** out) {
  while (p < end && (*p == ' ')) ++p;
  if (p >= end) {
    *out = p;
    return NAN;
  }
  // empty cell -> NaN
  if (*p == ',' || *p == '\n' || *p == '\r') {
    *out = p;
    return NAN;
  }
  char* e = nullptr;
  double v = strtod(p, &e);
  if (e == p) {
    // non-numeric token (e.g. "nan"): skip to delimiter
    while (p < end && *p != ',' && *p != '\n' && *p != '\r') ++p;
    *out = p;
    return NAN;
  }
  *out = e;
  return v;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

int count_columns(const char* p, const char* end) {
  int n = 1;
  while (p < end && *p != '\n') {
    if (*p == ',') ++n;
    ++p;
  }
  return n;
}

// A DLC table: 3 header lines (scorer / bodyparts / coords) or 2 header
// lines (bodyparts / coords, as in cam*_fte.csv), then rows of
// index, (x, y, likelihood) * n_markers.
struct ParseResult {
  int rows = 0;
  int markers = 0;
  int header_lines = 0;
};

int probe(const MappedFile& f, ParseResult* out) {
  const char* p = f.data;
  const char* end = f.data + f.size;
  // count header lines: lines whose first cell is not a number
  int header = 0;
  const char* q = p;
  while (q < end && header < 4) {
    const char* cell_end = q;
    while (cell_end < end && *cell_end != ',' && *cell_end != '\n') ++cell_end;
    bool numeric = cell_end > q;
    for (const char* c = q; c < cell_end && numeric; ++c) {
      if (!(isdigit(*c) || *c == '-' || *c == '+' || *c == '.')) {
        numeric = false;
      }
    }
    if (numeric) break;
    ++header;
    q = next_line(q, end);
  }
  int cols = count_columns(q, end);
  if ((cols - 1) % 3 != 0) return -2;
  int rows = 0;
  const char* r = q;
  while (r < end) {
    if (*r != '\n' && *r != '\r') ++rows;
    r = next_line(r, end);
  }
  out->rows = rows;
  out->markers = (cols - 1) / 3;
  out->header_lines = header;
  return 0;
}

int parse_into(const MappedFile& f, float* xy, float* lik, int32_t* index,
               int cap_rows, int n_markers) {
  ParseResult pr;
  int rc = probe(f, &pr);
  if (rc != 0) return rc;
  if (pr.markers != n_markers) return -3;
  const char* p = f.data;
  const char* end = f.data + f.size;
  for (int h = 0; h < pr.header_lines; ++h) p = next_line(p, end);
  int row = 0;
  while (p < end && row < cap_rows) {
    if (*p == '\n' || *p == '\r') {
      p = next_line(p, end);
      continue;
    }
    const char* q = p;
    double idx = parse_float(q, end, &q);
    index[row] = static_cast<int32_t>(idx);
    for (int m = 0; m < n_markers; ++m) {
      for (int c = 0; c < 3; ++c) {
        if (q < end && *q == ',') ++q;
        double v = parse_float(q, end, &q);
        if (c < 2) {
          xy[(static_cast<size_t>(row) * n_markers + m) * 2 + c] =
              static_cast<float>(v);
        } else {
          lik[static_cast<size_t>(row) * n_markers + m] =
              static_cast<float>(v);
        }
      }
    }
    ++row;
    p = next_line(p, end);
  }
  return row;
}

}  // namespace

extern "C" {

int ctl_probe_csv(const char* path, int* n_frames, int* n_markers) {
  MappedFile f;
  if (!f.open(path)) return -1;
  ParseResult pr;
  int rc = probe(f, &pr);
  if (rc != 0) return rc;
  *n_frames = pr.rows;
  *n_markers = pr.markers;
  return 0;
}

int ctl_parse_dlc_csv(const char* path, float* xy, float* lik, int32_t* index,
                      int cap_rows, int n_markers) {
  MappedFile f;
  if (!f.open(path)) return -1;
  return parse_into(f, xy, lik, index, cap_rows, n_markers);
}

// parallel multi-table load; xy/lik/index are arrays of per-table pointers.
int ctl_load_trials(const char** paths, int n_paths, float** xy, float** lik,
                    int32_t** index, const int* cap_rows, int n_markers,
                    int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  std::vector<int> rows(n_paths, 0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_paths) return;
      MappedFile f;
      if (!f.open(paths[i])) {
        failures.fetch_add(1);
        continue;
      }
      int r = parse_into(f, xy[i], lik[i], index[i], cap_rows[i], n_markers);
      if (r < 0) failures.fetch_add(1);
      rows[i] = r;
    }
  };
  std::vector<std::thread> threads;
  int nt = n_threads < n_paths ? n_threads : n_paths;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load() == 0 ? 0 : -1;
}

// fused weight gating: w[n, m] = gate(lik > thresh) * inv_R[m]
void ctl_gate_weights(const float* lik, const float* inv_R, float thresh,
                      float* weights, int n_rows, int n_markers) {
  for (int i = 0; i < n_rows; ++i) {
    const float* lrow = lik + static_cast<size_t>(i) * n_markers;
    float* wrow = weights + static_cast<size_t>(i) * n_markers;
    for (int m = 0; m < n_markers; ++m) {
      wrow[m] = lrow[m] > thresh ? inv_R[m] : 0.0f;
    }
  }
}

}  // extern "C"
