// fastio — native text parsers for the tpusolve IO layer.
//
// Counterpart of the reference's hot host-side readers: the
// whole-file mmap MatrixMarket scan (ref: src/HypreSystem.cpp:1751-1835)
// and the HYPRE-IJ fscanf loops (ref: src/HypreSystem.cpp:1203-1236).
// Parses numeric triplet/pair/single-column text bodies at memory speed;
// exposed to Python via ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC fastio.cpp -o libfastio.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// skip spaces/tabs
inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* skip_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

inline const char* parse_ll(const char* p, const char* end, int64_t* out) {
    p = skip_ws(p, end);
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) { neg = *p == '-'; ++p; }
    int64_t v = 0;
    const char* start = p;
    while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
    if (p == start) return nullptr;
    *out = neg ? -v : v;
    return p;
}

inline const char* parse_double(const char* p, const char* end, double* out) {
    // skip_ws is the only whitespace consumer: strtod would also skip
    // newlines, so a short line would silently bleed into the next row.
    p = skip_ws(p, end);
    if (p >= end || *p == '\n') return nullptr;
    char* q = nullptr;
    // the buffer is NUL-terminated by map_file, so strtod cannot overrun
    *out = strtod(p, &q);
    if (q == p) return nullptr;
    return q;
}

// Whole-file load with a NUL terminator so strtod can never overrun
// (an mmap of the exact file size has no guard byte).
struct Mapped {
    char* data = nullptr;
    size_t size = 0;
    bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
    Mapped m;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return m;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) { close(fd); return m; }
    char* buf = static_cast<char*>(malloc(st.st_size + 1));
    if (!buf) { close(fd); return m; }
    size_t got = 0;
    while (got < static_cast<size_t>(st.st_size)) {
        ssize_t r = read(fd, buf + got, st.st_size - got);
        if (r <= 0) break;
        got += r;
    }
    close(fd);
    buf[got] = '\0';
    m.data = buf;
    m.size = got;
    return m;
}

void unmap(Mapped& m) {
    free(m.data);
}

}  // namespace

extern "C" {

// Parse up to max_entries lines of "int int [double [double]]" after
// skipping skip_lines lines (header/banner/size lines and %-comments are
// skipped automatically).  ncols selects the line shape:
//   2 -> rows, cols            (pattern)
//   3 -> rows, cols, vals
//   4 -> rows, cols, vals(re), vals(im)  (imag stored to vals2)
// Returns the number of entries parsed, or -1 on open failure.
int64_t fastio_parse_triplets(const char* path, int64_t skip_lines,
                              int32_t ncols, int64_t max_entries,
                              int64_t* rows, int64_t* cols, double* vals,
                              double* vals2) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    const char* p = m.data;
    const char* end = m.data + m.size;
    for (int64_t i = 0; i < skip_lines && p < end; ++i) p = skip_line(p, end);
    int64_t n = 0;
    while (p < end && n < max_entries) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (*p == '\n') { ++p; continue; }
        if (*p == '%' || *p == '#') { p = skip_line(p, end); continue; }
        int64_t r, c;
        const char* q = parse_ll(p, end, &r);
        if (!q) { p = skip_line(p, end); continue; }
        q = parse_ll(q, end, &c);
        if (!q) { p = skip_line(p, end); continue; }
        double v = 1.0, v2 = 0.0;
        if (ncols >= 3) {
            q = parse_double(q, end, &v);
            if (!q) { p = skip_line(p, end); continue; }
        }
        if (ncols >= 4) {
            q = parse_double(q, end, &v2);
            if (!q) { p = skip_line(p, end); continue; }
        }
        rows[n] = r;
        cols[n] = c;
        if (vals) vals[n] = v;
        if (vals2) vals2[n] = v2;
        ++n;
        p = skip_line(q, end);
    }
    unmap(m);
    return n;
}

// Parse "int double" pair lines (HYPRE-IJ vector bodies).
int64_t fastio_parse_pairs(const char* path, int64_t skip_lines,
                           int64_t max_entries, int64_t* idx, double* vals) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    const char* p = m.data;
    const char* end = m.data + m.size;
    for (int64_t i = 0; i < skip_lines && p < end; ++i) p = skip_line(p, end);
    int64_t n = 0;
    while (p < end && n < max_entries) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (*p == '\n') { ++p; continue; }
        if (*p == '%' || *p == '#') { p = skip_line(p, end); continue; }
        int64_t i;
        const char* q = parse_ll(p, end, &i);
        if (!q) { p = skip_line(p, end); continue; }
        double v;
        q = parse_double(q, end, &v);
        if (!q) { p = skip_line(p, end); continue; }
        idx[n] = i;
        vals[n] = v;
        ++n;
        p = skip_line(q, end);
    }
    unmap(m);
    return n;
}

// Parse single- or double-column float lines (MM array vector bodies).
// width 1 -> vals only; width 2 -> vals + vals2 (complex).
int64_t fastio_parse_floats(const char* path, int64_t skip_lines,
                            int32_t width, int64_t max_entries,
                            double* vals, double* vals2) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    const char* p = m.data;
    const char* end = m.data + m.size;
    for (int64_t i = 0; i < skip_lines && p < end; ++i) p = skip_line(p, end);
    int64_t n = 0;
    while (p < end && n < max_entries) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (*p == '\n') { ++p; continue; }
        if (*p == '%' || *p == '#') { p = skip_line(p, end); continue; }
        double v;
        const char* q = parse_double(p, end, &v);
        if (!q) { p = skip_line(p, end); continue; }
        double v2 = 0.0;
        if (width >= 2) {
            q = parse_double(q, end, &v2);
            if (!q) { p = skip_line(p, end); continue; }
        }
        vals[n] = v;
        if (vals2) vals2[n] = v2;
        ++n;
        p = skip_line(q, end);
    }
    unmap(m);
    return n;
}

}  // extern "C"
