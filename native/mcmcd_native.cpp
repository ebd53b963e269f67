// Native runtime support for mcmc_dynamics_jax.
//
// The device compute path is JAX/XLA/Pallas; this library covers the *runtime around
// it*: high-throughput catalog ingest (CSV parse ~10x pandas for plain numeric
// tables), a memory-mapped binary catalog cache for instant reloads of large
// surveys, and the greedy radial binning (exact port of the algorithm contract in
// the reference data_reader.py:96-118, reimplemented here for O(n log n) with no
// Python overhead).
//
// Plain C ABI, consumed through ctypes (no pybind11 in this environment).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <cmath>
#include <algorithm>
#include <numeric>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------- CSV ingest
// Parse a numeric CSV with `n_cols` columns. Rows with a non-numeric first field
// (e.g. the header) are skipped. Returns a row-major buffer owned by the callee;
// release with mcmcd_free. Returns number of rows, or -1 on error.
long mcmcd_read_csv(const char* path, long n_cols, double** out_data) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(size) + 1);
    if (fread(buf.data(), 1, static_cast<size_t>(size), f)
            != static_cast<size_t>(size)) {
        fclose(f);
        return -1;
    }
    fclose(f);
    buf[static_cast<size_t>(size)] = '\0';

    if (n_cols < 1 || n_cols > 64) return -1;  // caller must use the fallback

    std::vector<double> values;
    values.reserve(1 << 20);

    char* p = buf.data();
    char* end = buf.data() + size;
    long rows = 0;
    while (p < end) {
        // one line
        char* line_end = static_cast<char*>(memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        *line_end = '\0';
        if (*p == '\0' || *p == '\r') { p = line_end + 1; continue; }  // blank

        double row[64];
        long col = 0;
        char* q = p;
        bool ok = true;
        // one field per separator: consecutive separators are EMPTY fields and
        // parse as NaN (matching the pandas fallback), not silently-dropped rows
        for (col = 0; col < n_cols; ++col) {
            while (*q == ' ' || *q == '\t') ++q;
            if (*q == ',' || *q == ';' || *q == '\0') {
                row[col] = NAN;  // empty / missing field
            } else {
                char* next = nullptr;
                double v = strtod(q, &next);
                if (next == q) { ok = false; break; }  // non-numeric (header)
                row[col] = v;
                q = next;
                while (*q == ' ' || *q == '\t') ++q;
            }
            if (col + 1 < n_cols) {
                if (*q == ',' || *q == ';') {
                    ++q;  // consume exactly ONE separator
                } else if (*q == '\0') {
                    for (long c2 = col + 1; c2 < n_cols; ++c2) row[c2] = NAN;
                    col = n_cols - 1;
                }
                // whitespace-delimited: the next number simply starts here
            }
        }
        if (ok && col == n_cols) {
            values.insert(values.end(), row, row + n_cols);
            ++rows;
        }
        p = line_end + 1;
    }

    double* out = static_cast<double*>(malloc(values.size() * sizeof(double)));
    if (!out) return -1;
    memcpy(out, values.data(), values.size() * sizeof(double));
    *out_data = out;
    return rows;
}

void mcmcd_free(double* ptr) { free(ptr); }

// ---------------------------------------------------------------- binary cache
// Layout (24-byte header so the float64 payload is 8-aligned):
//   magic 'MCM2' | 4 pad bytes | int64 rows | int64 cols | float64 data.
// Writes land on a temp file and rename() into place: a process killed
// mid-write (ENOSPC, SIGKILL) must never leave a header-valid truncated file
// that would poison every later load.
int mcmcd_cache_write(const char* path, const double* data, long rows, long cols) {
    char tmp[4096];
    if (snprintf(tmp, sizeof(tmp), "%s.tmp.%ld", path,
                 static_cast<long>(getpid())) >= static_cast<int>(sizeof(tmp)))
        return -1;
    FILE* f = fopen(tmp, "wb");
    if (!f) return -1;
    const char magic[4] = {'M', 'C', 'M', '2'};
    const char pad[4] = {0, 0, 0, 0};
    int64_t r = rows, c = cols;
    int ok = fwrite(magic, 1, 4, f) == 4
        && fwrite(pad, 1, 4, f) == 4
        && fwrite(&r, sizeof(r), 1, f) == 1
        && fwrite(&c, sizeof(c), 1, f) == 1
        && fwrite(data, sizeof(double),
                  static_cast<size_t>(rows) * cols, f)
            == static_cast<size_t>(rows) * cols;
    ok = (fclose(f) == 0) && ok;
    if (!ok || rename(tmp, path) != 0) {
        remove(tmp);
        return -1;
    }
    return 0;
}

// mmap the cache; returns pointer to the float64 payload (read-only shared map;
// unmap with mcmcd_cache_close using the same handle).
const double* mcmcd_cache_open(const char* path, long* rows, long* cols,
                               void** handle, long* mapped_size) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
    void* map = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ,
                     MAP_SHARED, fd, 0);
    close(fd);
    if (map == MAP_FAILED) return nullptr;
    const char* base = static_cast<const char*>(map);
    if (st.st_size < 24 || memcmp(base, "MCM2", 4) != 0) {
        munmap(map, static_cast<size_t>(st.st_size));
        return nullptr;
    }
    int64_t r, c;
    memcpy(&r, base + 8, sizeof(r));
    memcpy(&c, base + 16, sizeof(c));
    // reject corrupt/truncated headers BEFORE handing out a payload pointer:
    // reading past the mapping would SIGBUS the whole Python process
    if (r < 0 || c < 0
        || (c > 0 && r > (INT64_MAX - 24) / (8 * c))
        || st.st_size < 24 + 8 * r * c) {
        munmap(map, static_cast<size_t>(st.st_size));
        return nullptr;
    }
    *rows = static_cast<long>(r);
    *cols = static_cast<long>(c);
    *handle = map;
    *mapped_size = static_cast<long>(st.st_size);
    return reinterpret_cast<const double*>(base + 24);
}

void mcmcd_cache_close(void* handle, long mapped_size) {
    if (handle) munmap(handle, static_cast<size_t>(mapped_size));
}

// ---------------------------------------------------------------- radial binning
// Greedy binning: sort by radius, grow each bin until >= nstars members AND
// >= dlogr span in log10(r); tail joins the previous bin unless it holds more than
// nstars/2 stars (or no bin exists). Bin ids written to out (original order).
long mcmcd_radial_bins(const double* r, long n, long nstars, double dlogr,
                       int32_t* out) {
    std::vector<long> order(n);
    std::iota(order.begin(), order.end(), 0L);
    // NaN-safe comparator (NaNs sort last, matching np.argsort): a plain
    // r[a] < r[b] violates strict weak ordering under NaN — undefined
    // behaviour in std::sort, up to out-of-bounds reads
    std::sort(order.begin(), order.end(), [r](long a, long b) {
        const double ra = r[a], rb = r[b];
        if (std::isnan(ra)) return false;
        if (std::isnan(rb)) return true;
        return ra < rb;
    });

    std::vector<int32_t> bins(n, -1);
    long i = 0;
    int32_t current = -1;
    while (i < n - nstars) {
        long j = std::min(n, i + nstars);
        while (j < n && (std::log10(r[order[j]]) - std::log10(r[order[i]])) < dlogr)
            ++j;
        if (j >= n) break;
        ++current;
        for (long k = i; k < j; ++k) bins[k] = current;
        i = j;
    }
    if ((n - i) > nstars / 2.0 || current == -1) {
        ++current;
        for (long k = i; k < n; ++k) bins[k] = current;
    } else {
        for (long k = i; k < n; ++k) bins[k] = current;
    }

    for (long k = 0; k < n; ++k) out[order[k]] = bins[k];
    return current + 1;
}

}  // extern "C"
