// Native host-side hot loops for tehmm_tpu_torch (the port's own copy of
// tehmm_tpu/tehmm_native.cpp; the one change is the relaxed atomic store
// of bin_scale_f64's presence flags).
//
// The reference leans on bedtools/bx-python C/C++ extensions for its
// genomic I/O hot paths (reference: trackIO.py via pybedtools/bx-python;
// SURVEY.md §2a "Native code in the dependency chain").  Neither is
// available here, so this library provides the equivalents the Python
// layer shells into via ctypes (tehmm_tpu_torch/native.py):
//
//   * bed_parse / bed_*      — mmap-free streaming BED parser returning
//                              columnar arrays (starts, ends, chrom ids,
//                              value-string table indices)
//   * fill_intervals_u16     — paint (start,end,symbol) runs into a
//                              per-position column
//   * count_transitions     — supervised adjacency counting
//   * count_emissions       — supervised symbol counting
//   * runs_encode           — state-path -> (start,end,state) runs
//
// Build: g++ -O3 -shared -fPIC (driven by tehmm_tpu_torch/native.py).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------
// BED parsing
// ---------------------------------------------------------------------

struct BedFile {
    std::vector<int64_t> starts;
    std::vector<int64_t> ends;
    std::vector<int32_t> chrom_ids;   // index into chrom_names
    std::vector<int32_t> value_ids;   // index into value_names (-1 = none)
    std::string chrom_names;          // '\n'-joined unique chrom names
    std::string value_names;          // '\n'-joined unique value strings
    int32_t n_chroms = 0;
    int32_t n_values = 0;
};

static int32_t intern(std::unordered_map<std::string, int32_t>& map,
                      std::string& joined, int32_t& counter,
                      const char* s, size_t len) {
    std::string key(s, len);
    auto it = map.find(key);
    if (it != map.end()) return it->second;
    int32_t id = counter++;
    map.emplace(std::move(key), id);
    if (!joined.empty()) joined.push_back('\n');
    joined.append(s, len);
    return id;
}

// value_col: BED column index holding the value (3 = name, 4 = score,
// 5 = strand, >=6 = extra); negative = no value wanted.
void* bed_parse(const char* path, int value_col) {
    FILE* fh = fopen(path, "rb");
    if (!fh) return nullptr;
    auto* bf = new BedFile();
    std::unordered_map<std::string, int32_t> chrom_map, value_map;

    char* line = nullptr;
    size_t cap = 0;
    ssize_t len;
    while ((len = getline(&line, &cap, fh)) != -1) {
        if (len == 0) continue;
        if (line[0] == '#' || line[0] == '\n' || line[0] == '\r') continue;
        if (strncmp(line, "track", 5) == 0 ||
            strncmp(line, "browser", 7) == 0)
            continue;
        // split on tabs (fall back to any whitespace)
        const char* fields[16];
        size_t flens[16];
        int nf = 0;
        char* p = line;
        char* end = line + len;
        while (*(end - 1) == '\n' || *(end - 1) == '\r') {
            --end;
            if (end == line) break;
        }
        bool tabbed = memchr(line, '\t', end - line) != nullptr;
        while (p < end && nf < 16) {
            while (p < end && (tabbed ? *p == '\t'
                                      : (*p == ' ' || *p == '\t')))
                ++p;
            if (p >= end) break;
            char* q = p;
            while (q < end && (tabbed ? *q != '\t'
                                      : (*q != ' ' && *q != '\t')))
                ++q;
            fields[nf] = p;
            flens[nf] = (size_t)(q - p);
            ++nf;
            p = q;
        }
        if (nf < 3) continue;
        bf->chrom_ids.push_back(intern(
            chrom_map, bf->chrom_names, bf->n_chroms,
            fields[0], flens[0]));
        bf->starts.push_back(strtoll(fields[1], nullptr, 10));
        bf->ends.push_back(strtoll(fields[2], nullptr, 10));
        int32_t vid = -1;
        if (value_col >= 3 && value_col < nf) {
            vid = intern(value_map, bf->value_names, bf->n_values,
                         fields[value_col], flens[value_col]);
        }
        bf->value_ids.push_back(vid);
    }
    free(line);
    fclose(fh);
    return bf;
}

int64_t bed_num_records(void* h) {
    return (int64_t)((BedFile*)h)->starts.size();
}
int64_t bed_chrom_names_len(void* h) {
    return (int64_t)((BedFile*)h)->chrom_names.size();
}
int64_t bed_value_names_len(void* h) {
    return (int64_t)((BedFile*)h)->value_names.size();
}

void bed_copy(void* h, int64_t* starts, int64_t* ends,
              int32_t* chrom_ids, int32_t* value_ids,
              char* chrom_names, char* value_names) {
    auto* bf = (BedFile*)h;
    size_t n = bf->starts.size();
    memcpy(starts, bf->starts.data(), n * sizeof(int64_t));
    memcpy(ends, bf->ends.data(), n * sizeof(int64_t));
    memcpy(chrom_ids, bf->chrom_ids.data(), n * sizeof(int32_t));
    memcpy(value_ids, bf->value_ids.data(), n * sizeof(int32_t));
    memcpy(chrom_names, bf->chrom_names.data(), bf->chrom_names.size());
    memcpy(value_names, bf->value_names.data(), bf->value_names.size());
}

void bed_free(void* h) { delete (BedFile*)h; }

// ---------------------------------------------------------------------
// Painting / counting kernels
// ---------------------------------------------------------------------

// Paint n (start,end,symbol) runs into col[0..L), where genome position
// origin maps to col[0].  Later runs overwrite earlier ones.
void fill_intervals_u16(uint16_t* col, int64_t L, int64_t origin,
                        const int64_t* starts, const int64_t* ends,
                        const uint16_t* syms, int64_t n) {
    for (int64_t r = 0; r < n; ++r) {
        int64_t s = starts[r] - origin;
        int64_t e = ends[r] - origin;
        if (s < 0) s = 0;
        if (e > L) e = L;
        if (s >= e) continue;
        uint16_t v = syms[r];
        for (int64_t i = s; i < e; ++i) col[i] = v;
    }
}

// trans[i*S + j] += count of adjacent (states[k]==i, states[k+1]==j).
void count_transitions(const int32_t* states, int64_t n, int32_t S,
                       double* trans) {
    for (int64_t k = 0; k + 1 < n; ++k) {
        int32_t a = states[k], b = states[k + 1];
        if (a >= 0 && b >= 0 && a < S && b < S)
            trans[(int64_t)a * S + b] += 1.0;
    }
}

// em[((s*T)+t)*V + v] += 1 for every position/track.
void count_emissions(const int32_t* states, const uint16_t* symbols,
                     int64_t n, int32_t T, int32_t S, int32_t V,
                     double* em) {
    for (int64_t k = 0; k < n; ++k) {
        int32_t s = states[k];
        if (s < 0 || s >= S) continue;
        const uint16_t* row = symbols + k * T;
        for (int32_t t = 0; t < T; ++t) {
            uint16_t v = row[t];
            if (v < V)
                em[(((int64_t)s * T) + t) * V + v] += 1.0;
        }
    }
}

// Encode a state path into maximal runs.  Returns number of runs;
// starts/ends/states buffers must have capacity n.
int64_t runs_encode(const int32_t* path, int64_t n,
                    int64_t* starts, int64_t* ends, int32_t* states) {
    if (n == 0) return 0;
    int64_t m = 0;
    int64_t run_start = 0;
    for (int64_t i = 1; i <= n; ++i) {
        if (i == n || path[i] != path[run_start]) {
            starts[m] = run_start;
            ends[m] = i;
            states[m] = path[run_start];
            ++m;
            run_start = i;
        }
    }
    return m;
}

}  // extern "C" (template below cannot carry C linkage)

// Interleave T contiguous columns into one row-major [L, T] matrix with
// cache-blocked, threaded writes.  The naive per-column strided write
// (`mat[:, t] = col`) touches a fresh cache line per 2-byte store —
// ~64 B of memory traffic per element, measured ~4 s/track at genome
// scale (round-4 profile); a position block whose T-wide rows fit L1/L2
// turns that into sequential streams (~0.3 s for 250M x 15).
template <typename E>
static void pack_columns_impl(const E* const* cols, int32_t T, int64_t L,
                              E* out, int32_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    const int64_t BLOCK = 8192;
    auto work = [&](int64_t tid) {
        for (int64_t lo = tid * BLOCK; lo < L;
             lo += (int64_t)n_threads * BLOCK) {
            int64_t hi = lo + BLOCK < L ? lo + BLOCK : L;
            for (int32_t t = 0; t < T; ++t) {
                const E* c = cols[t];
                E* o = out + lo * T + t;
                for (int64_t i = lo; i < hi; ++i, o += T) *o = c[i];
            }
        }
    };
    if (n_threads == 1) {
        work(0);
    } else {
        std::vector<std::thread> threads;
        for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
        for (auto& th : threads) th.join();
    }
}

extern "C" {

void pack_columns_u16(const uint16_t* const* cols, int32_t T, int64_t L,
                      uint16_t* out, int32_t n_threads) {
    pack_columns_impl(cols, T, L, out, n_threads);
}

void pack_columns_f32(const float* const* cols, int32_t T, int64_t L,
                      float* out, int32_t n_threads) {
    pack_columns_impl(cols, T, L, out, n_threads);
}

// ---------------------------------------------------------------------
// FASTA indexing (reference: bx-python / samtools-faidx style random
// access; SURVEY.md §2a trackIO row).  Mirrors io/fasta.py's Python
// scanner exactly — same ragged-line validation, same blank-line
// semantics — at C getline speed (the Python loop indexed ~12 MB/s,
// i.e. minutes for a whole genome).
// ---------------------------------------------------------------------

struct FaIndex {
    std::string names;                // '\n'-joined record names
    std::vector<int64_t> data_start;
    std::vector<int64_t> seq_len;
    std::vector<int64_t> line_base;
    std::vector<int64_t> line_full;
    int64_t error_line = 0;           // >0: ragged line detected there
    int32_t error_kind = 0;           // 1 = interior short, 2 = longer
};

void* fasta_index(const char* path) {
    FILE* fh = fopen(path, "rb");
    if (!fh) return nullptr;
    auto* fx = new FaIndex();

    bool have_rec = false;
    int64_t data_start = 0, seq_len = 0, line_base = 0, line_full = 0;
    int64_t n_names = 0;
    bool first_line = true, pending_short = false;

    auto commit = [&]() {
        if (have_rec) {
            fx->data_start.push_back(data_start);
            fx->seq_len.push_back(seq_len);
            fx->line_base.push_back(line_base);
            fx->line_full.push_back(line_full);
        }
    };

    char* line = nullptr;
    size_t cap = 0;
    ssize_t ll;
    int64_t offset = 0, lineno = 0;
    while ((ll = getline(&line, &cap, fh)) != -1) {
        ++lineno;
        int64_t blen = ll;            // length without trailing \r\n
        while (blen > 0 &&
               (line[blen - 1] == '\n' || line[blen - 1] == '\r'))
            --blen;
        if (blen > 0 && line[0] == '>') {
            commit();
            // name = first whitespace-separated token after '>'
            // (Python: line[1:].split()[0] — leading blanks skipped)
            int64_t st = 1;
            while (st < blen && (line[st] == ' ' || line[st] == '\t'))
                ++st;
            int64_t e = st;
            while (e < blen && line[e] != ' ' && line[e] != '\t') ++e;
            if (e == st) {          // '>' with no name at all
                fx->error_line = lineno;
                fx->error_kind = 3;
                break;
            }
            // separator keyed on the record COUNT, not names.empty():
            // an empty first name must not silently misalign the join
            if (n_names++) fx->names.push_back('\n');
            fx->names.append(line + st, (size_t)(e - st));
            have_rec = true;
            data_start = offset + ll;
            seq_len = 0;
            line_base = 0;
            line_full = 0;
            first_line = true;
            pending_short = false;
        } else if (blen == 0 && have_rec) {
            if (seq_len == 0) {
                data_start = offset + ll;   // blank after header
            } else {
                pending_short = true;       // blank inside a body
            }
        } else if (blen > 0) {
            if (pending_short) {
                fx->error_line = lineno;
                fx->error_kind = 1;
                break;
            }
            if (first_line) {
                line_base = blen;
                line_full = ll;
                first_line = false;
            } else if (blen < line_base) {
                pending_short = true;
            } else if (blen > line_base) {
                fx->error_line = lineno;
                fx->error_kind = 2;
                break;
            }
            seq_len += blen;
        }
        offset += ll;
    }
    free(line);
    fclose(fh);
    commit();
    return fx;
}

int64_t fasta_index_num(void* h) {
    return (int64_t)((FaIndex*)h)->data_start.size();
}
int64_t fasta_index_names_len(void* h) {
    return (int64_t)((FaIndex*)h)->names.size();
}
int64_t fasta_index_error(void* h, int32_t* kind) {
    *kind = ((FaIndex*)h)->error_kind;
    return ((FaIndex*)h)->error_line;
}
void fasta_index_copy(void* h, int64_t* data_start, int64_t* seq_len,
                      int64_t* line_base, int64_t* line_full,
                      char* names) {
    auto* fx = (FaIndex*)h;
    size_t n = fx->data_start.size();
    memcpy(data_start, fx->data_start.data(), n * sizeof(int64_t));
    memcpy(seq_len, fx->seq_len.data(), n * sizeof(int64_t));
    memcpy(line_base, fx->line_base.data(), n * sizeof(int64_t));
    memcpy(line_full, fx->line_full.data(), n * sizeof(int64_t));
    memcpy(names, fx->names.data(), fx->names.size());
}
void fasta_index_free(void* h) { delete (FaIndex*)h; }

// ---------------------------------------------------------------------
// BigWig data-section decode (reference: bx-python's C BigWig reader,
// SURVEY.md §2a trackIO row).  The Python layer walks the R-tree and
// hands over the concatenated raw section bytes; this kernel inflates
// and paints them — the per-block zlib+parse loop is what bounded the
// pure-Python reader at ~10 Mbase/s on 1-bp signal tracks.
// ---------------------------------------------------------------------

static inline uint16_t rd_u16(const uint8_t* p) {
    uint16_t v;
    memcpy(&v, p, 2);
    return v;
}
static inline uint32_t rd_u32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}
static inline float rd_f32(const uint8_t* p) {
    float v;
    memcpy(&v, p, 4);
    return v;
}

// Paint one UNCOMPRESSED section into out[0..q_end-q_start).
static void paint_section(const uint8_t* sec, int64_t sec_len,
                          uint32_t chrom_id, int64_t q_start,
                          int64_t q_end, double* out) {
    if (sec_len < 24) return;
    uint32_t b_chrom = rd_u32(sec + 0);
    uint32_t b_start = rd_u32(sec + 4);
    uint32_t item_step = rd_u32(sec + 12);
    uint32_t item_span = rd_u32(sec + 16);
    uint8_t w_type = sec[20];
    uint16_t item_count = rd_u16(sec + 22);
    if (b_chrom != chrom_id) return;
    const uint8_t* body = sec + 24;
    int64_t body_len = sec_len - 24;
    int64_t L = q_end - q_start;
    for (uint16_t k = 0; k < item_count; ++k) {
        int64_t s, e;
        double v;
        if (w_type == 1) {                      // bedGraph
            if ((int64_t)(k + 1) * 12 > body_len) break;
            const uint8_t* it = body + (int64_t)k * 12;
            s = rd_u32(it);
            e = rd_u32(it + 4);
            v = rd_f32(it + 8);
        } else if (w_type == 2) {               // varStep
            if ((int64_t)(k + 1) * 8 > body_len) break;
            const uint8_t* it = body + (int64_t)k * 8;
            s = rd_u32(it);
            e = s + item_span;
            v = rd_f32(it + 4);
        } else if (w_type == 3) {               // fixedStep
            if ((int64_t)(k + 1) * 4 > body_len) break;
            s = (int64_t)b_start + (int64_t)item_step * k;
            e = s + item_span;
            v = rd_f32(body + (int64_t)k * 4);
        } else {
            return;
        }
        int64_t cs = s - q_start, ce = e - q_start;
        if (cs < 0) cs = 0;
        if (ce > L) ce = L;
        for (int64_t i = cs; i < ce; ++i) out[i] = v;
    }
}

// blob: concatenated raw (possibly zlib-compressed) sections;
// offs[n_blocks+1]: byte ranges into blob.  Sections of a well-formed
// BigWig never overlap in genome coordinates, so threads paint their
// own blocks without synchronization.  Returns 0, or -1 on a zlib
// error / undersized uncompress buffer.
int bigwig_paint_blocks(const uint8_t* blob, const int64_t* offs,
                        int64_t n_blocks, int32_t compressed,
                        int64_t ubuf_size, uint32_t chrom_id,
                        int64_t q_start, int64_t q_end, double* out,
                        int32_t n_threads) {
    if (n_blocks <= 0) return 0;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n_blocks) n_threads = (int32_t)n_blocks;
    std::vector<int> errs(n_threads, 0);
    auto work = [&](int tid) {
        std::vector<uint8_t> ubuf(compressed ? (size_t)ubuf_size : 0);
        for (int64_t b = tid; b < n_blocks; b += n_threads) {
            const uint8_t* raw = blob + offs[b];
            int64_t raw_len = offs[b + 1] - offs[b];
            const uint8_t* sec = raw;
            int64_t sec_len = raw_len;
            if (compressed) {
                uLongf dlen = (uLongf)ubuf_size;
                int rc = uncompress(ubuf.data(), &dlen, raw,
                                    (uLong)raw_len);
                if (rc != Z_OK) {
                    errs[tid] = 1;
                    return;
                }
                sec = ubuf.data();
                sec_len = (int64_t)dlen;
            }
            paint_section(sec, sec_len, chrom_id, q_start, q_end, out);
        }
    };
    if (n_threads == 1) {
        work(0);
    } else {
        std::vector<std::thread> threads;
        for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
        for (auto& th : threads) th.join();
    }
    for (int e : errs)
        if (e) return -1;
    return 0;
}

// ---------------------------------------------------------------------
// Scale-binned numeric-track binning (round-5).
//
// Replaces the NumPy block loop in io/trackdata (round-5 profile: the
// f64 add/mul/floor/isnan/astype/bincount chain was ~35 s of the 70 s
// 250M x 15 load).  One fused multithreaded pass with the IDENTICAL
// f64 math as category.bin_value: v = x + shift, then
// floor(v * scale) or floor(log(max(v, 1e-9)) / log(log_base)).
// NaN inputs — and ANY transform whose bin lands outside [0, span)
// (NaN/inf results, or callers whose bmin/span disagree with the
// data) — map to the `span` sentinel: present[] is written only for
// validated in-range bins, so no input can write out of bounds.
// `bmin` is int64: transformed extremes of genome signal tracks can
// exceed int32.  Threads may flag the same bin: each present[b] = 1 is a
// relaxed atomic store, so the concurrent stores are not a data race
// (the threads are joined before the caller reads the flags).
void bin_scale_f64(const double* vals, int64_t n, double shift,
                   double scale, double log_base, int64_t bmin,
                   int32_t span, int32_t* bins, uint8_t* present,
                   int32_t n_threads) {
    const bool use_log = log_base != 0.0;
    const double log_den = use_log ? std::log(log_base) : 1.0;
    auto work = [&](int tid) {
        int64_t chunk = (n + n_threads - 1) / n_threads;
        int64_t lo = (int64_t)tid * chunk;
        int64_t hi = lo + chunk < n ? lo + chunk : n;
        for (int64_t i = lo; i < hi; ++i) {
            double v = vals[i];
            int32_t b = span;
            if (!std::isnan(v)) {
                v += shift;
                double fb = use_log
                    ? std::floor(std::log(v < 1e-9 ? 1e-9 : v)
                                 / log_den)
                    : std::floor(v * scale);
                double fbb = fb - (double)bmin;
                // NaN/inf fbb fails both comparisons -> sentinel
                if (fbb >= 0.0 && fbb < (double)span) {
                    b = (int32_t)fbb;
                    __atomic_store_n(&present[b], (uint8_t)1,
                                     __ATOMIC_RELAXED);
                }
            }
            bins[i] = b;
        }
    };
    if (n_threads <= 1) {
        work(0);
    } else {
        std::vector<std::thread> threads;
        for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
        for (auto& th : threads) th.join();
    }
}

// NaN-skipping min/max in one threaded pass (numpy's nanmin+nanmax
// cost two full sweeps each on genome-scale columns).  Returns 0 when
// at least one finite-or-infinite (non-NaN) value was seen.
int32_t nanminmax_f64(const double* vals, int64_t n, double* out_min,
                      double* out_max, int32_t n_threads) {
    std::vector<double> mins(n_threads, 0.0), maxs(n_threads, 0.0);
    std::vector<uint8_t> seen(n_threads, 0);
    auto work = [&](int tid) {
        int64_t chunk = (n + n_threads - 1) / n_threads;
        int64_t lo = (int64_t)tid * chunk;
        int64_t hi = lo + chunk < n ? lo + chunk : n;
        double mn = 0.0, mx = 0.0;
        bool any = false;
        for (int64_t i = lo; i < hi; ++i) {
            double v = vals[i];
            if (std::isnan(v)) continue;
            if (!any) { mn = mx = v; any = true; }
            else if (v < mn) mn = v;
            else if (v > mx) mx = v;
        }
        mins[tid] = mn; maxs[tid] = mx; seen[tid] = any;
    };
    if (n_threads <= 1) {
        work(0);
    } else {
        std::vector<std::thread> threads;
        for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
        for (auto& th : threads) th.join();
    }
    bool any = false;
    double mn = 0.0, mx = 0.0;
    for (int t = 0; t < n_threads; ++t) {
        if (!seen[t]) continue;
        if (!any) { mn = mins[t]; mx = maxs[t]; any = true; }
        else {
            if (mins[t] < mn) mn = mins[t];
            if (maxs[t] > mx) mx = maxs[t];
        }
    }
    *out_min = mn;
    *out_max = mx;
    return any ? 0 : -1;
}

}  // extern "C"
