// Native CSV codec for the panel persistence tier (io.save_csv/load_csv).
//
// The reference's CSV tier rides the JVM's native text machinery
// (TimeSeriesRDD.scala:498-509 saveAsCsv / :750-764 timeSeriesRDDFromCsv:
// Scala Double.toString and java.lang.Double.parseDouble are C-speed
// shortest-repr codecs under the hood).  The Python-side equivalents
// (np.savetxt's per-row %-formatting loop, pandas' round_trip parser)
// measured ~9-12 s EACH for a 100k x 64 panel — so this file does the two
// O(rows x cols) jobs natively:
//
//   sts_format_csv: double -> shortest round-trip decimal via
//     std::to_chars (C++17 charconv; correctly rounded, locale-free),
//     assembling the whole data.csv buffer (key,v0,...,vN lines) in one
//     pass.
//   sts_parse_csv: the inverse via std::from_chars, plus the same
//     RFC-4180-aware key scan io._split_key implements (quoted keys with
//     doubled quotes; malformed quoting falls back to the bare first-comma
//     split, matching the reference loader's behavior on raw keys that
//     merely start with a quote).
//
// Loud-failure contract (identical to the Python loader): a row whose
// field count differs from the first row's, or any field that is not a
// well-formed double (empty fields included), aborts the parse with a
// negative code — silent NaN-filling of corrupt files is how data loss
// hides.  Real NaNs travel as the literal token "nan" (from_chars parses
// nan/inf/-inf case-insensitively).
//
// Compiled on demand by spark_timeseries_tpu_torch._build.host_library
// (g++ -O3 -shared -fPIC, into the repository's build/torch_kernels/);
// io.py falls back to its pure-Python path when the toolchain is absent.

#include <charconv>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// longest shortest-repr double: -2.2250738585072014e-308 (24 chars)
constexpr int kMaxNum = 32;

inline const char* find_newline(const char* p, const char* end) {
    const void* nl = memchr(p, '\n', static_cast<size_t>(end - p));
    return nl ? static_cast<const char*>(nl) : end;
}

// RFC-4180-aware key scan, mirroring io._split_key: returns the end of
// the raw key token (quotes included for quoted keys) and sets *rest to
// the first character of the numeric payload.  Malformed quoting falls
// back to the bare first-comma split.
inline const char* scan_key(const char* ls, const char* le,
                            const char** rest) {
    if (ls < le && *ls == '"') {
        const char* i = ls + 1;
        while (i < le) {
            if (*i == '"') {
                if (i + 1 < le && i[1] == '"') { i += 2; continue; }
                if (i + 1 == le || i[1] == ',') {      // well-formed
                    *rest = (i + 1 == le) ? le : i + 2;
                    return i + 1;
                }
                break;                                  // malformed
            }
            ++i;
        }
    }
    const void* c = memchr(ls, ',', static_cast<size_t>(le - ls));
    if (!c) { *rest = le; return le; }
    const char* comma = static_cast<const char*>(c);
    *rest = comma + 1;
    return comma;
}

}  // namespace

extern "C" {

// Build the whole data.csv: keys are pre-escaped, '\n'-joined (rows of
// them); values row-major (rows x cols).  out must hold at least
// keys_len + rows * (cols * (kMaxNum + 1) + 2) bytes.  Returns bytes
// written, or -1 on a keys/rows count mismatch (fewer keys than rows) /
// formatting failure — the C ABI fails loudly even if a future caller
// drops save_csv's Python-side shape check.
long long sts_format_csv(const char* keys, long long keys_len,
                         const double* values, long long rows,
                         long long cols, char* out) {
    const char* kp = keys;
    const char* kend = keys + keys_len;
    bool keys_exhausted = false;
    char* o = out;
    for (long long r = 0; r < rows; ++r) {
        // the previous row consumed the blob's last key (no newline
        // followed it), so this row would silently get an empty key
        if (keys_exhausted) return -1;
        const char* knl = find_newline(kp, kend);
        memcpy(o, kp, static_cast<size_t>(knl - kp));
        o += knl - kp;
        if (knl == kend) keys_exhausted = true;
        kp = knl < kend ? knl + 1 : kend;
        const double* row = values + r * cols;
        for (long long c = 0; c < cols; ++c) {
            *o++ = ',';
            auto res = std::to_chars(o, o + kMaxNum, row[c]);
            if (res.ec != std::errc()) return -1;
            o = res.ptr;
        }
        *o++ = '\n';
    }
    return o - out;
}

// Parse data.csv text into values (capacity rows_cap x cols) and
// key_spans (rows_cap x 2, [start, end) byte offsets of each raw key
// token).  Empty lines are skipped; a trailing '\r' per line is
// tolerated.  Returns the number of rows parsed, or a negative code:
//   -1  field is not a well-formed double (empty fields included);
//       well-formed tokens beyond double range do NOT error: overflow
//       parses as +/-inf and underflow as (+/-)0, matching the pandas
//       round_trip fallback codec (ADVICE r5)
//   -2  a row's field count differs from `cols`
//   -4  more than rows_cap data rows
// On error, err_row receives the offending 0-based data-row index.
long long sts_parse_csv(const char* text, long long len, long long rows_cap,
                        long long cols, double* values,
                        long long* key_spans, long long* err_row) {
    const char* p = text;
    const char* end = text + len;
    long long r = 0;
    while (p < end) {
        const char* nl = find_newline(p, end);
        const char* le = nl;
        if (le > p && le[-1] == '\r') --le;
        if (le == p) { p = nl + 1; continue; }          // blank line
        if (r >= rows_cap) { *err_row = r; return -4; }
        const char* rest;
        const char* ke = scan_key(p, le, &rest);
        key_spans[2 * r] = p - text;
        key_spans[2 * r + 1] = ke - text;
        double* row = values + r * cols;
        long long c = 0;
        const char* f = rest;
        while (true) {
            const void* cm = memchr(f, ',', static_cast<size_t>(le - f));
            const char* fe = cm ? static_cast<const char*>(cm) : le;
            if (c >= cols) { *err_row = r; return -2; }
            auto res = std::from_chars(f, fe, row[c]);
            if (res.ec == std::errc::result_out_of_range &&
                res.ptr == fe) {
                // ADVICE r5: a well-formed token whose magnitude escapes
                // double range ("1e400", "-4e-400") must match the pandas
                // round_trip fallback — overflow parses as +/-inf,
                // underflow as (+/-)0 — not abort the row.  from_chars
                // leaves the value unset on out_of_range, so re-parse
                // with strtod, whose C-standard mapping is exactly that
                // (+/-HUGE_VAL on overflow, magnitude <= DBL_MIN on
                // underflow).  Bounded stack copy keeps this path
                // allocation-free; a pathological >511-char token (or a
                // non-C decimal locale) falls through to the loud -1.
                char buf[512];
                size_t tok_len = static_cast<size_t>(fe - f);
                if (tok_len < sizeof(buf)) {
                    memcpy(buf, f, tok_len);
                    buf[tok_len] = '\0';
                    char* endp = nullptr;
                    double v = strtod(buf, &endp);
                    if (endp == buf + tok_len) {
                        row[c] = v;
                        res.ec = std::errc();
                    }
                }
            }
            if (res.ec != std::errc() || res.ptr != fe) {
                *err_row = r;
                return -1;
            }
            ++c;
            if (!cm) break;
            f = fe + 1;
            if (f == le) {                   // trailing comma: empty field
                *err_row = r;
                return -1;
            }
        }
        if (c != cols) { *err_row = r; return -2; }
        ++r;
        p = nl + 1;
    }
    return r;
}

}  // extern "C"
