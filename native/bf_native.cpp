// Native runtime components for better_flow.
//
// The reference is a C++ pipeline end to end; here the device compute path is
// JAX/XLA and the native layer covers what genuinely benefits from C++ on
// the host side: bulk text I/O of event recordings (the reference's
// iostream parsing, event_file.h:34-176, is its I/O bottleneck) and the
// ring-buffer slicing primitives (datastructures.h:6-115).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Build: python native/build.py  (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>

extern "C" {

struct EventArrays {
    double* t;      // seconds, rebased to first row
    float* x;       // swapped: our x = file's y (event_file.h:60)
    float* y;
    int8_t* p;
    int64_t n;
};

// Parse a whitespace-separated "t x y p" recording.  Timestamps are rebased
// to the first row (first row keeps t = 0, event_file.h:154-157).  Returns
// number of events, or -1 on open failure.  Caller frees with
// bf_free_events.
int64_t bf_parse_events(const char* path, EventArrays* out) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    char* buf = (char*)malloc(size + 1);
    if (!buf) { fclose(f); return -1; }
    size_t rd = fread(buf, 1, size, f);
    fclose(f);
    buf[rd] = 0;

    // Reserve by a line-count estimate.
    int64_t approx = 0;
    for (size_t i = 0; i < rd; ++i) approx += (buf[i] == '\n');
    approx += 2;

    double* t = (double*)malloc(approx * sizeof(double));
    float* x = (float*)malloc(approx * sizeof(float));
    float* y = (float*)malloc(approx * sizeof(float));
    int8_t* p = (int8_t*)malloc(approx * sizeof(int8_t));
    if (!t || !x || !y || !p) {
        free(buf); free(t); free(x); free(y); free(p);
        return -1;
    }

    int64_t n = 0;
    char* s = buf;
    char* end = buf + rd;
    double t0 = 0.0;
    bool first = true;
    while (s < end && n < approx) {
        char* e;
        double tv = strtod(s, &e);
        if (e == s) break;  // no more numbers
        s = e;
        double xv = strtod(s, &e);
        if (e == s) break;
        s = e;
        double yv = strtod(s, &e);
        if (e == s) break;
        s = e;
        double pv = strtod(s, &e);
        if (e == s) break;
        s = e;
        if (first) { t0 = tv; first = false; }
        t[n] = tv - t0;
        // x/y swap on read, like Event(y, x, ...) (event_file.h:60, 162)
        x[n] = (float)yv;
        y[n] = (float)xv;
        p[n] = (int8_t)pv;
        ++n;
    }
    if (n > 0) t[0] = 0.0;
    free(buf);
    out->t = t; out->x = x; out->y = y; out->p = p; out->n = n;
    return n;
}

void bf_free_events(EventArrays* a) {
    free(a->t); free(a->x); free(a->y); free(a->p);
    a->t = nullptr; a->x = nullptr; a->y = nullptr; a->p = nullptr;
    a->n = 0;
}

// Write "t y x 1 v u" rows at 9-decimal fixed precision (to_file_uv,
// event_file.h:238-289, including the documented x/y and u/v swap).
// Returns rows written or -1.
int64_t bf_write_events_uv(const char* path, const double* t_s,
                           const float* x, const float* y,
                           const float* u, const float* v, int64_t n) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    // Buffered manual formatting: ~5x faster than fprintf %f per row.
    std::vector<char> buf;
    buf.reserve(1 << 22);
    char line[128];
    for (int64_t i = 0; i < n; ++i) {
        int len = snprintf(line, sizeof line, "%.9f %d %d 1 %.9f %.9f\n",
                           t_s[i], (int)y[i], (int)x[i], (double)v[i],
                           (double)u[i]);
        buf.insert(buf.end(), line, line + len);
        if (buf.size() > (1 << 21)) {
            fwrite(buf.data(), 1, buf.size(), f);
            buf.clear();
        }
    }
    if (!buf.empty()) fwrite(buf.data(), 1, buf.size(), f);
    fclose(f);
    return n;
}

// --- Ring buffer with count + span eviction (CircularArray equivalent,
// datastructures.h:6-115).  Mirrors runtime/slice_buffer.py for callers
// that want the slicing bookkeeping off the Python heap.

struct RingBuffer {
    int64_t capacity;
    int64_t span_ns;
    float* x;
    float* y;
    int64_t* ts;
    int64_t head;   // index of newest
    int64_t size;   // live count (after span fix)
};

RingBuffer* bf_ring_new(int64_t capacity, int64_t span_ns) {
    RingBuffer* r = new RingBuffer();
    r->capacity = capacity;
    r->span_ns = span_ns;
    r->x = (float*)calloc(capacity, sizeof(float));
    r->y = (float*)calloc(capacity, sizeof(float));
    r->ts = (int64_t*)calloc(capacity, sizeof(int64_t));
    r->head = -1;
    r->size = 0;
    return r;
}

void bf_ring_free(RingBuffer* r) {
    free(r->x); free(r->y); free(r->ts);
    delete r;
}

void bf_ring_push_batch(RingBuffer* r, const float* x, const float* y,
                        const int64_t* ts, int64_t n) {
    if (n >= r->capacity) {  // only the newest capacity events survive
        x += n - r->capacity; y += n - r->capacity; ts += n - r->capacity;
        n = r->capacity;
    }
    for (int64_t i = 0; i < n; ++i) {
        r->head = (r->head + 1) % r->capacity;
        r->x[r->head] = x[i];
        r->y[r->head] = y[i];
        r->ts[r->head] = ts[i];
    }
    r->size = r->size + n > r->capacity ? r->capacity : r->size + n;
}

// Evict entries older than span relative to the newest (fix_span,
// datastructures.h:46-59); returns the live size.
int64_t bf_ring_fix_span(RingBuffer* r) {
    if (r->size == 0) return 0;
    int64_t latest = r->ts[r->head];
    while (r->size > 0) {
        int64_t tail = (r->head - r->size + 1 + r->capacity * 2) % r->capacity;
        if (latest - r->ts[tail] > r->span_ns) r->size--;
        else break;
    }
    return r->size;
}

// Copy the live window (oldest -> newest) into caller buffers; returns n.
int64_t bf_ring_snapshot(RingBuffer* r, float* x, float* y, int64_t* ts) {
    bf_ring_fix_span(r);
    for (int64_t i = 0; i < r->size; ++i) {
        int64_t idx = (r->head - r->size + 1 + i + r->capacity * 2) % r->capacity;
        x[i] = r->x[idx];
        y[i] = r->y[idx];
        ts[i] = r->ts[idx];
    }
    return r->size;
}

int64_t bf_ring_size(RingBuffer* r) { return bf_ring_fix_span(r); }

// --- Band-padded slice materialization: the host-staging hot path of the
// offline scan (runtime/scan_pipeline.prepare_recording).  Produces the
// SAME layout as the numpy materialize_slices(band_pad=True) + compact u16
// encoding — verified element-exact by tests/test_native_prep.py — via one
// counting sort per slice keyed by (row-band, column), with every band
// padded to a CHUNK boundary (runtime/scan_pipeline.CHUNK).  The numpy
// path is a [S, capp] fancy scatter; this pass replaces it.
//
// Outputs are [S, capp] row-major, pre-sized by the caller:
//   xs16/ys16: event coordinates (u16), 0 in padding slots
//   ts:        f32(t_ns - slice_start_ns[s]), 0 in padding slots
//   perm:      u16 in-slice offset (original index = starts[s] + perm),
//              0xFFFF in padding slots
// Returns 0, or -1 if any slice's padded layout exceeds capp (caller must
// then fall back to the numpy path).

}  // extern "C" (reopened below for the exports)

template <class CT>
static void materialize_rows_t(
    const CT* x, const CT* y, const int64_t* t_ns,
    const int64_t* starts, const int64_t* ends, const int64_t* slice_start_ns,
    int64_t s0, int64_t s1, int64_t capp, int64_t band_rows, int64_t chunk,
    int64_t n_bands, int64_t res_y,
    uint16_t* xs16, uint16_t* ys16, float* ts, uint16_t* perm,
    int32_t* bbox, int* bad) {
    std::vector<int64_t> cnt(n_bands * res_y);
    std::vector<int64_t> base(n_bands + 1);
    for (int64_t s = s0; s < s1; ++s) {
        const int64_t lo = starts[s], hi = ends[s];
        const int64_t t0 = slice_start_ns[s];
        uint16_t* xr = xs16 + s * capp;
        uint16_t* yr = ys16 + s * capp;
        float* tr = ts + s * capp;
        uint16_t* pr = perm + s * capp;
        memset(xr, 0, capp * sizeof(uint16_t));
        memset(yr, 0, capp * sizeof(uint16_t));
        memset(tr, 0, capp * sizeof(float));
        memset(pr, 0xFF, capp * sizeof(uint16_t));  // 0xFFFF sentinel

        std::fill(cnt.begin(), cnt.end(), 0);
        int64_t xmin = INT64_MAX, xmax = INT64_MIN;
        int64_t ymin = INT64_MAX, ymax = INT64_MIN;
        for (int64_t i = lo; i <= hi; ++i) {
            int64_t b = (int64_t)x[i] / band_rows;
            int64_t c = (int64_t)y[i];
            int64_t xi = (int64_t)x[i];
            if (xi < xmin) xmin = xi;
            if (xi > xmax) xmax = xi;
            if (c < ymin) ymin = c;
            if (c > ymax) ymax = c;
            cnt[b * res_y + c]++;
        }
        if (bbox) {
            // per-slice integer bbox + the window population (what
            // OptimizerRolling::set_cloud scans, optimizer_rolling.h:252-261)
            bbox[s * 4 + 0] = (int32_t)(hi >= lo ? xmin : 0);
            bbox[s * 4 + 1] = (int32_t)(hi >= lo ? xmax : 0);
            bbox[s * 4 + 2] = (int32_t)(hi >= lo ? ymin : 0);
            bbox[s * 4 + 3] = (int32_t)(hi >= lo ? ymax : 0);
        }
        // chunk-aligned band bases
        base[0] = 0;
        for (int64_t b = 0; b < n_bands; ++b) {
            int64_t bc = 0;
            for (int64_t c = 0; c < res_y; ++c) bc += cnt[b * res_y + c];
            base[b + 1] = base[b] + ((bc + chunk - 1) / chunk) * chunk;
        }
        if (base[n_bands] > capp) { *bad = 1; return; }
        // exclusive prefix offsets within each band (by column)
        for (int64_t b = 0; b < n_bands; ++b) {
            int64_t run = 0;
            for (int64_t c = 0; c < res_y; ++c) {
                int64_t v = cnt[b * res_y + c];
                cnt[b * res_y + c] = run;
                run += v;
            }
        }
        for (int64_t i = lo; i <= hi; ++i) {
            int64_t b = (int64_t)x[i] / band_rows;
            int64_t c = (int64_t)y[i];
            int64_t pos = base[b] + cnt[b * res_y + c]++;
            xr[pos] = (uint16_t)x[i];
            yr[pos] = (uint16_t)y[i];
            tr[pos] = (float)(t_ns[i] - t0);
            pr[pos] = (uint16_t)(i - lo);
        }
    }
}

template <class CT>
static int64_t materialize_bandpad_t(
    const CT* x, const CT* y, const int64_t* t_ns,
    const int64_t* starts, const int64_t* ends, const int64_t* slice_start_ns,
    int64_t S, int64_t capp, int64_t band_rows, int64_t chunk,
    int64_t n_bands, int64_t res_y,
    uint16_t* xs16, uint16_t* ys16, float* ts, uint16_t* perm,
    int32_t* bbox) {
    int n_thr = (int)std::thread::hardware_concurrency();
    if (n_thr < 1) n_thr = 1;
    if (n_thr > 8) n_thr = 8;
    if ((int64_t)n_thr > S) n_thr = (int)S;
    std::vector<int> bad(n_thr, 0);
    if (n_thr <= 1) {
        materialize_rows_t<CT>(x, y, t_ns, starts, ends, slice_start_ns, 0, S,
                               capp, band_rows, chunk, n_bands, res_y,
                               xs16, ys16, ts, perm, bbox, &bad[0]);
    } else {
        std::vector<std::thread> threads;
        int64_t per = (S + n_thr - 1) / n_thr;
        for (int k = 0; k < n_thr; ++k) {
            int64_t s0 = k * per;
            int64_t s1 = s0 + per < S ? s0 + per : S;
            if (s0 >= s1) break;
            threads.emplace_back(materialize_rows_t<CT>, x, y, t_ns, starts,
                                 ends, slice_start_ns, s0, s1, capp,
                                 band_rows, chunk, n_bands, res_y, xs16,
                                 ys16, ts, perm, bbox, &bad[k]);
        }
        for (auto& t : threads) t.join();
    }
    for (int b : bad) if (b) return -1;
    return 0;
}

extern "C" int64_t bf_materialize_bandpad(
    const float* x, const float* y, const int64_t* t_ns,
    const int64_t* starts, const int64_t* ends, const int64_t* slice_start_ns,
    int64_t S, int64_t capp, int64_t band_rows, int64_t chunk,
    int64_t n_bands, int64_t res_y,
    uint16_t* xs16, uint16_t* ys16, float* ts, uint16_t* perm) {
    return materialize_bandpad_t<float>(x, y, t_ns, starts, ends,
                                        slice_start_ns, S, capp, band_rows,
                                        chunk, n_bands, res_y, xs16, ys16,
                                        ts, perm, nullptr);
}

// u16-coordinate variant with per-slice bbox output — the zero-copy path
// fed by bf_coords_u16 (no f32 conversion, no separate integral scan, no
// python bbox loop).
extern "C" int64_t bf_materialize_bandpad_u16(
    const uint16_t* x, const uint16_t* y, const int64_t* t_ns,
    const int64_t* starts, const int64_t* ends, const int64_t* slice_start_ns,
    int64_t S, int64_t capp, int64_t band_rows, int64_t chunk,
    int64_t n_bands, int64_t res_y,
    uint16_t* xs16, uint16_t* ys16, float* ts, uint16_t* perm,
    int32_t* bbox) {
    return materialize_bandpad_t<uint16_t>(x, y, t_ns, starts, ends,
                                           slice_start_ns, S, capp,
                                           band_rows, chunk, n_bands, res_y,
                                           xs16, ys16, ts, perm, bbox);
}

// One-pass coordinate narrowing + validity check: every coordinate must be
// a non-negative integral value below 0xFFFF (the compact-transfer
// contract of runtime/scan_pipeline.prepare_recording).  Returns 0 and
// fills xo/yo, or -1 (outputs undefined) — the caller then takes the
// generic f32 path.  Templated over the source dtype; threaded 2-way.
template <class CT>
static void coords_rows(const CT* x, const CT* y, int64_t lo, int64_t hi,
                        uint16_t* xo, uint16_t* yo, int* bad) {
    for (int64_t i = lo; i < hi; ++i) {
        CT xv = x[i], yv = y[i];
        if (!(xv >= 0 && xv < 65535 && yv >= 0 && yv < 65535)) { *bad = 1; return; }
        uint16_t xi = (uint16_t)xv, yi = (uint16_t)yv;
        if ((CT)xi != xv || (CT)yi != yv) { *bad = 1; return; }
        xo[i] = xi;
        yo[i] = yi;
    }
}

template <class CT>
static int64_t coords_u16_t(const CT* x, const CT* y, int64_t n,
                            uint16_t* xo, uint16_t* yo) {
    int n_thr = n > 1000000 ? 2 : 1;
    std::vector<int> bad(n_thr, 0);
    if (n_thr <= 1) {
        coords_rows<CT>(x, y, 0, n, xo, yo, &bad[0]);
    } else {
        std::vector<std::thread> threads;
        int64_t per = (n + n_thr - 1) / n_thr;
        for (int k = 0; k < n_thr; ++k) {
            int64_t lo = k * per;
            int64_t hi = lo + per < n ? lo + per : n;
            if (lo >= hi) break;
            threads.emplace_back(coords_rows<CT>, x, y, lo, hi, xo, yo,
                                 &bad[k]);
        }
        for (auto& t : threads) t.join();
    }
    for (int b : bad) if (b) return -1;
    return 0;
}

extern "C" int64_t bf_coords_u16_f64(const double* x, const double* y, int64_t n,
                          uint16_t* xo, uint16_t* yo) {
    return coords_u16_t<double>(x, y, n, xo, yo);
}

extern "C" int64_t bf_coords_u16_f32(const float* x, const float* y, int64_t n,
                          uint16_t* xo, uint16_t* yo) {
    return coords_u16_t<float>(x, y, n, xo, yo);
}

