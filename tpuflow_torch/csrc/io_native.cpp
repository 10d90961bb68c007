// Native I/O runtime of tpuflow_torch: PNM codec, flow-file codec, quiver
// rasterization, a multi-threaded prefetching frame loader, and the
// mean-shift region labeler. A copy of tpuflow's tpuflow/native/
// io_native.cpp (standard C++ library only), built by
// tpuflow_torch/native/__init__.py with g++ into build/tpuflow_torch/.
//
// The reference's I/O layer is the C++ pnm_lib_cpp submodule (absent from
// its snapshot; behavior reconstructed in SURVEY.md §2.4) feeding a
// synchronous frame loop. The loader here decodes frames on worker
// threads into a bounded ring, so the host-to-device feed never stalls on
// disk or parsing.
//
// Formats:
//  - PNM P5/P6 binary, 8/16-bit (16-bit big-endian per spec)
//  - flow files: "W H\n" header + row-major little-endian f64 (x, y)
//    pairs (OpticalFlow/OpticalFlow.cpp:400-417)
//
// C ABI only (ctypes-friendly); all buffers are caller-owned or returned
// via tf_free_image().

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <condition_variable>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

struct TfImage {
    int32_t width;
    int32_t height;
    int32_t channels;   // 1 or 3
    int32_t maxval;
    double* data;       // H*W*C doubles, row-major
};

// ---------------------------------------------------------------------------
// PNM codec

static bool read_file(const char* path, std::vector<uint8_t>& out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    out.resize(size_t(n));
    size_t got = n > 0 ? std::fread(out.data(), 1, size_t(n), f) : 0;
    std::fclose(f);
    return got == size_t(n);
}

static int parse_int(const std::vector<uint8_t>& d, size_t& pos) {
    while (pos < d.size() &&
           (d[pos] == ' ' || d[pos] == '\n' || d[pos] == '\r' ||
            d[pos] == '\t' || d[pos] == '#')) {
        if (d[pos] == '#') {
            while (pos < d.size() && d[pos] != '\n') pos++;
        } else {
            pos++;
        }
    }
    int v = 0;
    while (pos < d.size() && d[pos] >= '0' && d[pos] <= '9') {
        v = v * 10 + (d[pos] - '0');
        pos++;
    }
    return v;
}

TfImage* tf_read_pnm(const char* path) {
    std::vector<uint8_t> d;
    if (!read_file(path, d) || d.size() < 10) return nullptr;
    if (d[0] != 'P' || (d[1] != '5' && d[1] != '6')) return nullptr;
    int channels = d[1] == '6' ? 3 : 1;
    size_t pos = 2;
    int w = parse_int(d, pos);
    int h = parse_int(d, pos);
    int maxval = parse_int(d, pos);
    pos++;  // single whitespace after maxval
    size_t count = size_t(w) * h * channels;
    bool wide = maxval > 255;
    if (d.size() < pos + count * (wide ? 2 : 1)) return nullptr;
    TfImage* img = new TfImage{w, h, channels, maxval, nullptr};
    img->data = static_cast<double*>(std::malloc(count * sizeof(double)));
    const uint8_t* p = d.data() + pos;
    if (wide) {
        for (size_t i = 0; i < count; i++)
            img->data[i] = double((uint16_t(p[2 * i]) << 8) | p[2 * i + 1]);
    } else {
        for (size_t i = 0; i < count; i++) img->data[i] = double(p[i]);
    }
    return img;
}

int tf_write_pnm(const char* path, const double* data, int32_t width,
                 int32_t height, int32_t channels, int32_t maxval) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::fprintf(f, "P%c\n%d %d\n%d\n", channels == 3 ? '6' : '5', width,
                 height, maxval);
    size_t count = size_t(width) * height * channels;
    bool wide = maxval > 255;
    std::vector<uint8_t> buf(count * (wide ? 2 : 1));
    for (size_t i = 0; i < count; i++) {
        double v = data[i];
        if (v < 0) v = 0;
        if (v > maxval) v = maxval;
        long q = long(v + 0.5);
        if (wide) {
            buf[2 * i] = uint8_t(q >> 8);
            buf[2 * i + 1] = uint8_t(q & 0xFF);
        } else {
            buf[i] = uint8_t(q);
        }
    }
    size_t put = std::fwrite(buf.data(), 1, buf.size(), f);
    std::fclose(f);
    return put == buf.size() ? 0 : -1;
}

void tf_free_image(TfImage* img) {
    if (img) {
        std::free(img->data);
        delete img;
    }
}

// ---------------------------------------------------------------------------
// Flow-file codec (reference binary format)

int tf_write_flow(const char* path, const double* u, const double* v,
                  const double* score, int32_t width, int32_t height) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::fprintf(f, "%d %d\n", width, height);
    size_t n = size_t(width) * height;
    int comps = score ? 3 : 2;
    std::vector<double> inter(n * comps);
    for (size_t i = 0; i < n; i++) {
        inter[comps * i] = u[i];
        inter[comps * i + 1] = v[i];
        if (score) inter[comps * i + 2] = score[i];
    }
    size_t put = std::fwrite(inter.data(), sizeof(double), inter.size(), f);
    std::fclose(f);
    return put == inter.size() ? 0 : -1;
}

// Reads into caller-allocated u/v (and score if non-null). Returns 0 on
// success; tf_flow_size queries dimensions first.
int tf_flow_size(const char* path, int32_t* width, int32_t* height) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int w = 0, h = 0;
    int got = std::fscanf(f, "%d %d", &w, &h);
    std::fclose(f);
    if (got != 2) return -1;
    *width = w;
    *height = h;
    return 0;
}

int tf_read_flow(const char* path, double* u, double* v, double* score,
                 int32_t width, int32_t height) {
    std::vector<uint8_t> d;
    if (!read_file(path, d)) return -1;
    size_t pos = 0;
    while (pos < d.size() && d[pos] != '\n') pos++;
    pos++;
    int comps = score ? 3 : 2;
    size_t n = size_t(width) * height;
    if (d.size() < pos + n * comps * sizeof(double)) return -1;
    const double* p = reinterpret_cast<const double*>(d.data() + pos);
    for (size_t i = 0; i < n; i++) {
        u[i] = p[comps * i];
        v[i] = p[comps * i + 1];
        if (score) score[i] = p[comps * i + 2];
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Quiver rasterization (plotFlow.cpp:43-88 Bresenham walk)

static void draw_line_rgb(uint8_t* img, int h, int w, int x0, int y0,
                          int x1, int y1, const uint8_t color[3]) {
    int dx = x1 - x0, dy = y1 - y0;
    int sx = (dx > 0) - (dx < 0), sy = (dy > 0) - (dy < 0);
    dx = dx < 0 ? -dx : dx;
    dy = dy < 0 ? -dy : dy;
    int n = dx > dy ? dx : dy;
    if (n == 0) return;
    int x = x0, y = y0;
    double r = n / 2.0;
    if (dx > dy) {
        for (int i = 0; i < n; i++) {
            if (x >= 0 && x < w - 1 && y >= 0 && y < h - 1)
                std::memcpy(img + 3 * (size_t(y) * w + x), color, 3);
            x += sx;
            r += dy;
            if (r >= dx) { y += sy; r -= dx; }
        }
    } else {
        for (int i = 0; i < n; i++) {
            if (x >= 0 && x < w - 1 && y >= 0 && y < h - 1)
                std::memcpy(img + 3 * (size_t(y) * w + x), color, 3);
            y += sy;
            r += dx;
            if (r >= dy) { x += sx; r -= dy; }
        }
    }
}

// img: H*W*3 uint8 RGB modified in place; u/v: H*W doubles.
void tf_draw_quiver(uint8_t* img, int32_t height, int32_t width,
                    const double* u, const double* v, int32_t delta,
                    double scale, double outlier,
                    const uint8_t* line_color, const uint8_t* tip_color) {
    for (int y0 = 0; y0 < height; y0 += delta) {
        for (int x0 = 0; x0 < width; x0 += delta) {
            double du = u[size_t(y0) * width + x0];
            double dv = v[size_t(y0) * width + x0];
            int x1 = int(x0 + du * scale);
            int y1 = int(y0 + dv * scale);
            bool in_bound = outlier <= 0.0 ||
                (du < outlier && dv < outlier && du > -outlier &&
                 dv > -outlier);
            if (in_bound)
                draw_line_rgb(img, height, width, x0, y0, x1, y1, line_color);
            if (x1 >= 0 && x1 < width - 1 && y1 >= 0 && y1 < height - 1)
                std::memcpy(img + 3 * (size_t(y1) * width + x1), tip_color, 3);
        }
    }
}

// ---------------------------------------------------------------------------
// Prefetching frame loader

struct Prefetcher {
    std::vector<std::string> paths;
    std::queue<std::pair<size_t, TfImage*>> ready;
    std::mutex mu;
    std::condition_variable cv_ready;
    std::condition_variable cv_space;
    size_t next_submit = 0;   // next index a worker may claim
    size_t next_emit = 0;     // next index the consumer expects
    size_t capacity = 4;
    std::atomic<bool> stop{false};
    std::vector<std::thread> workers;
    // Out-of-order completion buffer (ordered delivery).
    std::vector<TfImage*> done;
    std::vector<uint8_t> done_mask;

    void work() {
        for (;;) {
            size_t idx;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_space.wait(lk, [&] {
                    return stop.load() ||
                           (next_submit < paths.size() &&
                            next_submit - next_emit < capacity);
                });
                if (stop.load() || next_submit >= paths.size()) return;
                idx = next_submit++;
            }
            TfImage* img = tf_read_pnm(paths[idx].c_str());
            {
                std::unique_lock<std::mutex> lk(mu);
                done[idx] = img;
                done_mask[idx] = 1;
                cv_ready.notify_all();
            }
        }
    }
};

Prefetcher* tf_prefetcher_create(const char** paths, int32_t n_paths,
                                 int32_t n_threads, int32_t capacity) {
    Prefetcher* p = new Prefetcher;
    for (int i = 0; i < n_paths; i++) p->paths.emplace_back(paths[i]);
    p->capacity = capacity > 0 ? size_t(capacity) : 4;
    p->done.assign(p->paths.size(), nullptr);
    p->done_mask.assign(p->paths.size(), 0);
    int nt = n_threads > 0 ? n_threads : 2;
    for (int i = 0; i < nt; i++)
        p->workers.emplace_back([p] { p->work(); });
    return p;
}

// Blocks until the next frame (in submission order) is decoded.
// Returns nullptr at end of sequence or on decode failure.
TfImage* tf_prefetcher_next(Prefetcher* p) {
    std::unique_lock<std::mutex> lk(p->mu);
    if (p->next_emit >= p->paths.size()) return nullptr;
    size_t idx = p->next_emit;
    p->cv_ready.wait(lk, [&] { return p->done_mask[idx] != 0; });
    TfImage* img = p->done[idx];
    p->done[idx] = nullptr;
    p->next_emit++;
    p->cv_space.notify_all();
    return img;
}

void tf_prefetcher_destroy(Prefetcher* p) {
    if (!p) return;
    p->stop.store(true);
    p->cv_space.notify_all();
    for (auto& t : p->workers) t.join();
    for (auto* img : p->done) tf_free_image(img);
    delete p;
}

// ---------------------------------------------------------------------------
// Mean-shift region formation — the host half of Segmentation<Lab>
// (missing-submodule behavior, SURVEY.md §2.4): union 4-adjacent pixels
// whose filtered modes agree within half a spatial kernel and one
// intensity kernel, then absorb regions smaller than min_size into the
// most-similar touching neighbor by region mean color. Bit-identical
// partition, numbering and merge order to the Python implementation
// (tpuflow_torch/segmentation/meanshift.py::_merge_labels_plain) —
// pinned by tests/test_torch_native.py.
//
// pos: H*W*2 doubles (mode x, y), col: H*W*3 doubles, out: H*W int32.
// sp_th/cl_th are the SQUARED thresholds. Returns the region count.

static int32_t uf_find(std::vector<int32_t>& p, int32_t i) {
    while (p[i] != i) {
        p[i] = p[p[i]];
        i = p[i];
    }
    return i;
}

int32_t tf_label_regions(const double* pos, const double* col,
                         int32_t h, int32_t w, double sp_th, double cl_th,
                         int32_t min_size, int32_t* out) {
    const int64_t npix = (int64_t)h * w;
    std::vector<int32_t> parent(npix);
    for (int64_t i = 0; i < npix; i++) parent[i] = (int32_t)i;

    auto close = [&](int64_t a, int64_t b) {
        double dx = pos[2 * a] - pos[2 * b];
        double dy = pos[2 * a + 1] - pos[2 * b + 1];
        if (dx * dx + dy * dy > sp_th) return false;
        double d0 = col[3 * a] - col[3 * b];
        double d1 = col[3 * a + 1] - col[3 * b + 1];
        double d2 = col[3 * a + 2] - col[3 * b + 2];
        return d0 * d0 + d1 * d1 + d2 * d2 <= cl_th;
    };
    for (int32_t y = 0; y < h; y++) {
        for (int32_t x = 0; x < w; x++) {
            int64_t i = (int64_t)y * w + x;
            if (y + 1 < h && close(i, i + w)) {
                int32_t ra = uf_find(parent, (int32_t)i);
                int32_t rb = uf_find(parent, (int32_t)(i + w));
                if (ra != rb) parent[rb] = ra;
            }
            if (x + 1 < w && close(i, i + 1)) {
                int32_t ra = uf_find(parent, (int32_t)i);
                int32_t rb = uf_find(parent, (int32_t)(i + 1));
                if (ra != rb) parent[rb] = ra;
            }
        }
    }
    // Label components by first occurrence in pixel scan order (the
    // numbering scipy's connected_components produces).
    std::vector<int32_t> root_label(npix, -1);
    int32_t n = 0;
    for (int64_t i = 0; i < npix; i++) {
        int32_t r = uf_find(parent, (int32_t)i);
        if (root_label[r] < 0) root_label[r] = n++;
        out[i] = root_label[r];
    }
    if (min_size <= 1) return n;

    // Region-level tiny absorption — same arrays, same iteration order
    // as the Python version so the result is bitwise identical.
    std::vector<int64_t> counts(n, 0);
    std::vector<double> col_sums((size_t)n * 3, 0.0);
    for (int64_t i = 0; i < npix; i++) {
        int32_t l = out[i];
        counts[l]++;
        col_sums[3 * (size_t)l] += col[3 * i];
        col_sums[3 * (size_t)l + 1] += col[3 * i + 1];
        col_sums[3 * (size_t)l + 2] += col[3 * i + 2];
    }
    // Deduplicated directed adjacency, sorted by a * n + b.
    std::vector<int64_t> edge_keys;
    for (int32_t y = 0; y < h; y++) {
        for (int32_t x = 0; x < w; x++) {
            int64_t i = (int64_t)y * w + x;
            if (y + 1 < h && out[i] != out[i + w]) {
                edge_keys.push_back((int64_t)out[i] * n + out[i + w]);
                edge_keys.push_back((int64_t)out[i + w] * n + out[i]);
            }
            if (x + 1 < w && out[i] != out[i + 1]) {
                edge_keys.push_back((int64_t)out[i] * n + out[i + 1]);
                edge_keys.push_back((int64_t)out[i + 1] * n + out[i]);
            }
        }
    }
    std::sort(edge_keys.begin(), edge_keys.end());
    edge_keys.erase(std::unique(edge_keys.begin(), edge_keys.end()),
                    edge_keys.end());
    std::vector<int32_t> ea, eb;
    ea.reserve(edge_keys.size());
    eb.reserve(edge_keys.size());
    for (int64_t k : edge_keys) {
        ea.push_back((int32_t)(k / n));
        eb.push_back((int32_t)(k % n));
    }

    std::vector<int32_t> remap_total(n);
    for (int32_t i = 0; i < n; i++) remap_total[i] = i;
    std::vector<int32_t> remap(n), best_dst(n);
    std::vector<double> best_d(n), mean_col((size_t)n * 3);
    std::vector<uint8_t> is_tiny(n), has_best(n);

    for (int iter = 0; iter < 64; iter++) {
        bool any_tiny = false;
        for (int32_t i = 0; i < n; i++) {
            is_tiny[i] = counts[i] > 0 && counts[i] < min_size;
            any_tiny |= is_tiny[i] != 0;
        }
        if (!any_tiny) break;
        for (int32_t i = 0; i < n; i++) {
            double c = counts[i] > 0 ? (double)counts[i] : 1.0;
            mean_col[3 * (size_t)i] = col_sums[3 * (size_t)i] / c;
            mean_col[3 * (size_t)i + 1] = col_sums[3 * (size_t)i + 1] / c;
            mean_col[3 * (size_t)i + 2] = col_sums[3 * (size_t)i + 2] / c;
        }
        // Per tiny region: the touching neighbor with the smallest
        // mean-color distance (ties -> smallest id: edges iterate in
        // (a, b)-sorted order and the strict < keeps the first).
        std::fill(has_best.begin(), has_best.end(), 0);
        bool any_cand = false;
        for (size_t k = 0; k < ea.size(); k++) {
            int32_t a = ea[k];
            if (!is_tiny[a]) continue;
            int32_t b = eb[k];
            double d0 = mean_col[3 * (size_t)a] - mean_col[3 * (size_t)b];
            double d1 = mean_col[3 * (size_t)a + 1]
                        - mean_col[3 * (size_t)b + 1];
            double d2 = mean_col[3 * (size_t)a + 2]
                        - mean_col[3 * (size_t)b + 2];
            double d = d0 * d0 + d1 * d1 + d2 * d2;
            if (!has_best[a] || d < best_d[a]) {
                has_best[a] = 1;
                best_d[a] = d;
                best_dst[a] = b;
            }
            any_cand = true;
        }
        if (!any_cand) break;
        // keep = !is_tiny[dst] || dst < src (breaks a<->b swap cycles).
        bool any_keep = false;
        for (int32_t i = 0; i < n; i++) {
            remap[i] = i;
            if (has_best[i]) {
                int32_t dst = best_dst[i];
                if (!is_tiny[dst] || dst < i) {
                    remap[i] = dst;
                    any_keep = true;
                }
            }
        }
        if (!any_keep) break;
        for (int r = 0; r < 8; r++)  // resolve chains (remap = remap[remap])
            for (int32_t i = 0; i < n; i++) remap[i] = remap[remap[i]];
        // Fold mass, contract the adjacency.
        std::vector<int64_t> counts_new(n, 0);
        std::vector<double> col_new((size_t)n * 3, 0.0);
        for (int32_t i = 0; i < n; i++) {
            int32_t d = remap[i];
            counts_new[d] += counts[i];
            col_new[3 * (size_t)d] += col_sums[3 * (size_t)i];
            col_new[3 * (size_t)d + 1] += col_sums[3 * (size_t)i + 1];
            col_new[3 * (size_t)d + 2] += col_sums[3 * (size_t)i + 2];
        }
        counts.swap(counts_new);
        col_sums.swap(col_new);
        for (int32_t i = 0; i < n; i++)
            remap_total[i] = remap[remap_total[i]];
        edge_keys.clear();
        for (size_t k = 0; k < ea.size(); k++) {
            int32_t a = remap[ea[k]];
            int32_t b = remap[eb[k]];
            if (a != b) edge_keys.push_back((int64_t)a * n + b);
        }
        std::sort(edge_keys.begin(), edge_keys.end());
        edge_keys.erase(std::unique(edge_keys.begin(), edge_keys.end()),
                        edge_keys.end());
        ea.clear();
        eb.clear();
        for (int64_t k : edge_keys) {
            ea.push_back((int32_t)(k / n));
            eb.push_back((int32_t)(k % n));
        }
    }
    // Apply and compact (np.unique numbering: sorted surviving ids).
    std::vector<int32_t> compact(n, -1);
    for (int64_t i = 0; i < npix; i++) out[i] = remap_total[out[i]];
    for (int64_t i = 0; i < npix; i++) compact[out[i]] = 1;
    int32_t nc = 0;
    for (int32_t i = 0; i < n; i++)
        if (compact[i] > 0) compact[i] = nc++;
    for (int64_t i = 0; i < npix; i++) out[i] = compact[out[i]];
    return nc;
}

}  // extern "C"
