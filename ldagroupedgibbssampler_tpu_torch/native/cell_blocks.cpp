// Native cell-block builder: the corpus/ragged.py build_cell_blocks layout
// computed by counting sort over the (w-window, d-window) cell key space.
//
// Why native: the builder's output order is a stable lexsort of 10^8 tokens
// by (w-window, d-window). NumPy needs a comparison argsort plus several
// 100M-element gathers (~170 s measured at NYTimes scale on this host);
// counting sort over the small key space (nwin_w * nwin_d cells) writes
// every output slot directly in linear passes (~40 s on the same host —
// memory-bound; the AoS scatter keeps it to one cache-miss per token).
// Output is BIT-IDENTICAL to the Python builders: within a cell, tokens
// keep original corpus order, exactly like a stable lexsort.
//
// C ABI (ctypes; no pybind11 in this image):
//   cb_size(...)  -> sizing pass: total layout-A chunk rows (incl. window
//                    padding + the guaranteed all-pad tail block) and total
//                    layout-B chunk rows.
//   cb_build(...) -> fills caller-allocated output arrays.
//
// Memory note: two int64 scratch arrays of nwin_w * nwin_d entries are
// allocated (the cell key space); 235k cells at NYTimes scale, ~64M at
// PubMed scale (0.5 GB) — acceptable on a host with corpus-sized RAM.

#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

struct Geom {
    int64_t nwin_w, nwin_d, bpc, kk;
};

inline Geom geom(int64_t num_types, int64_t num_docs, int64_t block,
                 int64_t vspan, int64_t dspan, int64_t chunk) {
    Geom g;
    g.nwin_w = (num_types + vspan - 1) / vspan;
    if (g.nwin_w < 1) g.nwin_w = 1;
    g.nwin_d = (num_docs + dspan - 1) / dspan;
    if (g.nwin_d < 1) g.nwin_d = 1;
    g.bpc = block / chunk;
    g.kk = g.nwin_w * g.nwin_d;
    return g;
}

// per-cell chunk counts (counting pass over the tokens)
void count_cells(const int32_t* tokens, const int32_t* docs, int64_t n,
                 int64_t vspan, int64_t dspan, const Geom& g,
                 std::vector<int64_t>& cell_tokens) {
    cell_tokens.assign(g.kk, 0);
    for (int64_t i = 0; i < n; ++i) {
        int64_t k = (int64_t)(tokens[i] / vspan) * g.nwin_d
                    + docs[i] / dspan;
        ++cell_tokens[k];
    }
}

}  // namespace

extern "C" {

int cb_size(const int32_t* tokens, const int32_t* docs, int64_t n,
            int64_t num_types, int64_t num_docs, int64_t block,
            int64_t vspan, int64_t dspan, int64_t chunk,
            int64_t* out_total_rows, int64_t* out_total_b) {
    if (block % chunk != 0) return 1;
    Geom g = geom(num_types, num_docs, block, vspan, dspan, chunk);
    std::vector<int64_t> cell_tokens;
    count_cells(tokens, docs, n, vspan, dspan, g, cell_tokens);

    std::vector<int64_t> win_chunks(g.nwin_w, 0), dwin_chunks(g.nwin_d, 0);
    for (int64_t k = 0; k < g.kk; ++k) {
        if (!cell_tokens[k]) continue;
        int64_t c = (cell_tokens[k] + chunk - 1) / chunk;
        win_chunks[k / g.nwin_d] += c;
        dwin_chunks[k % g.nwin_d] += c;
    }
    int64_t total_rows = 0;
    for (int64_t w = 0; w < g.nwin_w; ++w) {
        int64_t r = win_chunks[w];
        r = r ? ((r + g.bpc - 1) / g.bpc) * g.bpc : g.bpc;
        total_rows += r;
    }
    total_rows += g.bpc;  // all-pad tail block
    int64_t total_b = 0;
    for (int64_t d = 0; d < g.nwin_d; ++d) {
        int64_t r = dwin_chunks[d];
        r = r ? ((r + g.bpc - 1) / g.bpc) * g.bpc : g.bpc;
        total_b += r;
    }
    *out_total_rows = total_rows;
    *out_total_b = total_b;
    return 0;
}

int cb_build(const int32_t* tokens, const int32_t* docs, int64_t n,
             int64_t num_types, int64_t num_docs, int64_t block,
             int64_t vspan, int64_t dspan, int64_t chunk,
             int32_t* w_local, int32_t* doc_ids, int32_t* d_local_a,
             uint8_t* mask, int64_t* flat_index, int32_t* win_d_chunks,
             int32_t* win_w, int32_t* first_w,
             int32_t* src_chunks, int32_t* win_d, int32_t* first_d) {
    if (block % chunk != 0) return 1;
    Geom g = geom(num_types, num_docs, block, vspan, dspan, chunk);
    std::vector<int64_t> cell_tokens;
    count_cells(tokens, docs, n, vspan, dspan, g, cell_tokens);

    // layout A row placement: cells in key order; each window's rows padded
    // to a block multiple (empty windows get one all-pad block)
    std::vector<int64_t> row_start(g.kk, -1);   // first chunk row per cell
    std::vector<int64_t> win_rows(g.nwin_w, 0);
    {
        for (int64_t k = 0; k < g.kk; ++k)
            if (cell_tokens[k])
                win_rows[k / g.nwin_d] +=
                    (cell_tokens[k] + chunk - 1) / chunk;
        int64_t row = 0;
        int64_t k = 0;
        for (int64_t w = 0; w < g.nwin_w; ++w) {
            int64_t r0 = row;
            for (; k < (w + 1) * g.nwin_d; ++k) {
                if (!cell_tokens[k]) continue;
                row_start[k] = row;
                row += (cell_tokens[k] + chunk - 1) / chunk;
            }
            int64_t padded = win_rows[w]
                ? ((win_rows[w] + g.bpc - 1) / g.bpc) * g.bpc : g.bpc;
            row = r0 + padded;
            win_rows[w] = padded;  // now padded row count
        }
    }
    int64_t total_rows = g.bpc;  // tail block
    for (int64_t w = 0; w < g.nwin_w; ++w) total_rows += win_rows[w];
    int64_t nba = total_rows / g.bpc;

    // defaults
    std::fill(w_local, w_local + total_rows * chunk, (int32_t)vspan);
    std::memset(doc_ids, 0, sizeof(int32_t) * total_rows * chunk);
    std::fill(d_local_a, d_local_a + total_rows * chunk, (int32_t)dspan);
    std::memset(mask, 0, total_rows * chunk);
    std::fill(flat_index, flat_index + total_rows * chunk, (int64_t)-1);
    std::memset(win_d_chunks, 0, sizeof(int32_t) * total_rows);

    // per-block window ids / first flags (+ tail block on the last window)
    {
        int64_t b = 0;
        for (int64_t w = 0; w < g.nwin_w; ++w)
            for (int64_t r = 0; r < win_rows[w]; r += g.bpc) {
                win_w[b] = (int32_t)w;
                first_w[b] = (r == 0) ? 1 : 0;
                ++b;
            }
        win_w[b] = (int32_t)(g.nwin_w - 1);
        first_w[b] = 0;
        (void)nba;
    }

    // win_d_chunks for real chunk rows
    for (int64_t k = 0; k < g.kk; ++k) {
        if (!cell_tokens[k]) continue;
        int64_t c = (cell_tokens[k] + chunk - 1) / chunk;
        int32_t dw = (int32_t)(k % g.nwin_d);
        for (int64_t j = 0; j < c; ++j)
            win_d_chunks[row_start[k] + j] = dw;
    }

    // token fill pass (original order within each cell == stable lexsort).
    // Two-step: scatter one packed 16-byte record per token (ONE cache-miss
    // write instead of five separate-array writes), then unpack records
    // sequentially cell by cell — ~4x faster at 100M tokens.
    {
        struct Rec { int32_t w, d; int64_t flat; };
        std::unique_ptr<Rec[]> aos(new Rec[(size_t)n]);
        // per-cell cursor into the AoS, laid out cells-in-key-order packed
        std::vector<int64_t> aos_start(g.kk, 0);
        {
            int64_t acc = 0;
            for (int64_t k = 0; k < g.kk; ++k) {
                aos_start[k] = acc;
                acc += cell_tokens[k];
            }
        }
        {
            std::vector<int64_t> cursor(g.kk, 0);
            for (int64_t i = 0; i < n; ++i) {
                int32_t w = tokens[i], d = docs[i];
                int64_t k = (int64_t)(w / vspan) * g.nwin_d + d / dspan;
                aos[aos_start[k] + cursor[k]++] = Rec{w, d, i};
            }
        }
        for (int64_t k = 0; k < g.kk; ++k) {
            if (!cell_tokens[k]) continue;
            int64_t base = row_start[k] * chunk;
            const Rec* r = aos.get() + aos_start[k];
            for (int64_t j = 0; j < cell_tokens[k]; ++j) {
                w_local[base + j] = r[j].w % (int32_t)vspan;
                doc_ids[base + j] = r[j].d;
                d_local_a[base + j] = r[j].d % (int32_t)dspan;
                mask[base + j] = 1;
                flat_index[base + j] = r[j].flat;
            }
        }
    }

    // layout B: chunk rows regrouped d-window-major (cell-key order within
    // a d-window), padded per window with the guaranteed all-pad tail chunk
    {
        std::vector<int64_t> d_rows(g.nwin_d, 0);
        for (int64_t k = 0; k < g.kk; ++k)
            if (cell_tokens[k])
                d_rows[k % g.nwin_d] += (cell_tokens[k] + chunk - 1) / chunk;
        std::vector<int64_t> d_off(g.nwin_d + 1, 0);
        for (int64_t d = 0; d < g.nwin_d; ++d) {
            int64_t padded = d_rows[d]
                ? ((d_rows[d] + g.bpc - 1) / g.bpc) * g.bpc : g.bpc;
            d_off[d + 1] = d_off[d] + padded;
        }
        int64_t total_b = d_off[g.nwin_d];
        int32_t pad_row = (int32_t)(total_rows - 1);
        std::fill(src_chunks, src_chunks + total_b, pad_row);
        std::vector<int64_t> cur(g.nwin_d, 0);
        for (int64_t k = 0; k < g.kk; ++k) {
            if (!cell_tokens[k]) continue;
            int64_t c = (cell_tokens[k] + chunk - 1) / chunk;
            int64_t dw = k % g.nwin_d;
            for (int64_t j = 0; j < c; ++j)
                src_chunks[d_off[dw] + cur[dw]++] =
                    (int32_t)(row_start[k] + j);
        }
        int64_t b = 0;
        for (int64_t d = 0; d < g.nwin_d; ++d) {
            int64_t rows = d_off[d + 1] - d_off[d];
            for (int64_t r = 0; r < rows; r += g.bpc) {
                win_d[b] = (int32_t)d;
                first_d[b] = (r == 0) ? 1 : 0;
                ++b;
            }
        }
    }
    return 0;
}

}  // extern "C"
