// Native StreamBlocks builder: the corpus/ragged.py build_stream_blocks_seq
// layout (d-window-major sequential-safe chunks for the HBM-streamed fused
// PCGS sweep) computed by counting sort — BIT-IDENTICAL to the NumPy
// builder, which needs three full-corpus lexsorts (minutes at NYTimes
// scale on this host).
//
// Layout recap: tokens sorted by (d-window, w-window, occurrence-rank,
// doc); each (dw, ww, rank) pseudo-cell holds at most one token per doc
// (so no 128-token chunk carries two tokens of one document) and, with
// dspan <= chunk, occupies exactly one chunk. Within a pseudo-cell tokens
// are doc-ascending; ranks are per-(cell, doc) occurrence indices in
// corpus order.
//
// Passes (all linear):
//   1. counting sort of tokens into (dw, ww) cells, corpus order kept;
//   2. per cell: bucket by local doc id (buckets inherit corpus order ==
//      rank order), histogram ranks -> per-rank chunk offsets, then emit
//      docs ascending, each doc's tokens to successive rank chunks;
//   3. window id arrays per chunk; tail padded to a block multiple.
//
// C ABI (ctypes): sb_size sizing pass, sb_build fill pass.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Geom {
    int64_t nwin_w, nwin_d, kk;
};

inline Geom geom(int64_t num_types, int64_t num_docs, int64_t vspan,
                 int64_t dspan) {
    Geom g;
    g.nwin_w = (num_types + vspan - 1) / vspan;
    if (g.nwin_w < 1) g.nwin_w = 1;
    g.nwin_d = (num_docs + dspan - 1) / dspan;
    if (g.nwin_d < 1) g.nwin_d = 1;
    g.kk = g.nwin_w * g.nwin_d;
    return g;
}

// cell key with d-window MAJOR: cell = dw * nwin_w + ww
inline int64_t cell_of(int32_t tok, int32_t doc, int64_t vspan,
                       int64_t dspan, const Geom& g) {
    return (int64_t)(doc / dspan) * g.nwin_w + tok / vspan;
}

// chunks of one cell = number of distinct ranks = max per-doc count
int64_t cell_chunks(const int32_t* cell_docs_local, int64_t size,
                    int64_t dspan, std::vector<int32_t>& cnt) {
    // cnt: caller-provided dspan-sized scratch, zeroed on entry/exit
    int64_t mx = 0;
    for (int64_t i = 0; i < size; ++i) {
        int32_t c = ++cnt[cell_docs_local[i]];
        if (c > mx) mx = c;
    }
    for (int64_t i = 0; i < size; ++i) cnt[cell_docs_local[i]] = 0;
    return mx;
}

}  // namespace

extern "C" {

int sb_size(const int32_t* tokens, const int32_t* docs, int64_t n,
            int64_t num_types, int64_t num_docs, int64_t block,
            int64_t vspan, int64_t dspan, int64_t chunk,
            int64_t* out_total_chunks) {
    if (block % chunk != 0 || dspan > chunk) return 1;
    Geom g = geom(num_types, num_docs, vspan, dspan);
    // counting pass: tokens per cell
    std::vector<int64_t> cell_sz(g.kk, 0);
    for (int64_t i = 0; i < n; ++i)
        ++cell_sz[cell_of(tokens[i], docs[i], vspan, dspan, g)];
    // group tokens' local doc ids per cell (corpus-order stable)
    std::vector<int64_t> off(g.kk + 1, 0);
    for (int64_t k = 0; k < g.kk; ++k) off[k + 1] = off[k] + cell_sz[k];
    std::vector<int32_t> dl(n);
    {
        std::vector<int64_t> cur(off.begin(), off.end() - 1);
        for (int64_t i = 0; i < n; ++i) {
            int64_t k = cell_of(tokens[i], docs[i], vspan, dspan, g);
            dl[cur[k]++] = docs[i] % dspan;
        }
    }
    std::vector<int32_t> cnt(dspan, 0);
    int64_t total_real = 0;
    for (int64_t k = 0; k < g.kk; ++k)
        if (cell_sz[k])
            total_real += cell_chunks(dl.data() + off[k], cell_sz[k],
                                      dspan, cnt);
    int64_t bpc = block / chunk;
    int64_t total = (total_real + bpc - 1) / bpc * bpc;
    if (total == 0) total = bpc;
    *out_total_chunks = total;
    return 0;
}

int sb_build(const int32_t* tokens, const int32_t* docs, int64_t n,
             int64_t num_types, int64_t num_docs, int64_t block,
             int64_t vspan, int64_t dspan, int64_t chunk,
             int64_t total_chunks,
             int32_t* w_local, int32_t* d_local, uint8_t* mask,
             int64_t* flat_index, int32_t* win_w_chunks,
             int32_t* win_d_chunks) {
    if (block % chunk != 0 || dspan > chunk) return 1;
    Geom g = geom(num_types, num_docs, vspan, dspan);
    std::vector<int64_t> cell_sz(g.kk, 0);
    for (int64_t i = 0; i < n; ++i)
        ++cell_sz[cell_of(tokens[i], docs[i], vspan, dspan, g)];
    std::vector<int64_t> off(g.kk + 1, 0);
    for (int64_t k = 0; k < g.kk; ++k) off[k + 1] = off[k] + cell_sz[k];
    // stable scatter of token indices into cells
    std::vector<int64_t> idx(n);
    {
        std::vector<int64_t> cur(off.begin(), off.end() - 1);
        for (int64_t i = 0; i < n; ++i) {
            int64_t k = cell_of(tokens[i], docs[i], vspan, dspan, g);
            idx[cur[k]++] = i;
        }
    }
    // upfront default fill of all slots (pad slots + pad chunks); the
    // caller passes the sb_size total, avoiding a second sizing pass
    int64_t total0 = total_chunks;
    for (int64_t s = 0; s < total0 * chunk; ++s) {
        w_local[s] = (int32_t)vspan;
        d_local[s] = (int32_t)dspan;
        mask[s] = 0;
        flat_index[s] = -1;
    }
    int64_t total_real = 0;  // chunk cursor
    std::vector<int32_t> cnt(dspan, 0);
    std::vector<int64_t> dloc_start(dspan + 1, 0);
    std::vector<int64_t> bucket(0);
    std::vector<int32_t> rank_fill(0);
    int32_t last_ww = 0, last_dw = 0;
    for (int64_t k = 0; k < g.kk; ++k) {
        int64_t size = cell_sz[k];
        if (!size) continue;
        int32_t dw = (int32_t)(k / g.nwin_w);
        int32_t ww = (int32_t)(k % g.nwin_w);
        const int64_t* ids = idx.data() + off[k];
        // bucket by local doc id (corpus order within doc == rank order)
        for (int64_t i = 0; i < size; ++i)
            ++cnt[docs[ids[i]] % dspan];
        int64_t nrank = 0;
        dloc_start[0] = 0;
        for (int64_t d = 0; d < dspan; ++d) {
            if (cnt[d] > nrank) nrank = cnt[d];
            dloc_start[d + 1] = dloc_start[d] + cnt[d];
            cnt[d] = 0;
        }
        if ((int64_t)bucket.size() < size) bucket.resize(size);
        for (int64_t i = 0; i < size; ++i) {
            int32_t d = docs[ids[i]] % dspan;
            bucket[dloc_start[d] + cnt[d]++] = ids[i];
        }
        for (int64_t d = 0; d < dspan; ++d) cnt[d] = 0;
        // per-rank slot cursors within the cell's nrank chunks
        if ((int64_t)rank_fill.size() < nrank) rank_fill.resize(nrank);
        for (int64_t r = 0; r < nrank; ++r) rank_fill[r] = 0;
        for (int64_t d = 0; d < dspan; ++d) {
            for (int64_t j = dloc_start[d]; j < dloc_start[d + 1]; ++j) {
                int64_t r = j - dloc_start[d];       // rank of this token
                int64_t slot = (total_real + r) * chunk + rank_fill[r]++;
                int64_t t = bucket[j];
                w_local[slot] = tokens[t] - ww * (int32_t)vspan;
                d_local[slot] = (int32_t)d;
                mask[slot] = 1;
                flat_index[slot] = t;
            }
        }
        for (int64_t r = 0; r < nrank; ++r) {
            win_w_chunks[total_real + r] = ww;
            win_d_chunks[total_real + r] = dw;
        }
        total_real += nrank;
        last_ww = ww;
        last_dw = dw;
    }
    // pad tail chunks keep the last windows (no spurious in-kernel DMA);
    // their slots already carry the sentinel defaults from the fill above
    for (int64_t r = total_real; r < total0; ++r) {
        win_w_chunks[r] = last_ww;
        win_d_chunks[r] = last_dw;
    }
    return 0;
}

}  // extern "C"
