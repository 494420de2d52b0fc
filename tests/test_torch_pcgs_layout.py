"""The port's sequential-safe layouts (resident `build_cell_blocks_seq`,
streamed `build_stream_blocks_seq`) equal the JAX package's field by field
on the corpora of tests/test_pallas_pcgs.py, keep that file's layout
invariants, and give the per-document visit order the PCGS kernel walks."""

import dataclasses

import numpy as np
import pytest

from ldagroupedgibbssampler_tpu.corpus import ragged as jax_ragged
from ldagroupedgibbssampler_tpu_torch.corpus import ragged
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus


def _rand_corpus(seed=0, docs=70, vocab=300, max_len=60):
    rng = np.random.default_rng(seed)
    toks = [list(rng.integers(0, vocab, rng.integers(3, max_len)))
            for _ in range(docs)]
    return Corpus.from_token_lists(toks, [f"w{i}" for i in range(vocab)])


def _assert_equal_fields(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


LAYOUTS = [(128, 128, 512), (256, 64, 512), (128, 128, 1024)]


@pytest.mark.parametrize("vspan,dspan,block", LAYOUTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_seq_layout_equals_jax(seed, vspan, dspan, block):
    c = _rand_corpus(seed)
    args = (c.tokens, c.token_doc_ids(), c.num_types, c.num_docs)
    kw = dict(block=block, vspan=vspan, dspan=dspan, chunk=128)
    _assert_equal_fields(ragged.build_cell_blocks_seq(*args, **kw),
                         jax_ragged.build_cell_blocks_seq(*args, **kw))
    _assert_equal_fields(ragged.build_stream_blocks_seq(*args, **kw),
                         jax_ragged.build_stream_blocks_seq(*args, **kw))
    _assert_equal_fields(ragged.build_stream_blocks(*args, **kw),
                         jax_ragged.build_stream_blocks(*args, **kw))


@pytest.mark.parametrize("vspan,dspan,block", LAYOUTS)
def test_seq_layout_invariants(vspan, dspan, block):
    """tests/test_pallas_pcgs.py::test_seq_layout_invariants on the port's
    resident layout: no chunk holds two tokens of one document, one
    d-window per chunk, every token placed once, pads sentineled."""
    c = _rand_corpus()
    b = c.cell_blocks_seq(block=block, vspan=vspan, dspan=dspan, chunk=128)
    nch = b.w_local.size // b.chunk
    did = b.doc_ids.reshape(nch, b.chunk)
    m = b.mask.reshape(nch, b.chunk)
    for r in range(nch):
        d = did[r][m[r]].tolist()
        assert len(d) == len(set(d))
        if d:
            assert (did[r][m[r]] // dspan == b.win_d_chunks[r]).all()
    fi = b.flat_index[b.mask]
    assert sorted(fi) == list(range(c.num_tokens))
    wg = b.w_local + b.win_w[:, None] * vspan
    assert np.array_equal(wg[b.mask], c.tokens[b.flat_index[b.mask]])
    assert np.all(b.w_local[~b.mask] == vspan)
    assert np.all(b.d_local_a[~b.mask] == dspan)
    recon = (b.win_d_chunks.reshape(nch, 1) * dspan
             + b.d_local_a.reshape(nch, b.chunk))
    assert np.array_equal(recon[m], did[m])
    assert np.all(np.diff(b.win_w) >= 0)
    assert b.first_w.sum() == b.nwin_w


@pytest.mark.parametrize("streamed", [False, True])
def test_doc_visit_order(streamed):
    """Each document's slot list holds exactly its tokens, in increasing
    slot order; no chunk appears twice in one document's list."""
    c = _rand_corpus(3, docs=200, vocab=400)
    args = (c.tokens, c.token_doc_ids(), c.num_types, c.num_docs)
    if streamed:
        b = ragged.build_stream_blocks_seq(*args, block=512)
        d_local = b.d_local
    else:
        b = ragged.build_cell_blocks_seq(*args, block=512)
        d_local = b.d_local_a
    off, slots = ragged.doc_visit_order(
        d_local, b.win_d_chunks, dspan=b.dspan, chunk=b.chunk,
        num_docs=c.num_docs)
    assert off.dtype == np.int32 and slots.dtype == np.int32
    assert off[-1] == c.num_tokens == len(slots)
    fi = b.flat_index.reshape(-1)
    dall = c.token_doc_ids()
    for d in range(c.num_docs):
        s = slots[off[d]:off[d + 1]]
        assert np.all(np.diff(s) > 0)
        assert len(np.unique(s // b.chunk)) == len(s)
        assert sorted(fi[s]) == list(range(c.doc_offsets[d],
                                           c.doc_offsets[d + 1]))
        assert np.all(dall[fi[s]] == d)
