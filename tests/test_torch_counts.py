"""The count kernel's plain version against the JAX package's
`blocked_label_counts` (its CPU path) on layouts A and B, following
tests/test_cell_blocks.py::test_blocked_label_counts_both_layouts; the
kernel's choice of instance from the shapes; and a numpy model of its
shared-memory algorithm (per-CTA window histograms of 16-bit counters,
flushed once a run of blocks) against the plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu.ops.pallas_counts import (
    blocked_label_counts as jax_blocked_label_counts)
from ldagroupedgibbssampler_tpu_torch.ops import cuda_counts
from ldagroupedgibbssampler_tpu_torch.ops.cuda_counts import (
    blocked_label_counts, blocked_label_counts_reference)


def _corpus(num_docs, num_types, seed=0, max_len=80):
    rng = np.random.default_rng(seed)
    docs = [list(rng.integers(0, num_types, rng.integers(1, max_len)))
            for _ in range(num_docs)]
    return Corpus.from_token_lists(docs, [f"w{i}" for i in range(num_types)])


@pytest.mark.parametrize("num_docs,num_types,block,span,K", [
    (120, 700, 256, 512, 9), (1300, 3000, 1024, 512, 9),
    (200, 500, 512, 128, 130)])
def test_counts_match_jax_both_layouts(num_docs, num_types, block, span, K):
    c = _corpus(num_docs, num_types, seed=3)
    cb = c.cell_blocks(block=block, vspan=span, dspan=span, chunk=128)
    z = np.random.default_rng(5).integers(0, K, cb.mask.shape).astype(
        np.int32)
    z_b = z.reshape(-1, cb.chunk)[cb.src_chunks].reshape(cb.d_local.shape)
    for ids, labels, win, first, nwin, nrows in (
            (cb.w_local, z, cb.win_w, cb.first_w, cb.nwin_w, num_types),
            (cb.d_local, z_b, cb.win_d, cb.first_d, cb.nwin_d, num_docs)):
        kw = dict(nwin=nwin, vspan=span, num_labels=K)
        ref = np.asarray(jax_blocked_label_counts(
            jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(win),
            jnp.asarray(first), **kw))
        args = [torch.as_tensor(a) for a in (ids, labels, win, first)]
        ours = blocked_label_counts_reference(*args, **kw)
        assert ours.dtype == torch.int32
        assert np.array_equal(ours.numpy(), ref)
        # the public wrapper takes the plain version for CPU tensors
        assert torch.equal(blocked_label_counts(*args, **kw), ours)
        assert int(ours[:nrows].sum()) == c.num_tokens


# ---------------------------------------------------------------------
# the kernel's instances and a model of its shared-memory algorithm
# ---------------------------------------------------------------------


@pytest.mark.parametrize("vspan,K,kind,smem", [
    (128, 5, "shared", 1280), (128, 100, "shared", 25_600),
    (128, 130, "shared", 33_280), (128, 454, "shared", 116_224),
    (128, 4096, "global", 0), (512, 5, "shared", 5120),
    (512, 100, "shared", 102_400), (512, 130, "shared", 133_120),
    (512, 454, "global", 0), (512, 4096, "global", 0)])
def test_count_instance_from_shapes(vspan, K, kind, smem):
    """The shared instance where the window's histogram (two 16-bit
    counters a word) fits the opt-in shared memory, the global one
    otherwise; a CTA's run of blocks never lets a counter pass 65,535."""
    for block in (512, 4096):
        inst = cuda_counts.count_instance(vspan, K, block)
        assert (inst.kind, inst.shared_bytes) == (kind, smem)
        assert inst.shared_bytes <= cuda_counts.SHARED_LIMIT
        if kind == "shared":
            assert 1 <= inst.run_blocks <= cuda_counts.RUN_BLOCKS
            assert inst.run_blocks * block <= cuda_counts.COUNTER_MAX
        else:
            assert inst.run_blocks == 0
    # a block longer than a 16-bit counter's range takes the global one
    assert cuda_counts.count_instance(vspan, 5, 1 << 16).kind == "global"


def _shared_model(ids, labels, win, *, nwin, vspan, num_labels, run_blocks):
    """numpy model of the shared instance: CTA c takes blocks
    [c * run_blocks, (c + 1) * run_blocks), counts its current window into
    packed 16-bit counters (two a uint32 word), flushes the non-zero cells
    to the output when the window changes and at the end of its run.
    Returns (output, the largest count a counter held at a flush)."""
    nb, block = ids.shape
    cells = vspan * num_labels
    out = np.zeros(nwin * cells, np.int64)
    peak = 0
    for b0 in range(0, nb, run_blocks):
        words = np.zeros((cells + 1) // 2, np.uint32)
        exact = np.zeros(cells, np.int64)
        cur = win[b0]

        def flush(w):
            lo = (words & 0xFFFF).astype(np.int64)
            hi = (words >> 16).astype(np.int64)
            packed = np.stack([lo, hi], 1).reshape(-1)[:cells]
            out[w * cells:(w + 1) * cells] += packed
            words[:] = 0
            return packed
        for b in range(b0, min(b0 + run_blocks, nb)):
            if win[b] != cur:
                peak = max(peak, int(exact.max()))
                assert np.array_equal(flush(cur), exact)
                exact[:] = 0
                cur = win[b]
            ok = (ids[b] < vspan) & (labels[b] < num_labels)
            cell = ids[b][ok].astype(np.int64) * num_labels + labels[b][ok]
            np.add.at(exact, cell, 1)
            np.add.at(words, cell >> 1,
                      (np.uint32(1) << (16 * (cell & 1))).astype(np.uint32))
        peak = max(peak, int(exact.max()))
        packed = flush(cur)
        if peak <= cuda_counts.COUNTER_MAX:
            assert np.array_equal(packed, exact)
    return out.reshape(nwin * vspan, num_labels), peak


def test_shared_model_equals_plain_on_zipf_concentrated():
    """The shared instance's algorithm, modelled in numpy, equals the
    plain version on a Zipf corpus's layout A with concentrated z (each
    word's tokens on w mod K with probability 0.9), and on layout B."""
    rng = np.random.default_rng(4)
    v, k, block = 2000, 100, 512
    p = 1.0 / np.arange(1, v + 1) ** 1.1
    docs = [list(rng.choice(v, rng.integers(5, 120), p=p / p.sum()))
            for _ in range(400)]
    c = Corpus.from_token_lists(docs, [f"w{i}" for i in range(v)])
    cb = c.cell_blocks(block=block, vspan=128, dspan=128, chunk=128)
    word = cb.win_w[:, None].astype(np.int64) * 128 + cb.w_local
    z = np.where(rng.random(word.shape) < 0.9, word % k,
                 rng.integers(0, k, word.shape))
    z = np.where(cb.mask, z, 0).astype(np.int32)
    z_b = z.reshape(-1, cb.chunk)[cb.src_chunks].reshape(cb.d_local.shape)
    for ids, labels, win, first, nwin in (
            (cb.w_local, z, cb.win_w, cb.first_w, cb.nwin_w),
            (cb.d_local, z_b, cb.win_d, cb.first_d, cb.nwin_d)):
        kw = dict(nwin=nwin, vspan=128, num_labels=k)
        inst = cuda_counts.count_instance(128, k, block)
        assert inst.kind == "shared" and inst.run_blocks > 1
        got, peak = _shared_model(ids, labels, win,
                                  run_blocks=inst.run_blocks, **kw)
        ref = blocked_label_counts_reference(
            *(torch.as_tensor(a) for a in (ids, labels, win, first)), **kw)
        assert np.array_equal(got, ref.numpy())
        assert peak <= cuda_counts.COUNTER_MAX
    # the head word's hot cell takes many of one window's slots
    assert (word[cb.mask] == 0).mean() > 0.05


def test_shared_counters_flush_before_overflow(monkeypatch):
    """16 blocks of 4096 equal keys in one cell: the run of blocks is cut
    so each counter is flushed before it reaches 65,536, and the sum is
    exact; a run one block longer would carry into the neighbour."""
    nb, block = 16, 4096
    ids = np.zeros((nb, block), np.int32)
    labels = np.zeros((nb, block), np.int32)
    win = np.zeros(nb, np.int32)
    kw = dict(nwin=1, vspan=128, num_labels=100)
    monkeypatch.setattr(cuda_counts, "RUN_BLOCKS", 64)
    inst = cuda_counts.count_instance(128, 100, block)
    assert inst.run_blocks == 15
    got, peak = _shared_model(ids, labels, win, run_blocks=inst.run_blocks,
                              **kw)
    assert peak == 15 * block < 1 << 16
    assert got[0, 0] == nb * block and got.sum() == nb * block
    bad, peak = _shared_model(ids, labels, win, run_blocks=16, **kw)
    assert peak == 1 << 16 and bad[0, 0] != nb * block
