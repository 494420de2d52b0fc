"""The count kernel's plain version against the JAX package's
`blocked_label_counts` (its CPU path) on layouts A and B, following
tests/test_cell_blocks.py::test_blocked_label_counts_both_layouts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu.ops.pallas_counts import (
    blocked_label_counts as jax_blocked_label_counts)
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
