"""Count matrices rebuilt from z, in plain PyTorch.

The port's copy of `ldagroupedgibbssampler_tpu/ops/counts.py`
(`topic_word_counts`, `doc_topic_counts`, `tokens_per_topic`,
`padded_doc_topic_counts`, `check_count_consistency`). The
reference maintains typeTopicCounts / tokensPerTopic with per-sweep delta
merges (UncollapsedParallelLDA.java:102,363-368,1107-1221); here counts are
rebuilt from the assignment vector with one accumulate, for the init, for
`set_z_indicators` and for the recount a checkpoint is checked against.
Slots where `mask` is False contribute nothing.
"""

from __future__ import annotations

import torch


def _histogram(rows, cols, mask, shape) -> torch.Tensor:
    m = mask.reshape(-1)
    r = rows.reshape(-1)[m].to(torch.int64)
    c = cols.reshape(-1)[m].to(torch.int64)
    out = torch.zeros(shape, dtype=torch.int32, device=rows.device)
    out.index_put_((r, c), torch.ones_like(r, dtype=torch.int32),
                   accumulate=True)
    return out


def topic_word_counts(z, w, mask, num_topics: int,
                      num_types: int) -> torch.Tensor:
    """N_kw [K, V] int32: tokens of type w assigned to topic k."""
    return _histogram(z, w, mask, (num_topics, num_types))


def doc_topic_counts(z, doc_ids, mask, num_docs: int,
                     num_topics: int) -> torch.Tensor:
    """N_dk [D, K] int32: tokens of doc d assigned to topic k."""
    return _histogram(doc_ids, z, mask, (num_docs, num_topics))


def tokens_per_topic(nkw: torch.Tensor) -> torch.Tensor:
    """n_k [K] = row sums of N_kw [K, V]."""
    return nkw.sum(dim=-1, dtype=torch.int32)


def padded_doc_topic_counts(z_pad, mask, num_topics: int) -> torch.Tensor:
    """N_dk [D, K] int32 from the doc-major padded layout z_pad [D, L]
    (mask [D, L] False on padding): each row's histogram, without a
    doc-id array."""
    rows = torch.arange(z_pad.shape[0], device=z_pad.device)[:, None]
    return _histogram(rows.expand(z_pad.shape), z_pad, mask,
                      (z_pad.shape[0], num_topics))


def check_count_consistency(nkw, ndk, num_tokens: int) -> dict:
    """Paranoid-mode invariants (the analogue of
    ensureConsistentTopicTypeCounts / ensureTTEquals,
    UncollapsedParallelLDA.java:299-351): both count matrices sum to the
    corpus token count, their per-topic marginals agree, and no count is
    negative. `nkw` is [K, V]. Returns a dict of Python bools."""
    ndk = ndk.reshape(-1, ndk.shape[-1])
    return {
        "nkw_sum_ok": int(nkw.sum(dtype=torch.int64)) == num_tokens,
        "ndk_sum_ok": int(ndk.sum(dtype=torch.int64)) == num_tokens,
        "marginals_match": bool(torch.equal(
            nkw.sum(dim=1, dtype=torch.int64),
            ndk.sum(dim=0, dtype=torch.int64))),
        "non_negative": bool((nkw >= 0).all() and (ndk >= 0).all()),
    }
