"""Count matrices rebuilt from z, in plain PyTorch.

The port's copy of `ldagroupedgibbssampler_tpu/ops/counts.py`
(`topic_word_counts`, `doc_topic_counts`, `tokens_per_topic`). The
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
