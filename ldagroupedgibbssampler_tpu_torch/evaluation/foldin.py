"""Fold-in: sample z for documents under a FIXED phi, on the GGS kernels.

The port's counterpart of `ldagroupedgibbssampler_tpu/evaluation/
foldin.py`. It replaces ``sampleZGivenPhi``
(topics/UncollapsedParallelLDA.java:975-1014), which the reference invokes
one test document at a time. Here every document folds in at once: each
iteration draws theta_d ~ Dir(n_dk + alpha) for every document, then every
token's topic with probability proportional to theta_d[k] * phi[k][w] —
the GGS z-move, exact when phi is held fixed — then rebuilds n_dk.

That z-draw is the GGS z-draw kernel and that rebuild its count kernel, so
fold-in runs them on the corpus's GGS cell blocks
(`corpus/ragged.py::build_cell_blocks`, as `models/ggs.py` lays out its
own corpus): `ops/cuda_zdraw.py::fused_zdraw_nkw` in its precise mode (the
JAX fold-in is float32 throughout) on layout A, then
`ops/cuda_counts.py::blocked_label_counts` on layout B. A CPU tensor runs
both kernels' plain versions. phi is clamped to 1e-30 as the JAX
package's log(max(phi, 1e-30)) is, so a token whose phi column is 0 still
draws a topic instead of keeping its old one (the kernel keeps z where the
total is 0).

Returns the final z, n_dk and N_kw (the z-draw's own count) and the mean
of theta over the iterations after burn-in (getThetaEstimate).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.corpus.ragged import (CellBlocks,
                                                            Corpus,
                                                            real_slot_list)
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
from ldagroupedgibbssampler_tpu_torch.ops.cuda_counts import (
    blocked_label_counts)
from ldagroupedgibbssampler_tpu_torch.ops.cuda_zdraw import fused_zdraw_nkw

PHI_FLOOR = 1e-30


@dataclass
class FoldIn:
    """What `fold_in` returns. z is flat over the layout-A slots of
    `blocks` (`flat_z()` gives canonical token order); ndk [D, K] and
    nkw_vk [V, K] int32 are the counts of that z; theta_mean [D, K]
    float32."""
    z: torch.Tensor
    ndk: torch.Tensor
    nkw_vk: torch.Tensor
    theta_mean: torch.Tensor
    blocks: CellBlocks
    num_tokens: int

    def flat_z(self) -> np.ndarray:
        """z in canonical token order [N]."""
        idx = self.blocks.flat_index.reshape(-1)
        z = self.z.cpu().numpy()
        out = np.zeros(self.num_tokens, np.int32)
        valid = idx >= 0
        out[idx[valid]] = z[valid]
        return out


def fold_in(phi_kv: torch.Tensor, corpus: Corpus, alpha,
            generator: torch.Generator, iterations: int = 100,
            burnin: Optional[int] = None, *, token_block: int = 4096,
            vocab_span: int = 128, doc_span: int = 128,
            blocks: Optional[CellBlocks] = None) -> FoldIn:
    """Fold `corpus` into a model with topic-word matrix `phi_kv` ([K, V],
    rows normalised, a tensor on the device to run on). `alpha` is a
    scalar or [K]; draws come from `generator` (on the same device).
    `blocks` reuses cell blocks already built for this corpus with these
    spans (the GGS sampler's own)."""
    if iterations < 1:
        raise ValueError("fold_in needs at least one iteration")
    if burnin is None:
        burnin = iterations // 2
    dev = phi_kv.device
    num_topics, num_types = phi_kv.shape
    if blocks is None:
        blocks = corpus.cell_blocks(block=token_block, vspan=vocab_span,
                                    dspan=doc_span)
    if corpus.num_docs == 0:
        # no document to fold in: empty counts and theta, as the JAX
        # fold-in returns (an id file that matches no document)
        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)
        return FoldIn(z=zeros(blocks.mask.size), ndk=zeros(0, num_topics),
                      nkw_vk=zeros(num_types, num_topics),
                      theta_mean=zeros(0, num_topics, dtype=torch.float32),
                      blocks=blocks, num_tokens=0)

    def t(a):
        return torch.as_tensor(a, device=dev)

    nb = blocks.w_local.shape[0]
    shape3 = (nb, blocks.w_local.shape[1] // blocks.chunk, blocks.chunk)
    wb, dla, winb = t(blocks.w_local), t(blocks.d_local_a), t(blocks.win_w)
    firstb, windc = t(blocks.first_w), t(blocks.win_d_chunks)
    real_slots = t(real_slot_list(blocks.mask))
    srcb, dlb = t(blocks.src_chunks.astype(np.int64)), t(blocks.d_local)
    windb, firstdb = t(blocks.win_d), t(blocks.first_d)
    mf = t(blocks.mask.reshape(-1))

    def count_ndk(z):
        z_b = z.view(-1, blocks.chunk)[srcb].view(dlb.shape)
        return blocked_label_counts(
            dlb, z_b, windb, firstdb, nwin=blocks.nwin_d,
            vspan=blocks.dspan, num_labels=num_topics)[: corpus.num_docs]

    phi_vk = phi_kv.to(torch.float32).T.clamp_min(PHI_FLOOR).contiguous()
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    alpha = alpha.expand(num_topics)
    z = torch.randint(0, num_topics, mf.shape, generator=generator,
                      device=dev, dtype=torch.int32)
    z = torch.where(mf, z, 0)
    ndk = count_ndk(z)
    theta_sum = torch.zeros((corpus.num_docs, num_topics),
                            dtype=torch.float32, device=dev)
    for it in range(iterations):
        theta = rnd.dirichlet(ndk.to(torch.float32) + alpha, generator)
        seed = torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=dev, dtype=torch.int64)
        z3, nkw = fused_zdraw_nkw(
            wb.view(shape3), dla.view(shape3), z.view(shape3), theta, phi_vk,
            seed, winb, firstb, windc, nwin_w=blocks.nwin_w,
            nwin_d=blocks.nwin_d, vspan=blocks.vspan, dspan=blocks.dspan,
            num_topics=num_topics, precise=True, real_slots=real_slots)
        z = z3.view(-1)
        ndk = count_ndk(z)
        if it >= burnin:
            theta_sum += theta
    theta_mean = theta_sum / max(iterations - burnin, 1)
    return FoldIn(z=z, ndk=ndk, nkw_vk=nkw[:num_types],
                  theta_mean=theta_mean, blocks=blocks,
                  num_tokens=corpus.num_tokens)
