"""Held-out log-likelihood: Wallach left-to-right particle estimator.

The port's counterpart of `ldagroupedgibbssampler_tpu/evaluation/
marginal.py`, in plain PyTorch on the tensors' device.

Reference: topics/MarginalProbEstimatorPlain.java — `evaluateLeftToRight`
(:85) runs `numParticles` independent left-to-right passes per document
(:97-100) with `usingResampling = false` (:125) and combines them as
log mean_r p_r(w_n) per position (:105, logNumParticles :89). Word
probabilities come from the dense type-topic counts:
p(w|k) = (beta + n_kw) / (V beta + n_k), or from a row-normalised phi.

On a CUDA device with a `generator`, the estimator is the hand-written
kernel of `ops/cuda_left_to_right.py` (csrc/left_to_right.cu): the
position loop inside one launch, each particle's draw an inverse CDF from
one Philox uniform keyed by a seed from `generator`. Otherwise (the CPU,
or injected noise on any device) it is the plain version below: one pass
over the token positions, vectorised over every test document and every
particle, the carry the particles' doc-topic counts [R, D, K], each
position drawing every particle's topic by Gumbel-max. The noise comes
from `generator`, or from `gumbel(t)`, a callable returning position t's
[R, D, K] float32 noise (the tests feed in the JAX function's own draws
through it).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.ops import cuda_left_to_right
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd

_EPS = 1e-30


def _gumbel(shape, generator, device) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def left_to_right_from_word_prob(w_pad, mask_pad, word_prob, alpha,
                                 num_particles: int = 100,
                                 generator: Optional[torch.Generator] = None,
                                 gumbel: Optional[Callable] = None
                                 ) -> torch.Tensor:
    """Total held-out LL (0-d float32 tensor) of the padded test documents
    w_pad / mask_pad [D, L] under word_prob [K, V], on word_prob's device.
    The noise comes from `generator` or `gumbel`; one of them is needed.
    On a CUDA device with a generator the kernel runs."""
    if generator is None and gumbel is None:
        raise ValueError("the left-to-right estimator needs a generator or "
                         "injected gumbel noise")
    dev = word_prob.device
    if gumbel is None and dev.type != "cpu":
        return cuda_left_to_right.left_to_right(
            w_pad, mask_pad, word_prob, alpha, num_particles,
            rnd.kernel_seed(generator, dev))
    w_pad = torch.as_tensor(w_pad, device=dev).to(torch.int64)
    mask_pad = torch.as_tensor(mask_pad, device=dev)
    num_docs, length = w_pad.shape
    num_topics = word_prob.shape[0]
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    alpha = alpha.expand(num_topics).contiguous()
    alpha_sum = alpha.sum()
    word_prob_t = word_prob.to(torch.float32).T.contiguous()   # [V, K]
    shape = (num_particles, num_docs, num_topics)
    counts = torch.zeros(shape, dtype=torch.float32, device=dev)
    ll = torch.zeros(num_docs, dtype=torch.float32, device=dev)
    for t in range(length):
        wt, mt = w_pad[:, t], mask_pad[:, t]
        theta = ((counts + alpha) / (counts.sum(dim=-1, keepdim=True)
                                     + alpha_sum))
        scores = theta * word_prob_t[wt][None, :, :]            # [R, D, K]
        del theta
        p = scores.sum(dim=-1)                                   # [R, D]
        ll = ll + torch.where(mt, torch.log(p.mean(dim=0) + _EPS), 0.0)
        g = (gumbel(t) if gumbel is not None
             else _gumbel(shape, generator, dev))
        z = torch.argmax(torch.log(scores.add_(_EPS)).add_(
            g.to(device=dev, dtype=torch.float32)), dim=-1)     # [R, D]
        del scores, g
        # counts += onehot(z) on the documents that have a token here
        counts.scatter_add_(-1, z[..., None],
                            mt[None, :, None].expand(num_particles, -1, 1)
                            .to(torch.float32))
    return ll.sum()


def left_to_right_from_counts(w_pad, mask_pad, nkw_kv, nk, alpha,
                              beta: float, num_particles: int = 100,
                              generator: Optional[torch.Generator] = None,
                              gumbel: Optional[Callable] = None
                              ) -> torch.Tensor:
    """The estimator with the count-based word probabilities (the
    reference's own semantics): p(w|k) = (beta + n_kw) / (V beta + n_k)."""
    word_prob = ((beta + nkw_kv.to(torch.float32))
                 / (beta * nkw_kv.shape[1] + nk.to(torch.float32))[:, None])
    return left_to_right_from_word_prob(w_pad, mask_pad, word_prob, alpha,
                                        num_particles, generator, gumbel)


def left_to_right_log_likelihood(test_corpus: Corpus, phi_or_counts, alpha,
                                 num_particles: int = 100, nkw=None, nk=None,
                                 beta: float | None = None,
                                 generator: Optional[torch.Generator] = None,
                                 gumbel: Optional[Callable] = None) -> float:
    """Convenience wrapper over a `Corpus`: with `nkw`/`nk`/`beta` the
    count-based word probabilities, else `phi_or_counts` row-normalised as
    phi ([K, V] either way), on the device of the tensor given (the CPU
    for a NumPy array)."""
    w_pad, mask_pad = test_corpus.to_padded()
    if nkw is not None:
        return float(left_to_right_from_counts(
            w_pad, mask_pad, torch.as_tensor(nkw), torch.as_tensor(nk),
            alpha, float(beta), num_particles, generator, gumbel))
    phi = torch.as_tensor(phi_or_counts, dtype=torch.float32)
    phi = phi / phi.sum(dim=1, keepdim=True).clamp_min(_EPS)
    return float(left_to_right_from_word_prob(
        w_pad, mask_pad, phi, alpha, num_particles, generator, gumbel))
