"""What the sharded schemes share: one rank's part of a sharded chain.

The JAX package runs each sharded scheme as one `shard_map` program; here
each rank is a process (`parallel/mesh.py`) that runs the port's
single-device sampler on its own part of the corpus, with the merges of
the counts as all-reduces. These mixins go before that sampler in the MRO:

  - `ShardedMixin`: the mesh, two generators per rank, the merge of N_kw,
    a stop decision all ranks take together, accessors gathered to every
    rank in canonical corpus order, and the paranoid checks on the merged
    counts (which also hold every replicated tensor bit-equal across the
    ranks).
  - `DocShardedMixin`: documents sharded in contiguous ranges balanced by
    tokens (`partition_documents`). The rank's layout is the sampler's own
    layout of the sub-corpus of its documents, so its n_dk (and GGS theta)
    are rank-local; N_kw, n_k and phi are replicated.

Generators. `generator` is rank-local, seeded from (seed, rank) as the
JAX package's `fold_in(key, shard)`: it draws z and rank-local theta.
`shared_generator` has the same seed on every rank: it draws the initial z
(over the whole corpus in canonical order, so a chain starts from the same
z at every world size), phi and replicated theta, identically on every
rank from the merged counts. The random-scan masks are numpy from the
seed, so they are identical on every rank too.

A sharded step syncs with the host in its collectives, so it is never
captured in a CUDA graph (`_capturable_step = False`; the JAX package does
fuse its sharded steps).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.evaluation.likelihood import (
    doc_log_likelihood, doc_log_posterior, topic_log_likelihood, topics_kept,
    word_log_posterior)
from ldagroupedgibbssampler_tpu_torch.models.base import TorchLDASampler
from ldagroupedgibbssampler_tpu_torch.parallel.mesh import (
    gather_rows, make_mesh, psum, replicated_mismatches)


def partition_documents(corpus: Corpus, num_shards: int):
    """Contiguous doc ranges with balanced token counts. Returns
    doc_bounds[S+1] (greedy split along the cumulative token distribution)."""
    offsets = corpus.doc_offsets
    total = corpus.num_tokens
    bounds = [0]
    for s in range(1, num_shards):
        target = total * s / num_shards
        bounds.append(int(np.searchsorted(offsets, target)))
    bounds.append(corpus.num_docs)
    bounds = np.maximum.accumulate(np.asarray(bounds))
    return bounds


def host_device(mesh, device: torch.device) -> torch.device:
    """Where a collective on a small host value runs: the card for NCCL,
    the CPU for gloo."""
    return device if mesh.backend == "nccl" else torch.device("cpu")


class ShardedMixin:
    """One rank of a sharded scheme. Sets `full_corpus` (the whole corpus)
    before the sampler's `add_instances`; subclasses provide
    `_local_z`."""

    _capturable_step = False

    def __init__(self, config, logger=None, mesh=None):
        self.mesh = mesh if mesh is not None else make_mesh(
            config.mesh_shape or None, tuple(config.mesh_axis_names))
        super().__init__(config, logger=logger)
        # a clock-time seed (0 or -1) differs from rank to rank: take rank
        # 0's, so that the shared draws and the random-scan masks agree
        seed = torch.zeros(1, dtype=torch.int64,
                           device=host_device(self.mesh, self.device))
        if self.mesh.rank == 0:
            seed += config.effective_seed()
        self.config = dataclasses.replace(
            config, seed=int(psum(seed, self.mesh).item()))

    def _seed_generators(self):
        seed = self.config.effective_seed()
        self.shared_generator = torch.Generator(device=self.device)
        self.shared_generator.manual_seed(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(((seed * 1_000_003 + 104_729) * 1_000_003
                                    + self.mesh.rank) & 0x7FFF_FFFF_FFFF_FFFF)

    def _initial_z(self) -> torch.Tensor:
        z = torch.randint(0, self.config.topics,
                          (self.full_corpus.num_tokens,),
                          generator=self.shared_generator, device=self.device,
                          dtype=torch.int32)
        return torch.as_tensor(self._z_from_flat(z.cpu().numpy()),
                               device=self.device)

    def _merge_nkw(self, nkw, entry=None):
        if entry is None:
            return psum(nkw, self.mesh)
        # counts kept live from the replica `entry`: merge the moves
        return entry + psum(nkw - entry, self.mesh)

    def _should_stop(self, deadline) -> bool:
        stop = super()._should_stop(deadline)
        if self.mesh.group is None:
            return stop
        flag = torch.tensor([int(stop)],
                            device=host_device(self.mesh, self.device))
        return bool(psum(flag, self.mesh).item())

    # ------------------------------------------------------------------
    # accessors: every rank gets the whole corpus's, in canonical order
    # ------------------------------------------------------------------
    def _local_z(self):
        """This rank's tokens: (their corpus positions, int64 [n], or None
        where the ranks' tokens follow each other in rank order; their z,
        int32 [n])."""
        raise NotImplementedError

    def get_z_indicators(self) -> np.ndarray:
        pos, z = self._local_z()
        z = gather_rows(torch.as_tensor(z, device=self.device),
                        self.mesh).cpu().numpy()
        if pos is None:
            return z
        pos = gather_rows(torch.as_tensor(pos, device=self.device),
                          self.mesh).cpu().numpy()
        out = np.zeros(self.full_corpus.num_tokens, np.int32)
        out[pos] = z
        return out

    def _replicated(self) -> dict:
        """The state's tensors that every rank holds alike."""
        st = self.state
        return {"phi": st.phi, "nkw": st.nkw, "nk": st.nk,
                "alpha": st.alpha}

    def _paranoid_checks(self):
        """The single-device invariants on the merged counts (both sum to
        N, their marginals agree, no count is negative, phi rows
        normalised), an exact recount of the gathered z against N_kw and
        n_dk, and every replicated tensor bit-equal across the ranks. Each
        rank decides on the same gathered values, so all raise or none."""
        st, corpus = self.state, self.full_corpus
        it = st.iteration
        bad = replicated_mismatches(self._replicated(), self.mesh)
        if bad:
            raise AssertionError(f"paranoid: {bad} differ across the ranks "
                                 f"(iteration {it})")
        nkw = self.get_topic_type_counts().astype(np.int64)     # [K, V]
        ndk = self.get_document_topic_matrix().astype(np.int64)
        z = self.get_z_indicators()
        k, v, d = self.config.topics, corpus.num_types, corpus.num_docs
        checks = {
            "nkw_sum_ok": nkw.sum() == corpus.num_tokens,
            "ndk_rows_ok": np.array_equal(ndk.sum(axis=1),
                                          corpus.doc_lengths()),
            "marginals_match": np.array_equal(nkw.sum(axis=1),
                                              ndk.sum(axis=0)),
            "non_negative": (nkw >= 0).all() and (ndk >= 0).all(),
            "nkw_recount": np.array_equal(nkw.T.reshape(-1), np.bincount(
                corpus.tokens.astype(np.int64) * k + z, minlength=v * k)),
            "ndk_recount": np.array_equal(ndk.reshape(-1), np.bincount(
                corpus.token_doc_ids().astype(np.int64) * k + z,
                minlength=d * k)),
        }
        for name, ok in checks.items():
            if not ok:
                raise AssertionError(f"paranoid: invariant {name} violated "
                                     f"at iteration {it}")
        phi_sums = self._phi_kv().sum(dim=-1)
        if not bool(((phi_sums - 1.0).abs() < 1e-3).all()):
            raise AssertionError("paranoid: phi rows not normalised "
                                 "(ensureConsistentPhi)")

    # ------------------------------------------------------------------
    # single-device paths with no sharded counterpart
    # ------------------------------------------------------------------
    def _not_sharded(self, what: str):
        raise NotImplementedError(f"{what} is not available for the sharded "
                                  f"scheme {type(self).__name__}")

    def sample_z_given_phi(self, iterations: int = 100):
        self._not_sharded("sample_z_given_phi (fold-in)")

    def swap_corpus_tokens(self, corpus: Corpus):
        self._not_sharded("swap_corpus_tokens")

    def save_checkpoint(self, path: str):
        self._not_sharded("save_checkpoint")

    def load_checkpoint(self, path: str):
        self._not_sharded("load_checkpoint")


class DocShardedMixin(ShardedMixin):
    """Documents sharded in contiguous, token-balanced ranges: the rank's
    sampler runs on the sub-corpus of its documents (`self.corpus`), whose
    z, n_dk and GGS theta are rank-local."""

    def add_instances(self, corpus: Corpus):
        self.full_corpus = corpus
        bounds = partition_documents(corpus, self.mesh.size)
        self.doc_bounds = bounds
        d0, d1 = int(bounds[self.mesh.rank]), int(bounds[self.mesh.rank + 1])
        if d1 <= d0:
            raise ValueError(f"{self.mesh.size} ranks over {corpus.num_docs} "
                             f"documents leave rank {self.mesh.rank} none")
        self._docs = (d0, d1)
        self._tokens = (int(corpus.doc_offsets[d0]),
                        int(corpus.doc_offsets[d1]))
        return super().add_instances(corpus.subset(np.arange(d0, d1)))

    def _make_builders(self, corpus):
        super()._make_builders(self.full_corpus)

    def _doc_mask(self, mask):
        d0, d1 = self._docs
        return self._mask(mask[d0:d1])

    def _z_from_flat(self, z_flat):
        z_flat = np.asarray(z_flat, np.int32)
        if z_flat.shape != (self.full_corpus.num_tokens,):
            raise ValueError(f"z must hold one topic per token "
                             f"({self.full_corpus.num_tokens}), got "
                             f"{z_flat.shape}")
        t0, t1 = self._tokens
        return super()._z_from_flat(z_flat[t0:t1])

    def _local_z(self):
        return None, TorchLDASampler.get_z_indicators(self)

    def get_document_topic_matrix(self) -> np.ndarray:
        return gather_rows(self.state.ndk, self.mesh).cpu().numpy()

    def _theta_matrix(self) -> torch.Tensor:
        st = self.state
        if st.theta is not None:
            return gather_rows(st.theta, self.mesh)
        return super()._theta_matrix()

    def _local_theta(self) -> torch.Tensor:
        """The rank's documents' theta: the chain's draw, else the mean
        estimate (get_theta_estimate of its rows)."""
        st = self.state
        if st.theta is not None:
            return st.theta
        ndk = st.ndk.to(torch.float64)
        alpha = st.alpha.to(torch.float64)
        return (ndk + alpha) / (ndk.sum(dim=1, keepdim=True)
                                + alpha.sum()).clamp_min(1e-12)

    def _sum_docs(self, local: torch.Tensor) -> float:
        """A float64 sum over the ranks of their documents' terms."""
        t = local.to(torch.float64).reshape(1)
        return float(psum(t, self.mesh).item())

    def model_log_likelihood(self) -> float:
        st = self.state
        nkw = self._nkw_kv().to(torch.float32)
        alpha = st.alpha.to(torch.float32)
        keep = topics_kept(nkw, alpha)
        docs = doc_log_likelihood(st.ndk.to(torch.float32), alpha, keep)
        return self._sum_docs(docs) + float(topic_log_likelihood(
            nkw, st.beta, keep))

    def log_posterior(self) -> float:
        st = self.state
        docs = doc_log_posterior(st.ndk, self._local_theta(), st.alpha)
        return self._sum_docs(docs) + float(word_log_posterior(
            self._nkw_kv(), self._phi_kv(), st.beta, self.device))


def state_from_jax_z(model, z, alpha, beta):
    """Carry a JAX sharded chain's state across: its canonical z
    (`get_z_indicators`, numpy [N]) with its alpha and beta become the
    ranks' states of the port's sharded `model` (after `add_instances` on
    the same corpus). The merged N_kw, n_dk and n_k are then recounts of
    that z; phi is redrawn from them, identically on every rank."""
    st = model.state
    st.alpha = torch.as_tensor(np.asarray(alpha, np.float32),
                               device=model.device).reshape(-1).expand(
                                   model.config.topics).contiguous()
    st.beta = float(np.float32(beta))
    model.set_z_indicators(np.asarray(z, np.int32))
    return model
