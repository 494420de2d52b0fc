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

State paths, as on one device. A checkpoint is the JAX scheme's file
(z in canonical order; the whole corpus's n_dk and GGS theta as the JAX
scheme lays them out; N_kw and phi in its orientation): every rank
gathers, rank 0 writes, every rank reads and recounts its merged counts.
Fold-in merges the ranks' counts of a fold-in on the rank's own part
(`_fold_in_part`). A swap keeps z, phi, theta and both generators.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus
from ldagroupedgibbssampler_tpu_torch.evaluation.likelihood import (
    doc_log_likelihood, doc_log_posterior, topic_log_likelihood, topics_kept,
    word_log_posterior)
from ldagroupedgibbssampler_tpu_torch.models.base import TorchLDASampler, _np
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
        self.shared_generator = torch.Generator(device=self.device)
        self.generator = torch.Generator(device=self.device)
        self._reseed(self.config.effective_seed())

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
    # checkpoints, fold-in and swap: the single-device paths on every rank
    # ------------------------------------------------------------------
    # the orientation of N_kw and phi in the JAX scheme's checkpoint file
    # (its document-sharded schemes keep the reference's [K, V])
    _file_nkw_layout = "kv"

    def _docs_own(self, rows):
        """This rank's rows of per-document rows of the whole corpus (all
        of them where the ranks replicate the documents)."""
        return rows

    def _file_docs(self, rows: np.ndarray) -> np.ndarray:
        """The whole corpus's per-document rows [D, K] as the JAX scheme
        writes them."""
        return rows

    def _corpus_docs(self, rows: np.ndarray) -> np.ndarray:
        """[D, K] from a file's per-document rows: as they are, or the JAX
        document-sharded layout [S, Dp, K] of S shards of `Dp` rows each,
        unpacked by the shards' document ranges (any S)."""
        if rows.ndim != 3:
            return rows
        bounds = partition_documents(self.full_corpus, rows.shape[0])
        return np.concatenate([rows[s, : bounds[s + 1] - bounds[s]]
                               for s in range(rows.shape[0])])

    def _file_kv(self, t: torch.Tensor) -> np.ndarray:
        """A [K, V] tensor in the file's orientation."""
        return _np(t if self._file_nkw_layout == "kv" else t.T)

    def _checkpoint_arrays(self) -> dict:
        """The JAX scheme's file: z in canonical order, the whole corpus's
        n_dk (and GGS theta) laid out as the JAX scheme lays them out, and
        N_kw and phi in its orientation. Every rank takes part (gathers)."""
        st = self.state
        arrays = super()._checkpoint_arrays()
        arrays["ndk"] = self._file_docs(self.get_document_topic_matrix())
        arrays["nkw"] = self._file_kv(self._nkw_kv())
        arrays["phi"] = self._file_kv(self._phi_kv())
        if st.theta is not None:
            arrays["theta"] = self._file_docs(_np(self._docs_whole(st.theta)))
        return arrays

    def save_checkpoint(self, path: str):
        """Every rank gathers the state, rank 0 writes the file, then the
        ranks meet, so that any rank may read it at once."""
        arrays = self._checkpoint_arrays()
        if self.mesh.rank == 0:
            np.savez(path, **arrays)
        psum(torch.zeros(1, device=host_device(self.mesh, self.device)),
             self.mesh)

    def _arrays_from_file(self, arrays: dict) -> dict:
        """A file of this scheme (or of the JAX scheme, at any number of
        shards, or of a single-device scheme with the same orientation)
        as this rank's state_from_numpy takes it."""
        out = dict(arrays)
        for name in ("ndk", "theta"):
            rows = np.asarray(arrays[name])
            if rows.size:
                out[name] = self._docs_own(self._corpus_docs(rows))
        for name in ("nkw", "phi"):
            t = np.asarray(arrays[name])
            if self._file_nkw_layout != self.nkw_layout:
                t = t.T
            out[name] = np.ascontiguousarray(t)
        return out

    def _reseed(self, seed: int):
        """The shared generator from `seed`, the rank-local one from
        (`seed`, rank), as at the chain's start."""
        mask = 0x7FFF_FFFF_FFFF_FFFF
        self.shared_generator.manual_seed(seed & mask)
        self.generator.manual_seed(((seed * 1_000_003 + 104_729) * 1_000_003
                                    + self.mesh.rank) & mask)

    def _use_corpus(self, corpus: Corpus):
        """Lay out `corpus` (same documents, tokens and types) on this
        rank."""
        self.full_corpus = self.corpus = corpus
        self._prepare_device_data(corpus)

    def swap_corpus_tokens(self, corpus: Corpus):
        """The single-device swap on every rank: z carries over by
        canonical token index (gathered), the merged counts are rebuilt
        for the new tokens, and phi, theta and both generators' states are
        kept."""
        old = self.full_corpus
        if (corpus.num_docs, corpus.num_tokens, corpus.num_types) != (
                old.num_docs, old.num_tokens, old.num_types):
            raise ValueError("swap_corpus_tokens needs a corpus of the "
                             "same documents, tokens and types")
        z = self.get_z_indicators()
        st = self.state
        phi = st.phi
        theta = None if st.theta is None else self._docs_whole(st.theta)
        states = [(g, g.get_state())
                  for g in (self.generator, self.shared_generator)]
        self._use_corpus(corpus)
        self.set_z_indicators(z)
        st.phi = phi
        st.theta = None if theta is None else self._docs_own(theta)
        for g, state in states:
            g.set_state(state)
        return self


class DocShardedMixin(ShardedMixin):
    """Documents sharded in contiguous, token-balanced ranges: the rank's
    sampler runs on the sub-corpus of its documents (`self.corpus`), whose
    z, n_dk and GGS theta are rank-local."""

    def add_instances(self, corpus: Corpus):
        return super().add_instances(self._split(corpus))

    def _split(self, corpus: Corpus) -> Corpus:
        """Take `corpus` as the whole corpus; returns this rank's part."""
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
        return corpus.subset(np.arange(d0, d1))

    def _use_corpus(self, corpus: Corpus):
        self.corpus = self._split(corpus)
        self._prepare_device_data(self.corpus)

    def _docs_whole(self, rows):
        return gather_rows(rows, self.mesh)

    def _docs_own(self, rows):
        d0, d1 = self._docs
        return rows[d0:d1]

    def _file_docs(self, rows: np.ndarray) -> np.ndarray:
        """[S, Dp, K]: shard s's documents in its first rows, zeros after,
        Dp the largest shard's documents (the JAX schemes' layout)."""
        bounds = self.doc_bounds
        sizes = np.diff(bounds)
        out = np.zeros((len(sizes), int(sizes.max()), *rows.shape[1:]),
                       rows.dtype)
        for s, (d0, d1) in enumerate(zip(bounds[:-1], bounds[1:])):
            out[s, : d1 - d0] = rows[d0:d1]
        return out

    def _adopt_fold_in(self, res):
        # the rank folded in its own documents: z in its sub-corpus's order
        z = super(DocShardedMixin, self)._z_from_flat(res.flat_z())
        self._rebuild_counts(torch.as_tensor(z, device=self.device))

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
