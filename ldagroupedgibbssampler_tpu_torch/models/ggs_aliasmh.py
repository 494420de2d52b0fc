"""GGS-AliasMH, scheme `ggs_aliasmh`: the grouped sampler with an
O(1)-per-token Metropolis-Hastings z-step, on PyTorch + CUDA.

The port of `ldagroupedgibbssampler_tpu/models/ggs_aliasmh.py`. It
replaces GGS's exact K-wide inverse-CDF z-draw with LightLDA-style MH
rounds whose cost per token does not grow with K:

  target (the GGS conditional given this sweep's theta and phi):
      p_t(k) ∝ theta[d_t, k] * phi[k, w_t]
  word step: propose the sweep-entry topic of a uniform token of type
      w_t with probability n_w / (n_w + K beta), else a uniform topic,
      i.e. q_w(k) = (N_kw^entry + beta) / (n_w + K beta)
      (LightPCLDAtypeTopicProposal.java:23-53);
  doc step: propose the sweep-entry topic of a uniform token of document
      d_t with probability L_d / (L_d + alpha_sum), else a uniform topic,
      i.e. q_d(k) = (n_dk^entry + alpha_sum / K) / (L_d + alpha_sum). The
      fallback is uniform over K, so its mass per topic is alpha_sum / K
      for ANY alpha vector; using alpha_k there would de-target the chain
      under an asymmetric alpha (tests/test_geweke.py's asymmetric-alpha
      test and its negative control guard this);
  accept with min(1, p(k*) q(z) / (p(z) q(k*))).

Given theta and phi the tokens of the grouped sampler are conditionally
independent, so every token's chain runs in parallel over the canonical
(document-major, unpadded) token axis. Only z crosses between the
canonical axis and GGS's layout-A slots, by one gather each way. On the
card the step is the hand-written kernels of `ops/cuda_alias_mh.py`
(csrc/alias_mh.cu), where the JAX package has XLA fuse it: the entry
topics' gathers, every round in one launch writing the new z to its slot,
and in packed mode the tables in one pass; their random words come from an
in-kernel Philox keyed by one int64 from the chain's generator. On the CPU
the rounds are the bulk PyTorch of `alias_mh_rounds` below, drawn by
`generator_draws`: the same distribution, other chains. After the rounds,
N_kw and n_dk are rebuilt from z by the count kernel (`ops/cuda_counts.py`,
csrc/label_counts.cu) on layouts A and B at every K, then phi is drawn.
Each sweep is [theta | n_d] exact, [z | theta, phi] MH rounds that leave
p(z | theta, phi, w) invariant, [phi | z] exact.

Quality, from the JAX package's runs: the MH z-step mixes less per sweep
than the exact draw; at K=4096 dense GGS is better held-out at matched
iterations (LARGEK_QUALITY.json). The speed findings of the JAX package
are about its chip and do not carry over; PERF.md has the card's.
"""

from __future__ import annotations

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.models.ggs import LDAGroupedGibbsSampler
from ldagroupedgibbssampler_tpu_torch.ops import cuda_alias_mh
from ldagroupedgibbssampler_tpu_torch.ops.random import kernel_seed

_TINY = 1e-38

# "auto" packing budget: the extra device bytes the packed [., 2] f32
# tables may take (8 * (V*K + D*K)) before the scheme gathers straight from
# the state tensors instead (no extra memory, one more gather a density)
_ALIASMH_PACK_BYTES = 4 << 30


def generator_draws(generator, n, ty_hi, doc_hi, num_topics):
    """The `draws` hook of `alias_mh_rounds` from a torch.Generator: for
    each round, the word step's mixture uniform, in-type position, uniform
    topic and acceptance uniform, then the same four for the doc step, all
    on the generator's device. The positions are exact integer draws with
    per-token bounds: 62 random bits modulo the bound (bias under 2^-30 for
    any bound below 2^32), never a scaled f32 uniform, which cannot reach
    every position once a type holds more than 2^24 tokens."""
    dev = ty_hi.device

    def uniform():
        return torch.rand(n, generator=generator, device=dev)

    def position(hi):
        bits = torch.randint(0, 2 ** 62, (n,), generator=generator,
                             device=dev, dtype=torch.int64)
        return bits % hi

    def topic():
        return torch.randint(0, num_topics, (n,), generator=generator,
                             device=dev, dtype=torch.int64)

    def draws(_round):
        return (uniform(), position(ty_hi), topic(), uniform(),
                uniform(), position(doc_hi), topic(), uniform())
    return draws


def alias_mh_rounds(z, gather_w, gather_d, upd_ok, p_tok_w, p_tok_d,
                    pick_doc, pick_ty, doc_len_tok, ty_cnt_tok, num_topics,
                    rounds, *, generator=None, draws=None):
    """`rounds` alternating word/doc MH rounds over all tokens at once.

    The operands are the JAX function's; its key becomes `draws` (or a
    `generator` to make them from):
    z: int [S] current assignments over the token axis.
    gather_w(k) -> (phi[k, w_t], qw(k)) and gather_d(k) -> (theta[d_t, k],
        qd(k)): per-token densities at topic k (int64 [S]), with qw(k) =
        N_kw^entry + beta and qd(k) = n_dk^entry + alpha_sum / K (the
        unnormalised proposal densities; per-token normalisers cancel).
    upd_ok: bool [S]; tokens of documents random scan did not select keep z.
    p_tok_w / p_tok_d: f32 [S] mixture probabilities n_w / (n_w + K beta)
        and L_d / (L_d + alpha_sum).
    pick_doc(pos) / pick_ty(pos): the SWEEP-ENTRY topic of the token at an
        in-document / in-type position.
    doc_len_tok / ty_cnt_tok: int64 [S] the token's document length and
        type count (the positions' bounds).
    draws(r) -> the eight arrays of round r, in `generator_draws`' order;
        default: `generator_draws(generator, ...)`.
    Returns (z' int32 [S], (acc_w, acc_d) f32 [rounds] acceptance rates
    among the updatable tokens).
    """
    n = z.shape[0]
    ty_hi = ty_cnt_tok.clamp_min(1)
    doc_hi = doc_len_tok.clamp_min(1)
    if draws is None:
        draws = generator_draws(generator, n, ty_hi, doc_hi, num_topics)
    # current-point target and proposal densities, carried across steps so
    # only the proposed point costs gathers
    zz = z.to(torch.int64)
    ph0, qw_c = gather_w(zz)
    th0, qd_c = gather_d(zz)
    t_c = th0 * ph0
    den = upd_ok.sum().to(torch.float32).clamp_min(1.0)
    acc_w, acc_d = [], []
    for r in range(rounds):
        u_mix, pos, k_unif, u_acc, u_mix2, pos2, k_unif2, u_acc2 = draws(r)
        # ---- word step
        kprop = torch.where(u_mix < p_tok_w, pick_ty(pos).to(torch.int64),
                            k_unif.to(torch.int64))
        phn, q_new = gather_w(kprop)
        thn, qdn = gather_d(kprop)
        t_new = thn * phn
        acc = upd_ok & ((u_acc * (t_c * q_new).clamp_min(_TINY))
                        < t_new * qw_c)
        zz = torch.where(acc, kprop, zz)
        t_c = torch.where(acc, t_new, t_c)
        qw_c = torch.where(acc, q_new, qw_c)
        qd_c = torch.where(acc, qdn, qd_c)
        # ---- doc step
        kprop2 = torch.where(u_mix2 < p_tok_d,
                             pick_doc(pos2).to(torch.int64),
                             k_unif2.to(torch.int64))
        phn2, qwn2 = gather_w(kprop2)
        thn2, q2_new = gather_d(kprop2)
        t_new2 = thn2 * phn2
        acc2 = upd_ok & ((u_acc2 * (t_c * q2_new).clamp_min(_TINY))
                         < t_new2 * qd_c)
        zz = torch.where(acc2, kprop2, zz)
        t_c = torch.where(acc2, t_new2, t_c)
        qd_c = torch.where(acc2, q2_new, qd_c)
        qw_c = torch.where(acc2, qwn2, qw_c)
        acc_w.append(acc.sum().to(torch.float32) / den)
        acc_d.append(acc2.sum().to(torch.float32) / den)
    return zz.to(torch.int32), (torch.stack(acc_w), torch.stack(acc_d))


class LDAGroupedGibbsSamplerAliasMH(LDAGroupedGibbsSampler):
    """GGS with the O(1)-per-token alias-MH z-step (module docstring)."""

    _use_fused_zdraw = False

    def _mh_packed(self) -> bool:
        mode = self.config.aliasmh_packed
        if mode in ("packed", "unpacked"):
            return mode == "packed"
        extra = 8 * self.config.topics * (self.corpus.num_types
                                          + self.corpus.num_docs)
        return extra <= _ALIASMH_PACK_BYTES

    def _prepare_device_data(self, corpus):
        super()._prepare_device_data(corpus)
        if self.device.type != "cpu":
            # the kernels' int32 token operands, made once
            self._mh_ops = cuda_alias_mh.MHOperands.build(
                corpus.tokens, corpus.doc_offsets, self._blocks.flat_index,
                corpus.num_types, self.device)
            return
        tokens = corpus.tokens
        n = corpus.num_tokens

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int64),
                                   device=self.device)
        # the rounds run over the canonical (document-major, unpadded)
        # token axis; only z crosses to the layout-A slots and back
        fi = self._blocks.flat_index.reshape(-1)
        valid = fi >= 0
        inv = np.zeros(n, np.int64)
        inv[fi[valid]] = np.flatnonzero(valid)
        self._mh_slot_of_can = dev(inv)
        self._mh_can_of_slot = dev(np.maximum(fi, 0))
        lengths = np.diff(corpus.doc_offsets)
        ty_cnt = np.bincount(tokens, minlength=corpus.num_types)
        ty_off = np.concatenate([[0], np.cumsum(ty_cnt)[:-1]])
        doc_ids = corpus.token_doc_ids()
        self._mh_ty_perm = dev(np.argsort(tokens, kind="stable"))
        self._mh_w = dev(tokens)
        self._mh_d = dev(doc_ids)
        self._mh_doc_base = dev(corpus.doc_offsets[:-1][doc_ids])
        self._mh_ty_base = dev(ty_off[tokens])
        self._mh_doc_len = dev(lengths[doc_ids])
        self._mh_ty_cnt = dev(ty_cnt[tokens])

    def _step(self, state, doc_mask, type_mask=None):
        """One iteration, replacing the fields of `state` in place."""
        K = self.config.topics
        # (1) theta, as in ggs
        theta = self._theta_update(state, doc_mask)
        # (2) the MH rounds over the canonical tokens. The doc proposal's
        # density is n_dk + alpha_sum / K (the uniform fallback's true mass
        # per topic for any alpha vector).
        a_sum = state.alpha.sum()
        au = a_sum / K
        if self.device.type != "cpu":
            z = self._kernel_z_step(state, theta, doc_mask, a_sum, au)
        else:
            z = self._eager_z_step(state, theta, doc_mask, a_sum, au)
        # (3) both count tables from z through the count kernel
        nkw = self._count_nkw(z)
        ndk = self._count_ndk(z)
        # (4) phi
        phi = self._sample_phi(nkw, state.beta, type_mask, state.phi)
        state.z, state.ndk, state.nkw, state.phi, state.theta = (
            z, ndk, nkw, phi, theta)
        state.nk = nkw.sum(dim=0, dtype=torch.int32)
        state.iteration += 1

    def _kernel_z_step(self, state, theta, doc_mask, a_sum, au):
        """The MH rounds on the card: the entry topics' gathers and every
        round in one launch each, after the packed tables' one pass in
        packed mode; the new z on the layout-A slots."""
        packed = (cuda_alias_mh.pack_tables(state.phi, state.nkw, theta,
                                            state.ndk, state.beta, au)
                  if self._mh_packed() else None)
        return cuda_alias_mh.alias_mh(
            state.z, self._mh_ops, state.phi, state.nkw, theta, state.ndk,
            state.beta, a_sum, au, kernel_seed(self.generator, self.device),
            max(1, self.config.aliasmh_rounds), doc_mask=doc_mask,
            packed=packed)

    def _eager_z_step(self, state, theta, doc_mask, a_sum, au):
        """The MH rounds of `alias_mh_rounds` with the generator's draws
        (the CPU's path); the new z on the layout-A slots."""
        cfg = self.config
        K = cfg.topics
        f32 = torch.float32
        wK = self._mh_w * K
        dK = self._mh_d * K
        if self._mh_packed():
            # packed [., 2] f32 rows: one 8-byte gather a density
            wk_pack, dk_pack = cuda_alias_mh.pack_reference(
                state.phi, state.nkw, theta, state.ndk, state.beta, au)

            def gather_w(k):
                r = wk_pack[wK + k]
                return r[:, 0], r[:, 1]

            def gather_d(k):
                r = dk_pack[dK + k]
                return r[:, 0], r[:, 1]
        else:
            # unpacked: straight from the state tensors, counts cast after
            # the gather (the same f32 values, no extra memory)
            phi_f, nkw_f = state.phi.reshape(-1), state.nkw.reshape(-1)
            th_f, ndk_f = theta.reshape(-1), state.ndk.reshape(-1)

            def gather_w(k):
                i = wK + k
                return phi_f[i], nkw_f[i].to(f32) + state.beta

            def gather_d(k):
                i = dK + k
                return th_f[i], ndk_f[i].to(f32) + au
        upd_ok = (torch.ones(self._mh_w.shape, dtype=torch.bool,
                             device=self.device)
                  if doc_mask is None else doc_mask[self._mh_d])
        ld = self._mh_doc_len.to(f32)
        cw = self._mh_ty_cnt.to(f32)
        z_entry = state.z[self._mh_slot_of_can]
        # the sweep-entry topics in type order: one gather a pick
        z_entry_ty = z_entry[self._mh_ty_perm]
        z_can, _accs = alias_mh_rounds(
            z_entry, gather_w, gather_d, upd_ok, cw / (cw + K * state.beta),
            ld / (ld + a_sum),
            lambda pos: z_entry[self._mh_doc_base + pos],
            lambda pos: z_entry_ty[self._mh_ty_base + pos],
            self._mh_doc_len, self._mh_ty_cnt, K,
            max(1, cfg.aliasmh_rounds), generator=self.generator)
        return torch.where(self.mf, z_can[self._mh_can_of_slot], 0)
