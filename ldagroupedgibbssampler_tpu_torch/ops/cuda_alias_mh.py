"""The alias-MH z-step of scheme `ggs_aliasmh`: the CUDA kernels and their
plain versions.

Counterpart of the XLA program of the JAX package's
`ldagroupedgibbssampler_tpu/models/ggs_aliasmh.py::alias_mh_rounds` with
the table set-up and the z crossing of its `_step`. The kernels are
`csrc/alias_mh.cu` (its header gives the arithmetic, the Philox counters,
what bounds it on the H100 and the design), three launches an iteration:

  - `entry_topics`: the sweep-entry topics gathered from the layout-A
    slots into canonical and into type order, and a zeroed slot array for
    the new z;
  - `mh_rounds`: every round of every canonical token in one launch, the
    new z written to its slot;
  - `pack_tables` (packed mode): the [., 2] tables (phi, f32(N_kw) + beta)
    and (theta, f32(n_dk) + alpha_sum / K) in one pass.

The constants of a token that the corpus fixes (its document's and its
type's base, count and the count's reciprocal for the exact modulo) are
made once at set-up into a record a document and a record a type
(`count_table`).
`alias_mh` runs the first two, as `models/ggs_aliasmh.py::_step` calls
them on the card. The random words are Philox4x32-10 blocks keyed by
`seed`, an int64 [1] tensor on the device drawn from the chain's
generator, at counters that depend on (token, round, step) alone:
`philox_draws` makes the same eight arrays a round from them through
`ops/philox.py`, in `generator_draws`' order, and `alias_mh_reference`
runs `models/ggs_aliasmh.py::alias_mh_rounds` on them with the same f32
arithmetic, so the kernel can be held to it token for token. The port's
CPU chain keeps `generator_draws`: the two draw the same distribution,
other chains.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises: a failed build, a failed launch and an
operand the kernel does not take all raise. Nothing here syncs with the
host, so the step can be captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.ops import _build
from ldagroupedgibbssampler_tpu_torch.ops.philox import philox4x32_10

_MASK32 = 0xFFFFFFFF
_INV24 = 2.0 ** -24
_M64 = (1 << 64) - 1


def reciprocals(counts) -> np.ndarray:
    """floor((2^64 - 1) / max(count, 1)), uint64: the reciprocal of the
    kernel's exact modulo (`mod_exact`) for each bound."""
    m = np.maximum(np.asarray(counts, np.int64), 1).astype(np.uint64)
    return np.uint64(_M64) // m


def count_table(offsets) -> np.ndarray:
    """The records of the spans [offsets[i], offsets[i + 1]) (a document's
    canonical tokens, or a type's tokens in type order), int32 [n, 4]:
    base, count (at least 1: the bound of a position), and the count's
    reciprocal (`reciprocals`) as its low and high 32 bits."""
    off = np.asarray(offsets, np.int64)
    hi = np.maximum(np.diff(off), 1)
    inv = reciprocals(hi)
    out = np.stack([off[:-1], hi, (inv & np.uint64(_MASK32)).astype(np.int64),
                    (inv >> np.uint64(32)).astype(np.int64)], axis=1)
    return out.astype(np.uint32).view(np.int32).reshape(-1, 4)


@dataclasses.dataclass
class MHOperands:
    """The rounds' token operands, int32 on the device, made once at
    set-up from the corpus and its layout-A blocks."""
    slot_of_can: torch.Tensor     # [N] the slot of canonical token t
    slot_of_can_ty: torch.Tensor  # [N] the slot of the t-th token by type
    tok_w: torch.Tensor           # [N] its type
    tok_d: torch.Tensor           # [N] its document
    doc_tab: torch.Tensor         # [D, 4] count_table(document offsets)
    ty_tab: torch.Tensor          # [V, 4] count_table(type offsets in
                                  # type order)

    @classmethod
    def build(cls, tokens, doc_offsets, flat_index, num_types,
              device) -> "MHOperands":
        """From the corpus's tokens and doc_offsets and the layout-A
        blocks' flat_index (canonical token of each slot, -1 on pads)."""
        tokens = np.asarray(tokens, np.int64)
        n = tokens.shape[0]
        fi = np.asarray(flat_index).reshape(-1)
        if max(n, fi.shape[0]) > np.iinfo(np.int32).max:
            raise ValueError(f"{n} tokens in {fi.shape[0]} slots: the "
                             "alias-MH operands are int32")
        valid = fi >= 0
        slot_of_can = np.zeros(n, np.int64)
        slot_of_can[fi[valid]] = np.flatnonzero(valid)
        ty_cnt = np.bincount(tokens, minlength=num_types)
        doc_offsets = np.asarray(doc_offsets, np.int64)
        doc_ids = np.repeat(np.arange(doc_offsets.shape[0] - 1),
                            np.diff(doc_offsets))
        ty_off = np.concatenate([[0], np.cumsum(ty_cnt)])

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)
        return cls(dev(slot_of_can),
                   dev(slot_of_can[np.argsort(tokens, kind="stable")]),
                   dev(tokens), dev(doc_ids), dev(count_table(doc_offsets)),
                   dev(count_table(ty_off)))

    @property
    def num_tokens(self) -> int:
        return self.tok_w.shape[0]

    def _offsets(self, tab):
        end = torch.full((1,), self.num_tokens, dtype=tab.dtype,
                         device=tab.device)
        return torch.cat([tab[:, 0], end])

    @property
    def doc_off(self) -> torch.Tensor:
        """[D + 1] document offsets, from the records' bases."""
        return self._offsets(self.doc_tab)

    @property
    def ty_off(self) -> torch.Tensor:
        """[V + 1] type offsets in type order, from the records' bases."""
        return self._offsets(self.ty_tab)


def updatable_tokens(ops: MHOperands, doc_mask=None) -> torch.Tensor:
    """The tokens of the selected documents (all where doc_mask is None),
    an int64 0-d tensor: the denominator of the acceptance rates."""
    if doc_mask is None:
        return torch.tensor(ops.num_tokens, device=ops.tok_w.device)
    lengths = (ops.doc_off[1:] - ops.doc_off[:-1]).to(torch.int64)
    return (lengths * doc_mask.to(torch.int64)).sum()


def acceptance_rates(counts: torch.Tensor, updatable: torch.Tensor):
    """(acc_w, acc_d) f32 [rounds] from the kernel's int32 [rounds, 2]
    counts: count / max(#updatable, 1), as `alias_mh_rounds` divides."""
    den = updatable.to(torch.float32).clamp_min(1.0)
    rates = counts.to(torch.float32) / den
    return rates[:, 0], rates[:, 1]


def _unit24(word: torch.Tensor) -> torch.Tensor:
    """(word >> 8) 2^-24 of uint32 words held in int64: torch.rand's form,
    in [0, 1) and exact in f32."""
    return (word >> 8).to(torch.float32) * _INV24


def _bits62(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi 2^32 + lo) >> 2 of two uint32 words, in int64."""
    return (hi << 30) | (lo >> 2)


def philox_draws(seed, n, ty_hi, doc_hi, num_topics):
    """The `draws` hook of `alias_mh_rounds` from the kernel's Philox
    words: for round r, the word step's mixture uniform, in-type position,
    uniform topic and acceptance uniform, then the same four for the doc
    step, on ty_hi's device. Step s of round r reads the blocks at
    counters (j << 32) | t, j = 4 r + 2 s and j + 1, for token t: the
    first block's words give the mixture uniform, the position's 62 bits
    and the topic's first word, the second's the topic's second word and
    the acceptance uniform. Positions and topics are 62 bits modulo the
    bound (`generator_draws`' contract: exact integers, bias under
    2^-30)."""
    dev = ty_hi.device
    tok = torch.arange(n, dtype=torch.int64, device=dev)
    s = seed.reshape(1).to(device=dev, dtype=torch.int64)
    key = (s & _MASK32, (s >> 32) & _MASK32)

    def step(r, st, hi):
        j = 4 * r + 2 * st
        a = philox4x32_10(tok, torch.full_like(tok, j), *key)
        b = philox4x32_10(tok, torch.full_like(tok, j + 1), *key)
        return (_unit24(a[0]), _bits62(a[1], a[2]) % hi,
                _bits62(a[3], b[0]) % num_topics, _unit24(b[1]))

    def draws(r):
        return step(r, 0, ty_hi) + step(r, 1, doc_hi)
    return draws


# ---------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------
def entry_topics_reference(z_slot: torch.Tensor, ops: MHOperands):
    """(z_can, z_ty, zeroed slot array) of `entry_topics`."""
    return (z_slot[ops.slot_of_can.long()], z_slot[ops.slot_of_can_ty.long()],
            torch.zeros_like(z_slot))


def pack_reference(phi, nkw, theta, ndk, beta, au):
    """The packed tables as the JAX package's `_step` stacks them:
    (phi, f32(N_kw) + beta) and (theta, f32(n_dk) + au), f32 [V K, 2] and
    [D K, 2]."""
    f32 = torch.float32
    return (torch.stack([phi.reshape(-1), nkw.to(f32).reshape(-1) + beta],
                        dim=1),
            torch.stack([theta.reshape(-1), ndk.to(f32).reshape(-1) + au],
                        dim=1))


def rounds_reference(z_can, z_ty, z_out, ops, phi, nkw, theta, ndk, beta,
                     alpha_sum, au, seed, rounds, doc_mask=None, packed=None):
    """`mh_rounds`' plain version: `alias_mh_rounds` on `philox_draws`
    with the model's operands and arithmetic; writes the new z into the
    slots of z_out. Returns (z_out, (acc_w, acc_d) f32 [rounds])."""
    from ldagroupedgibbssampler_tpu_torch.models.ggs_aliasmh import (
        alias_mh_rounds)
    f32 = torch.float32
    k = phi.shape[1]
    w, d = ops.tok_w.long(), ops.tok_d.long()
    doc_off, ty_off = ops.doc_off.long(), ops.ty_off.long()
    doc_base, ty_base = doc_off[d], ty_off[w]
    doc_len, ty_cnt = doc_off[d + 1] - doc_base, ty_off[w + 1] - ty_base
    wk_i, dk_i = w * k, d * k
    if packed is not None:
        wk, dk = packed

        def gather_w(kk):
            r = wk[wk_i + kk]
            return r[:, 0], r[:, 1]

        def gather_d(kk):
            r = dk[dk_i + kk]
            return r[:, 0], r[:, 1]
    else:
        phi_f, nkw_f = phi.reshape(-1), nkw.reshape(-1)
        th_f, ndk_f = theta.reshape(-1), ndk.reshape(-1)

        def gather_w(kk):
            i = wk_i + kk
            return phi_f[i], nkw_f[i].to(f32) + beta

        def gather_d(kk):
            i = dk_i + kk
            return th_f[i], ndk_f[i].to(f32) + au
    upd_ok = (torch.ones(w.shape, dtype=torch.bool, device=w.device)
              if doc_mask is None else doc_mask[d])
    ld, cw = doc_len.to(f32), ty_cnt.to(f32)
    z_new, rates = alias_mh_rounds(
        z_can, gather_w, gather_d, upd_ok, cw / (cw + k * beta),
        ld / (ld + alpha_sum), lambda pos: z_can[doc_base + pos],
        lambda pos: z_ty[ty_base + pos], doc_len, ty_cnt, k, rounds,
        draws=philox_draws(seed, w.shape[0], ty_cnt.clamp_min(1),
                           doc_len.clamp_min(1), k))
    z_out[ops.slot_of_can.long()] = z_new
    return z_out, rates


def alias_mh_reference(z_slot, ops, phi, nkw, theta, ndk, beta, alpha_sum,
                       au, seed, rounds, doc_mask=None, packed=False):
    """The plain version of the whole z-step: the pre-pass, the rounds on
    the Philox draws (packed tables from `pack_reference` when `packed`)
    and the write-back to the slots. Returns (z int32 [slots], (acc_w,
    acc_d) f32 [rounds])."""
    z_can, z_ty, z_out = entry_topics_reference(z_slot, ops)
    tables = (pack_reference(phi, nkw, theta, ndk, beta, au) if packed
              else None)
    return rounds_reference(z_can, z_ty, z_out, ops, phi, nkw, theta, ndk,
                            beta, alpha_sum, au, seed, rounds, doc_mask,
                            tables)


# ---------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------
def _check_ops(ops: MHOperands, dev):
    n = ops.num_tokens
    for name in ("slot_of_can", "slot_of_can_ty", "tok_w", "tok_d"):
        _build.check_tensor(name, getattr(ops, name), (n,), torch.int32, dev)
    for name in ("doc_tab", "ty_tab"):
        t = getattr(ops, name)
        _build.check_tensor(name, t, (t.shape[0], 4), torch.int32, dev)


def entry_topics(z_slot: torch.Tensor, ops: MHOperands):
    """The sweep-entry topics in canonical order and in type order (int32
    [N] each), and an int32 slot array of z_slot's shape, zeroed, for the
    new z."""
    if z_slot.device.type == "cpu":
        return entry_topics_reference(z_slot, ops)
    lib = _build.library()
    dev = z_slot.device
    _build.check_tensor("z_slot", z_slot, z_slot.shape, torch.int32, dev)
    _check_ops(ops, dev)
    n = ops.num_tokens
    z_can = torch.empty(n, dtype=torch.int32, device=dev)
    z_ty = torch.empty(n, dtype=torch.int32, device=dev)
    z_out = torch.empty_like(z_slot)
    err = lib.lda_alias_mh_entry(
        z_slot.data_ptr(), ops.slot_of_can.data_ptr(),
        ops.slot_of_can_ty.data_ptr(), z_can.data_ptr(), z_ty.data_ptr(),
        z_out.data_ptr(), n, z_slot.numel(), dev.index, _build.stream(dev))
    _build.check(err, "lda_alias_mh_entry")
    entry_topics.launches += 1
    return z_can, z_ty, z_out


def mh_rounds(z_can, z_ty, z_out, ops, phi, nkw, theta, ndk, beta: float,
              alpha_sum, au, seed, rounds: int, *, doc_mask=None,
              packed=None, acc_counts=None):
    """`rounds` word/doc MH step pairs over the canonical tokens from the
    entry topics z_can / z_ty, the new z written into the slots of z_out
    (`entry_topics`' arrays). phi f32 [V, K], nkw int32 [V, K], theta f32
    [D, K], ndk int32 [D, K]; beta the state's float; alpha_sum and au =
    alpha_sum / K 0-d f32 tensors; seed int64 [1]; doc_mask bool [D] or
    None; packed: None (the tables read directly) or `pack_tables`' pair.
    acc_counts (the card only): int32 [rounds, 2], zeroed, into which each
    step's accepted tokens are added (`rounds_reference` gives the plain
    version's rates). Returns z_out."""
    if z_can.device.type == "cpu":
        if acc_counts is not None:
            raise ValueError("acc_counts is the kernel's: the plain version "
                             "returns rates (rounds_reference)")
        return rounds_reference(z_can, z_ty, z_out, ops, phi, nkw, theta,
                                ndk, beta, alpha_sum, au, seed, rounds,
                                doc_mask, packed)[0]
    lib = _build.library()
    dev = z_can.device
    n, k = ops.num_tokens, phi.shape[1]
    v, d = phi.shape[0], theta.shape[0]
    _check_ops(ops, dev)
    for name, t in (("z_can", z_can), ("z_ty", z_ty)):
        _build.check_tensor(name, t, (n,), torch.int32, dev)
    _build.check_tensor("z_out", z_out, z_out.shape, torch.int32, dev)
    if packed is None:
        _build.check_tensor("phi", phi, (v, k), torch.float32, dev)
        _build.check_tensor("nkw", nkw, (v, k), torch.int32, dev)
        _build.check_tensor("theta", theta, (d, k), torch.float32, dev)
        _build.check_tensor("ndk", ndk, (d, k), torch.int32, dev)
        tables = (phi.data_ptr(), nkw.data_ptr(), theta.data_ptr(),
                  ndk.data_ptr(), None, None)
    else:
        wk, dk = packed
        _build.check_tensor("wk_pack", wk, (v * k, 2), torch.float32, dev)
        _build.check_tensor("dk_pack", dk, (d * k, 2), torch.float32, dev)
        tables = (None, None, None, None, wk.data_ptr(), dk.data_ptr())
    if ops.doc_tab.shape[0] != d or ops.ty_tab.shape[0] != v:
        raise ValueError(f"operands of {ops.doc_tab.shape[0]} documents "
                         f"and {ops.ty_tab.shape[0]} types against "
                         f"tables of {d} and {v}")
    for name, t in (("alpha_sum", alpha_sum), ("au", au)):
        _build.check_tensor(name, t, (), torch.float32, dev)
    _build.check_tensor("seed", seed, (1,), torch.int64, dev)
    if doc_mask is not None:
        _build.check_tensor("doc_mask", doc_mask, (d,), torch.bool, dev)
    if acc_counts is not None:
        _build.check_tensor("acc_counts", acc_counts, (rounds, 2),
                            torch.int32, dev)
    kbeta = float(np.float32(k * beta))     # `cw + K * beta`'s f32 scalar
    err = lib.lda_alias_mh_rounds(
        z_can.data_ptr(), z_ty.data_ptr(), ops.slot_of_can.data_ptr(),
        ops.tok_w.data_ptr(), ops.tok_d.data_ptr(), ops.doc_tab.data_ptr(),
        ops.ty_tab.data_ptr(), *tables,
        None if doc_mask is None else doc_mask.data_ptr(),
        alpha_sum.data_ptr(), au.data_ptr(), beta, kbeta, seed.data_ptr(),
        z_out.data_ptr(),
        None if acc_counts is None else acc_counts.data_ptr(), n, k, rounds,
        int(packed is not None), dev.index, _build.stream(dev))
    _build.check(err, "lda_alias_mh_rounds")
    mh_rounds.launches += 1
    return z_out


def pack_tables(phi, nkw, theta, ndk, beta: float, au):
    """The packed tables (phi, f32(N_kw) + beta) f32 [V K, 2] and (theta,
    f32(n_dk) + au) f32 [D K, 2], one launch for both; au a 0-d f32
    tensor."""
    if phi.device.type == "cpu":
        return pack_reference(phi, nkw, theta, ndk, beta, au)
    lib = _build.library()
    dev = phi.device
    (v, k), d = phi.shape, theta.shape[0]
    _build.check_tensor("phi", phi, (v, k), torch.float32, dev)
    _build.check_tensor("nkw", nkw, (v, k), torch.int32, dev)
    _build.check_tensor("theta", theta, (d, k), torch.float32, dev)
    _build.check_tensor("ndk", ndk, (d, k), torch.int32, dev)
    _build.check_tensor("au", au, (), torch.float32, dev)
    wk = torch.empty((v * k, 2), dtype=torch.float32, device=dev)
    dk = torch.empty((d * k, 2), dtype=torch.float32, device=dev)
    err = lib.lda_alias_mh_pack(
        phi.data_ptr(), nkw.data_ptr(), beta, wk.data_ptr(), v * k,
        theta.data_ptr(), ndk.data_ptr(), au.data_ptr(), dk.data_ptr(),
        d * k, dev.index, _build.stream(dev))
    _build.check(err, "lda_alias_mh_pack")
    pack_tables.launches += 1
    return wk, dk


def alias_mh(z_slot, ops, phi, nkw, theta, ndk, beta: float, alpha_sum, au,
             seed, rounds: int, *, doc_mask=None, packed=None,
             acc_counts=None):
    """The z-step: `entry_topics`, then `mh_rounds` (arguments as there).
    Returns the new z, int32 of z_slot's shape with padding slots 0."""
    z_can, z_ty, z_out = entry_topics(z_slot, ops)
    return mh_rounds(z_can, z_ty, z_out, ops, phi, nkw, theta, ndk, beta,
                     alpha_sum, au, seed, rounds, doc_mask=doc_mask,
                     packed=packed, acc_counts=acc_counts)


# launches of the kernels (added where they launch, nowhere else);
# chip_smoke.py reads them to show that the main path ran the kernels
entry_topics.launches = 0
mh_rounds.launches = 0
pack_tables.launches = 0
