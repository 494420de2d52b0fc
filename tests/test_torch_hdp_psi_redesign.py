"""The HDP step's psi kernel as csrc/hdp.cu now launches it, and the step's
one seed launch, on the CPU.

`models/hdp.py::_kernel_after_sweep` draws the three kernel keys of a step
in one `torch.randint` of shape [3] (`ops/random.py::kernel_seeds`) and
passes the views [0:1], [1:2] and [2:3] to the table counts, psi and the
Polya-Urn rows; psi is a programmatic dependent launch of the table
counts' second (`dependent=True`). On the CPU the wrappers run their
plain versions, so the chain through the kernels' path (the `kernel_path`
fixture of tests/test_torch_hdp_kernel.py) shows the keys each gets and
the HDP invariants.

The kernel: a cluster of up to 8 blocks, each a slice of ceil(K / S)
topics, the least power of two of threads from 128 to 1024 giving two a
topic (`cuda_hdp.psi_launch_shape`); its births read only nk, the active
mask and the seed, before `wait_for_prerequisite`, and write nothing to
device memory there. hlda's births are found as the index past the
take-th slot not in the data, from block scans of the free slots up to the
slice's end; `lowest_births_emulation` repeats that chunk by chunk and is
held to `psi_reference`'s ranks. Exact throughout (births are integers)."""

import os
import re

import numpy as np
import pytest
import torch

from test_torch_hdp_kernel import corpus, kernel_path  # noqa: F401
from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
from ldagroupedgibbssampler_tpu_torch.models import hdp
from ldagroupedgibbssampler_tpu_torch.models.registry import create_model
from ldagroupedgibbssampler_tpu_torch.ops import cuda_hdp
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "ldagroupedgibbssampler_tpu_torch", "csrc")


def _chain(scheme, **kw):
    cfg = LDAConfig(scheme=scheme, topics=10, alpha=1.0, beta=0.01, seed=3,
                    exec_time=-1, topic_interval=20, device="cpu",
                    hdp_start_topics=1, hdp_gamma=1.0, **kw)
    return cfg


def _source(name):
    with open(os.path.join(CSRC, name), encoding="utf-8") as f:
        return f.read()


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("scheme", ["ppu_hdplda", "ppu_hlda"])
def test_a_step_draws_its_three_keys_in_one_randint(corpus, kernel_path,
                                                    monkeypatch, scheme):
    """One `torch.randint` a step after the sweep, of shape [3], from the
    chain's generator: the table counts get key 0, psi key 1 (as the
    dependent of the table counts) and the Polya-Urn rows key 2, each an
    int64 [1] view; psi's output equals psi_reference on key 1."""
    model = create_model(_chain(scheme)).add_instances(corpus)
    model.sample(2)
    draws, tables, psis, urns = [], [], [], []
    real_randint = torch.randint

    def randint(*args, **kw):
        out = real_randint(*args, **kw)
        draws.append(tuple(out.shape))
        return out
    _spy(monkeypatch, hdp.cuda_hdp, "table_counts", tables)
    _spy(monkeypatch, hdp.cuda_hdp, "psi_step", psis)
    _spy(monkeypatch, hdp.cuda_polya_urn, "polya_urn", urns)
    expected = torch.Generator().set_state(model.generator.get_state())
    keys = real_randint(0, 2 ** 62, (3,), generator=expected,
                        dtype=torch.int64)
    monkeypatch.setattr(torch, "randint", randint)
    st = model.state
    model._kernel_after_sweep(st, st.ndk, st.nkw, st.nk)
    assert draws == [(3,)]
    got = [tables[0][0][3], psis[0][0][3], urns[0][0][2]]
    for i, key in enumerate(got):
        assert key.shape == (1,) and key.dtype == torch.int64
        assert key.is_contiguous() and int(key) == int(keys[i])
    assert psis[0][1]["dependent"] is True
    args, kw, out = psis[0]
    kw = {k: v for k, v in kw.items() if k != "dependent"}
    want = cuda_hdp.psi_reference(*args, **kw)
    for a, b in zip(out, want):
        assert torch.equal(a, b)


def test_kernel_seeds_is_kernel_seed_n_at_a_time():
    """kernel_seeds(n) draws n keys in one randint: the same words as n
    draws of kernel_seed in a row would not be (the generator's stream is
    consumed once), but the same as one randint of [n]; kernel_seed is
    kernel_seeds of 1."""
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(5)
    g2.manual_seed(5)
    three = rnd.kernel_seeds(g1, torch.device("cpu"), 3)
    assert three.shape == (3,) and three.dtype == torch.int64
    assert torch.equal(three, torch.randint(0, 2 ** 62, (3,), generator=g2,
                                            dtype=torch.int64))
    g1.manual_seed(6)
    g2.manual_seed(6)
    assert torch.equal(rnd.kernel_seed(g1, torch.device("cpu")),
                       rnd.kernel_seeds(g2, torch.device("cpu"), 1))


@pytest.mark.parametrize("scheme,kw", [
    ("ppu_hdplda", dict(hdp_psi_sampler="poisson")),
    ("ppu_hdplda", dict(hdp_gamma_dist="uniform"))])
def test_kernel_path_keeps_the_hdp_invariants_with_one_seed_launch(
        corpus, kernel_path, scheme, kw):
    """15 iterations through the kernels' path with the Poisson psi and
    with the uniform index prior: every step took it; inactive topics have
    alpha 0, zero phi rows and no token; psi sums to 1; topics were
    born."""
    model = create_model(_chain(scheme, **kw)).add_instances(corpus)
    model.sample(15)
    assert len(kernel_path) == 15
    active = model.get_active_mask()
    assert (model.get_alpha()[~active] == 0).all()
    assert (model.get_phi()[~active] == 0).all()
    assert (model.get_tokens_per_topic()[~active] == 0).all()
    assert float(model.get_psi().sum()) == pytest.approx(1.0, abs=1e-5)
    assert max(model.get_active_topic_history()) >= 2


@pytest.mark.parametrize("k", [1, 37, 64, 65, 100, 128, 129, 300, 512, 513,
                               700, 1000, 1024, 4096, 4097, 5000, 65_536,
                               (1 << 20) - 1])
def test_psi_launch_shape_covers_every_topic_once(k):
    """The slices of the cluster's blocks cover [0, K) in rank order, each
    topic once; at most 8 blocks, one below 513 topics; threads a power of
    two in [128, 1024], two a topic of the slice where 1024 allow it."""
    shape = cuda_hdp.psi_launch_shape(k)
    blocks, threads, slices = (shape["blocks"], shape["threads"],
                               shape["slices"])
    assert len(slices) == blocks and 1 <= blocks <= 8
    assert blocks == 1 if k <= 512 else blocks > 1
    seen = np.zeros(k, np.int64)
    for b0, b1 in slices:
        seen[b0:b1] += 1
    assert (seen == 1).all()
    assert [b0 for b0, _ in slices] == sorted(b0 for b0, _ in slices)
    assert threads in (128, 256, 512, 1024)
    per = max(b1 - b0 for b0, b1 in slices)
    assert threads >= min(2 * per, 1024)
    assert threads == 128 or threads < 2 * 2 * per
    if k <= 4096:
        assert per <= 512 and threads >= 2 * per


def test_psi_launch_constants_are_the_sources():
    """The Python geometry is csrc/hdp.cu's psi_shape."""
    text = _source("hdp.cu")
    const = dict((n, int(v)) for n, v in re.findall(
        r"constexpr int (kPsiMinThreads|kPsiMaxThreads|kPsiSlice|"
        r"kPsiMaxBlocks) = (\d+);", text))
    assert const == {"kPsiMinThreads": cuda_hdp.PSI_MIN_THREADS,
                     "kPsiMaxThreads": cuda_hdp.PSI_MAX_THREADS,
                     "kPsiSlice": cuda_hdp.PSI_SLICE,
                     "kPsiMaxBlocks": cuda_hdp.PSI_MAX_BLOCKS}
    for t in (128, 256, 512):
        assert f"case {t}:" in text and f"launch_psi<{t}>" in text


def test_psi_is_a_dependent_launch_with_its_births_before_the_wait():
    """csrc/hdp.cu: tables_kernel allows its dependents before it waits;
    psi launches through launch_ex with `dependent` (the attribute of
    launch_dependent) and, in its kernel, draws n_add and the candidates
    and scans hlda's free slots before wait_for_prerequisite, writing
    nothing to device memory (g.<field>[...] =) there and reading no table
    count."""
    text = _source("hdp.cu")
    tables = text[text.index("tables_kernel(int*"):
                  text.index("// elementwise Binomial(n, p)")]
    assert tables.index("allow_dependent_launch();") < tables.index(
        "wait_for_prerequisite();")
    body = text[text.index("psi_kernel(PsiArgs g) {"):
                text.index("// The psi launch's geometry at K")]
    before, after = body.split("wait_for_prerequisite();", 1)
    assert "poisson_draw(key, 1, g.gamma)" in before
    assert "draw_block(key, 2 + c, 0)" in before
    assert "block_exclusive_scan<kT>(free" in before
    assert not re.search(r"\bg\.\w+\[[^\]]*\]\s*=[^=]", before)
    assert "g.tables" not in before
    assert "g.tables" in after and "g.births[k] = born" in after
    launch = text[text.index("cudaError_t launch_psi("):]
    assert "launch_ex(psi_kernel<kT>" in launch
    helper = _source("dependent_launch.cuh")
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in helper
    assert re.search(r"return launch_ex\(kernel, blocks, threads, 1, 0, "
                     r"true, stream", helper)


def lowest_births_emulation(free, take, b1, threads):
    """hlda's births of the slice [.., b1) as the kernel finds them: the
    free slots scanned in chunks of `threads` up to b1, stopping once
    `take` are counted; the index past the take-th is the limit (K where
    fewer lie below b1, 0 where take is 0), and a free slot is born below
    it."""
    k = len(free)
    limit = k if take > 0 else 0
    carry = 0
    k0 = 0
    while k0 < b1 and carry < take:
        chunk = free[k0:k0 + threads]
        ranks = carry + np.cumsum(chunk) - chunk
        hit = np.nonzero(chunk & (ranks == take - 1))[0]
        if hit.size:
            limit = k0 + int(hit[0]) + 1
        carry += int(chunk.sum())
        k0 += threads
    return free & (np.arange(k) < limit)


@pytest.mark.parametrize("k", [37, 100, 700, 5000])
@pytest.mark.parametrize("take", [0, 1, 3, 32, 4000])
def test_lowest_births_by_their_limit_equal_the_ranks(k, take):
    """The take lowest free slots (psi_reference's rank < take) equal the
    kernel's limit rule on every slice of the launch at K, with its
    threads."""
    rng = np.random.default_rng(k + take)
    free = rng.random(k) < 0.6
    rank = np.cumsum(free) - free
    want = free & (rank < take)
    shape = cuda_hdp.psi_launch_shape(k)
    for b0, b1 in shape["slices"]:
        got = lowest_births_emulation(free, take, b1, shape["threads"])
        np.testing.assert_array_equal(got[b0:b1], want[b0:b1])
