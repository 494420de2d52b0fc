"""The port's alias tables, host sampling helpers and categorical draws on
the CPU: tests/test_alias_utils.py and the categorical cases of
tests/test_random_ops.py with the same bars, drawing from torch generators
in place of JAX keys, and the alias tables and host helpers equal to the
JAX package's."""

import numpy as np
import pytest
import torch
from scipy import stats

from ldagroupedgibbssampler_tpu.ops import alias as jax_alias
from ldagroupedgibbssampler_tpu.utils import sampling as jax_sampling
from ldagroupedgibbssampler_tpu_torch.ops import categorical as cat
from ldagroupedgibbssampler_tpu_torch.ops.alias import (
    PoissonFixedCoeffSampler, WalkerAliasTable, alias_sample,
    build_alias_table)
from ldagroupedgibbssampler_tpu_torch.utils.sampling import (
    index_sorter, sample_without_replacement, systematic_sample)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


class TestAliasTable:
    def test_table_is_valid_and_equals_jax(self):
        rng = np.random.default_rng(0)
        p = rng.gamma(1.0, 1.0, 50)
        prob, alias = build_alias_table(p)
        assert prob.shape == (50,)
        assert np.all((prob >= 0) & (prob <= 1 + 1e-9))
        assert np.all((alias >= 0) & (alias < 50))
        jprob, jalias = jax_alias.build_alias_table(p)
        assert np.array_equal(prob, jprob) and np.array_equal(alias, jalias)
        with pytest.raises(ValueError, match="positive"):
            build_alias_table([0.0, 0.0])

    def test_chi_square_against_target(self):
        # WalkerAliasTableTest style: draws match the target multinomial
        rng = np.random.default_rng(1)
        p = rng.gamma(1.0, 1.0, 20)
        p /= p.sum()
        table = WalkerAliasTable(p)
        n = 200_000
        draws = table.generate_sample(_gen(2), (n,))
        counts = np.bincount(draws, minlength=20)
        expected = p * n
        chi2 = np.sum((counts - expected) ** 2 / expected)
        # 19 dof: 99.9th percentile ~ 43.8
        assert chi2 < 43.8, chi2

    def test_degenerate_distribution(self):
        table = WalkerAliasTable([0.0, 1.0, 0.0])
        draws = table.generate_sample(_gen(0), (1000,))
        assert np.all(draws == 1)
        with pytest.raises(RuntimeError, match="init_table"):
            WalkerAliasTable().generate_sample(_gen(0), (3,))

    def test_poisson_fixed_coeff_moments(self):
        lam = 3.5
        sampler = PoissonFixedCoeffSampler(lam)
        draws = sampler.next_poisson(_gen(3), (100_000,))
        assert np.mean(draws) == pytest.approx(lam, rel=0.02)
        assert np.var(draws) == pytest.approx(lam, rel=0.05)

    def test_draws_follow_the_generator(self):
        prob, alias = build_alias_table([0.2, 0.5, 0.3])
        a = alias_sample(prob, alias, _gen(5), (64,))
        b = alias_sample(prob, alias, _gen(5), (64,))
        assert a.dtype == torch.int32 and a.shape == (64,)
        assert torch.equal(a, b)


class TestSamplingUtils:
    def test_systematic_proportional(self):
        w = np.asarray([100.0, 1.0, 1.0, 100.0, 1.0])
        rng = np.random.default_rng(0)
        hits = np.zeros(5)
        for _ in range(200):
            idx = systematic_sample(w, 2, rng)
            hits[idx] += 1
        # heavy items almost always included, light items rarely
        assert hits[0] > 180 and hits[3] > 180
        assert hits[1] + hits[2] + hits[4] < 40

    def test_without_replacement_distinct(self):
        idx = sample_without_replacement(100, 30, np.random.default_rng(1))
        assert len(np.unique(idx)) == 30

    def test_index_sorter_descending_stable(self):
        out = index_sorter([3, 9, 3, 1])
        np.testing.assert_array_equal(out, [1, 0, 2, 3])

    def test_equal_jax_for_one_seed(self):
        w = np.random.default_rng(3).gamma(1.0, 1.0, 40)
        for seed in range(3):
            assert np.array_equal(
                systematic_sample(w, 7, np.random.default_rng(seed)),
                jax_sampling.systematic_sample(w, 7,
                                               np.random.default_rng(seed)))
            assert np.array_equal(
                sample_without_replacement(40, 9, np.random.default_rng(seed)),
                jax_sampling.sample_without_replacement(
                    40, 9, np.random.default_rng(seed)))
        assert np.array_equal(index_sorter(w), jax_sampling.index_sorter(w))


def test_gumbel_categorical_chi_square():
    """Chi-square goodness of fit of the Gumbel-max draw against the target
    pmf (WalkerAliasTableTest analogue)."""
    probs = np.asarray([0.05, 0.1, 0.15, 0.3, 0.4])
    logits = torch.log(torch.as_tensor(probs, dtype=torch.float32))
    n = 100000
    draws = cat.gumbel_categorical(logits.expand(n, 5), _gen(123))
    assert draws.dtype == torch.int32
    counts = np.bincount(draws.numpy(), minlength=5)
    chi2 = stats.chisquare(counts, probs * n)
    assert chi2.pvalue > 1e-3, (counts, chi2)


def test_inverse_cdf_matches_gumbel_distribution():
    probs = np.asarray([0.2, 0.3, 0.5])
    n = 50000
    draws = cat.inverse_cdf_categorical(
        torch.as_tensor(probs, dtype=torch.float32).expand(n, 3), _gen(123))
    counts = np.bincount(draws.numpy(), minlength=3)
    chi2 = stats.chisquare(counts, probs * n)
    assert chi2.pvalue > 1e-3, counts


def test_masked_gumbel_never_selects_masked():
    logits = torch.zeros((1000, 6))
    mask = torch.as_tensor([True, False, True, True, False, True])
    draws = cat.masked_gumbel_categorical(logits, mask.expand(1000, 6),
                                          _gen(123))
    assert not np.isin(draws.numpy(), [1, 4]).any()
    assert set(np.unique(draws.numpy())) == {0, 2, 3, 5}
