"""The large-K quality study of the port, tools/card_largek_quality.py, on
the CPU: its summaries of the JAX package's own record
(LARGEK_QUALITY.json) are that record's, its summaries equal the JAX
script's (benchmarks/largek_quality.py) on a synthetic record, its seeds
and t quantile are right, it runs end to end at a tiny size and resumes
from its record, and a `cuda` request without a card raises. The study
at K=4096 runs on the card (chip_smoke.py phase 10)."""

import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch
from scipy import stats as sps

from tools import card_largek_quality as lq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RECORD = os.path.join(ROOT, "LARGEK_QUALITY.json")
JAX_SEEDS_A = [f"precise_seed{s}" for s in range(5)]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "largek_quality_jax",
        os.path.join(ROOT, "benchmarks", "largek_quality.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_close(ours, theirs, path="", rel=1e-9):
    """Same keys and lengths; booleans exactly; numbers within `rel`."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and set(ours) == set(theirs), path
        for k in theirs:
            _assert_close(ours[k], theirs[k], f"{path}.{k}", rel)
    elif isinstance(theirs, list):
        assert len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _assert_close(a, b, f"{path}[{i}]", rel)
    elif isinstance(theirs, bool):
        assert isinstance(ours, bool) and ours is theirs, path
    else:
        assert ours == pytest.approx(theirs, rel=rel), path


def _record():
    with open(JAX_RECORD) as f:
        return json.load(f)


def test_summaries_of_the_jax_record_are_its_own():
    rec = _record()
    checks, ok = lq.a_checks(rec["A"], "bf16_seed0", JAX_SEEDS_A)
    _assert_close(checks, rec["A"]["checks"], "A.checks")
    assert ok is rec["A"]["gate_pass"]
    _assert_close(lq.b_summary(rec["B"]), rec["B"]["summary"], "B")
    # C's stray ggs_aliasmh_r4_seed0 chain is read by neither script
    assert "ggs_aliasmh_r4_seed0" in rec["C"]
    _assert_close(lq.c_summary(rec["C"], (0, 1, 2)), rec["C"]["summary"],
                  "C")


def test_card_record_is_consistent_and_near_the_jax_record():
    """LARGEK_QUALITY_TORCH.json, the whole study on the card: its
    summaries are its chains', every chain moved its counters, and each
    scheme's mean final LL and held-out LL lie within 4 pooled seed sigma
    of the JAX record's."""
    with open(os.path.join(ROOT, "LARGEK_QUALITY_TORCH.json")) as f:
        card = json.load(f)
    assert card["config"]["device"] == "cuda"
    checks, ok = lq.a_checks(card["A"], f"bf16_seed{lq.BF16_SEED}",
                             [f"precise_seed{s}" for s in lq.PRECISE_SEEDS])
    assert checks == card["A"]["checks"] and ok is card["A"]["gate_pass"]
    assert lq.b_summary(card["B"]) == card["B"]["summary"]
    assert lq.c_summary(card["C"], lq.PLATEAU_SEEDS) == card["C"]["summary"]
    assert card["C"]["summary"]["iters"] == 3000
    assert lq.failures(card) == []
    rows = {r["name"]: r for r in lq.compare_records(card, _record())}
    for field in ("ggs_final_ll", "aliasmh_final_ll", "ggs_held_out_ll",
                  "aliasmh_held_out_ll"):
        assert abs(rows[f"C mean {field}"]["difference_in_sigma"]) < 4


def test_jax_record_against_itself_and_its_failures():
    rec = _record()
    rows = lq.compare_records(rec, rec)
    assert len(rows) == 4 + 4 + 9
    assert all(r["difference"] == 0.0 for r in rows)
    assert all(r["difference_in_sigma"] in (0.0, None) for r in rows)
    assert "sigma" in lq.compare_line(rows[0])
    # the JAX record passes its gate and every chain rose; its counters
    # are not held (no card device in its record)
    assert lq.failures(rec) == []


def _traj(rng, every, iters, start, rise):
    steps = np.arange(every, iters + every, every)
    vals = start + rise * (1 - np.exp(-steps / (iters / 3)))
    vals = vals + rng.normal(0, abs(rise) * 1e-3, len(steps))
    return {str(int(k)): float(np.float32(v)) for k, v in zip(steps, vals)}


def _synthetic_record(case: int) -> dict:
    """A record in the JAX script's tags: the bf16 chain inside the
    precise interval in case 0 and far outside in case 1; B's rounds
    nearing dense in case 1 only."""
    rng = np.random.default_rng(case)
    a = {}
    for s in range(5):
        a[f"precise_seed{s}"] = {
            "ll_traj": _traj(rng, 20, 200, -1.6e7, 2e6 + 2e4 * rng.normal()),
            "nk_gini": float(0.62 + 0.002 * rng.normal())}
    pre = [a[t]["ll_traj"]["200"] for t in JAX_SEEDS_A]
    off = 0.5 if case == 0 else 9.0
    traj = _traj(rng, 20, 200, -1.6e7, 2e6)
    traj["200"] = float(np.mean(pre) + off * np.std(pre, ddof=1))
    a["bf16_seed0"] = {"ll_traj": traj, "nk_gini": 0.621}
    b = {"dense_ggs": {"ll_traj": _traj(rng, 20, 200, -1.6e7, 2e6)}}
    dense = b["dense_ggs"]["ll_traj"]["200"]
    for r, gap in zip((1, 4, 16), ((3e5, 2e5, 1e5) if case else
                                   (1e5, 3e5, 2e5))):
        t = _traj(rng, 20, 200, -1.6e7, 2e6)
        t["200"] = dense + gap
        b[f"aliasmh_r{r}"] = {"ll_traj": t}
    c = {}
    for scheme, top in (("ggs", -1.12e7), ("ggs_aliasmh", -9.9e6)):
        for s in range(3):
            c[f"{scheme}_seed{s}"] = {
                "ll_traj": _traj(rng, 100, 3000, -1.5e7,
                                 top + 1.5e7 + 3e4 * rng.normal()),
                "held_out_ll": float(-1.06e5 + 100 * rng.normal()),
                "nk_gini": 0.6}
    return {"A": a, "B": b, "C": c}


@pytest.mark.parametrize("case", [0, 1])
def test_summaries_equal_the_jax_scripts(case, tmp_path):
    from ldagroupedgibbssampler_tpu.corpus.ragged import Corpus as JCorpus
    jl = _jax_script()
    rec = _synthetic_record(case)
    path = tmp_path / "record.json"
    path.write_text(json.dumps(rec))
    rep = jl.Report(str(path))
    # every chain is in the record, so the scripts' loops run none
    tiny = JCorpus(tokens=np.arange(40) % 7, doc_offsets=np.arange(0, 41, 4),
                   vocab=[f"w{i}" for i in range(7)])
    jl.section_a(rep, tiny)
    jl.section_b(rep, tiny)
    jl.section_c(rep, tiny, 3000)
    theirs = rep.data
    checks, ok = lq.a_checks(rec["A"], "bf16_seed0", JAX_SEEDS_A)
    assert checks == theirs["A"]["checks"] and ok is theirs["A"]["gate_pass"]
    assert ok is (case == 0)
    b = lq.b_summary(rec["B"])
    assert b == theirs["B"]["summary"]
    assert b["monotone_toward_dense"] is (case == 1)
    assert lq.c_summary(rec["C"], (0, 1, 2)) == theirs["C"]["summary"]


def test_t_quantile_and_seeds():
    assert lq.T_CRIT_995_DF4 == pytest.approx(sps.t.ppf(0.995, 4), abs=1e-3)
    assert lq.T_CRIT_995_DF4 == 4.604        # the JAX script's constant
    # the interval takes its quantile from the ensemble's size
    c = lq.predictive_check(0.0, [1.0, 2.0, 3.0, 4.0, 5.0])
    assert c["n"] == 5 and c["interval_half_width"] == pytest.approx(
        4.604 * np.std([1, 2, 3, 4, 5], ddof=1) * math.sqrt(1.2), rel=1e-12)
    assert lq.BF16_SEED not in lq.PRECISE_SEEDS
    assert len(set(lq.PRECISE_SEEDS)) == lq.N_PRECISE_SEEDS == 5
    seeds = lq.PRECISE_SEEDS + (lq.BF16_SEED, lq.ROUNDS_SEED) \
        + lq.PLATEAU_SEEDS
    assert 0 not in seeds and -1 not in seeds        # the clock


def test_rise_over_the_last_500():
    t = {str(k): float(k) for k in range(100, 3100, 100)}
    assert lq.rise_last_500(t) == 500.0
    assert lq.rise_last_500({"40": 3.0}) == 0.0     # one reading
    assert lq.rise_last_500({"100": 1.0, "400": 5.0}) == 4.0


def _card_chain(**kw):
    rec = {"ll_traj": {"20": -5.0, "40": -4.0}, "nk_gini": 0.5,
           "launches": {n: 1 for n in lq.COUNTERS}}
    rec.update(kw)
    return rec


def test_failures_name_what_a_card_record_misses():
    data = {"config": {"device": "cuda"},
            "A": {"bf16_seed6": _card_chain(), "gate_pass": True},
            "C": {"ggs_aliasmh_seed1": _card_chain(held_out_ll=-3.0)}}
    assert lq.failures(data) == []
    data["C"]["ggs_aliasmh_seed1"]["launches"]["pack_tables"] = 0
    data["A"]["bf16_seed6"]["launches"]["mh_rounds"] = 0   # not its scheme
    data["A"]["bf16_seed6"]["ll_traj"]["40"] = -6.0
    data["C"]["ggs_seed2"] = _card_chain(held_out_ll=float("nan"))
    data["C"]["ggs_seed2"]["launches"]["left_to_right"] = 0
    data["A"]["gate_pass"] = False
    out = lq.failures(data)
    assert out == [
        "A: the bf16 chain left the precise ensemble's interval",
        "A bf16_seed6: LL did not rise (-5.0 -> -6.0)",
        "C ggs_aliasmh_seed1: counters did not move: pack_tables",
        "C ggs_seed2: an LL is not finite",
        "C ggs_seed2: counters did not move: left_to_right"]
    data["config"]["device"] = "cpu"               # counters held on cards
    assert len(lq.failures(data)) == 3


def test_cut_corpus_keeps_the_used_types():
    full = lq.study_corpus()
    cut = lq.study_corpus(30)
    assert cut.num_docs == 30 and full.num_docs == 11269
    n = cut.num_tokens
    assert np.array_equal(cut.doc_offsets, full.doc_offsets[:31])
    assert [cut.vocab[t] for t in cut.tokens] == [full.vocab[t] for t in
                                                  full.tokens[:n]]
    assert cut.num_types == len(np.unique(full.tokens[:n]))


TINY = ["--device", "cpu", "--docs", "150", "--topics", "8", "--iters-a",
        "20", "--iters-b", "20", "--iters-c", "40", "--token-block", "256"]


def test_study_runs_on_the_cpu_and_resumes(tmp_path, capsys, monkeypatch):
    out = tmp_path / "largek.json"
    rc = lq.main(TINY + ["--out", str(out), "--jax-record", JAX_RECORD])
    data = json.loads(out.read_text())
    assert rc == (1 if lq.failures(data) else 0)
    assert data["config"] == {"device": "cpu", "docs": 150, "topics": 8,
                              "token_block": 256, "iters_A": 20,
                              "iters_B": 20, "iters_C": 40}
    assert sorted(data["A"]) == sorted(
        ["bf16_seed6", "checks", "gate_pass"]
        + [f"precise_seed{s}" for s in range(1, 6)])
    assert list(data["A"]["checks"]) == ["ll_20", "nk_gini"]
    assert sorted(data["B"]) == ["aliasmh_r1", "aliasmh_r16", "aliasmh_r4",
                                 "dense_ggs", "summary"]
    assert sorted(data["C"]) == sorted(
        [f"{s}_seed{n}" for s in ("ggs", "ggs_aliasmh") for n in (1, 2, 3)]
        + ["summary"])
    c = data["C"]["summary"]
    assert c["iters"] == 40 and all(np.isfinite(c["ggs_held_out_ll"]))
    for _, tag, _, rec in lq.chains_of(data):
        assert np.isfinite(rec["ll_init"]) and rec["ms_per_iteration"] > 0
        assert set(rec["launches"]) == set(lq.COUNTERS)
    text = capsys.readouterr().out
    assert "A ll_20: bf16" in text and "C mean ggs_held_out_ll: card" in text
    assert "large-K study" in text

    # a rerun skips every finished chain and summarises the same record
    def no_model(*a, **k):
        raise AssertionError("a finished chain ran again")
    monkeypatch.setattr(lq, "create_model", no_model)
    rc2 = lq.main(TINY + ["--out", str(out)])
    again = json.loads(out.read_text())
    assert rc2 == rc and again == data
    with pytest.raises(ValueError, match="topics"):
        lq.main(TINY[:4] + ["--topics", "9"] + TINY[6:]
                + ["--out", str(out)])


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        lq.main(["--device", "cuda"])
