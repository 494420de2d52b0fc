"""The port's experiment driver (tui.parallel_lda.main) on the CPU."""

import glob
import os

import numpy as np
import pytest

from ldagroupedgibbssampler_tpu_torch.tui import parallel_lda


def _write_run(tmp_path, scheme="ggs", device="cuda"):
    rng = np.random.default_rng(0)
    themes = [["cat", "lynx", "leopard", "tiger", "kitten", "paw"],
              ["car", "engine", "wheel", "road", "drive", "fuel"],
              ["tree", "leaf", "forest", "branch", "root", "pine"]]
    docs = tmp_path / "docs.txt"
    with open(docs, "w") as f:
        for d in range(60):
            words = [themes[d % 3][i] for i in rng.integers(0, 6, 25)]
            f.write(f"docno:{d}\tL{d % 3}\t{' '.join(words)}\n")
    cfg = tmp_path / "run.cfg"
    cfg.write_text(
        f"configs = one\nno_runs = 1\nexperiment_out_dir = {tmp_path}/runs\n"
        f"exec_time = 300\niterations = 20\ntopics = 3\nalpha = 1\n"
        f"beta = 0.01\ndataset = {docs}\nrare_threshold = 0\nseed = 2019\n"
        f"topic_interval = 10\nstart_diagnostic = 1\nstoplist =\n"
        f"device = {device}\n\n[one]\nscheme = {scheme}\n")
    return str(cfg)


def test_cli_runs_ggs_on_cpu(tmp_path):
    cfg = _write_run(tmp_path)
    parallel_lda.main([f"--run_cfg={cfg}", "--device=cpu"])
    run_dirs = glob.glob(str(tmp_path / "runs" / "RunSuite*" / "Runone-*"))
    assert len(run_dirs) == 1
    run = run_dirs[0]
    for fn in ("likelihood.txt", "log_posterior.txt", "TopWords.txt",
               "RelevanceWords.txt", "run_metadata.json", "console.txt"):
        assert os.path.exists(os.path.join(run, fn)), fn
    lls = [float(ln.split("\t")[1])
           for ln in open(os.path.join(run, "likelihood.txt"))]
    assert len(lls) == 2 and lls[1] > lls[0] - 50
    top = open(os.path.join(run, "TopWords.txt")).read().splitlines()
    assert len(top) == 3 and top[0].startswith("Topic 0: ")


def test_cli_runs_pcgs_on_cpu(tmp_path):
    """A [K, V]-layout scheme writes the JAX driver's artifacts: topic
    words from its counts, the likelihood series and phi.csv."""
    cfg = _write_run(tmp_path, scheme="pcgs", device="cpu")
    with open(cfg, "a") as f:
        f.write("save_phi = true\n")
    parallel_lda.main([f"--run_cfg={cfg}"])
    run = glob.glob(str(tmp_path / "runs" / "RunSuite*" / "Runone-*"))[0]
    lls = [float(ln.split("\t")[1])
           for ln in open(os.path.join(run, "likelihood.txt"))]
    assert len(lls) == 2 and lls[1] > lls[0] - 50
    top = open(os.path.join(run, "TopWords.txt")).read().splitlines()
    assert len(top) == 3
    # each topic's top words come from one theme
    themes = ["cat lynx leopard tiger kitten paw",
              "car engine wheel road drive fuel",
              "tree leaf forest branch root pine"]
    for line in top:
        words = line.split(": ", 1)[1].split()[:4]
        assert any(all(w in t.split() for w in words) for t in themes), line
    phi = np.loadtxt(os.path.join(run, "phi.csv"), delimiter=",")
    assert phi.shape == (3, 18)
    np.testing.assert_allclose(phi.sum(axis=1), 1.0, atol=1e-4)


def test_cli_runs_lightpclda_on_cpu(tmp_path):
    """A LightLDA MH scheme through the experiment CLI: the likelihood
    series (no drop, as for ggs and pcgs) and the topic words from its
    counts."""
    cfg = _write_run(tmp_path, scheme="lightpclda", device="cpu")
    parallel_lda.main([f"--run_cfg={cfg}"])
    runs = glob.glob(str(tmp_path / "runs" / "RunSuite*" / "Runone-*"))
    assert len(runs) == 1
    lls = [float(ln.split("\t")[1])
           for ln in open(os.path.join(runs[0], "likelihood.txt"))]
    assert len(lls) == 2 and lls[1] > lls[0] - 50
    top = open(os.path.join(runs[0], "TopWords.txt")).read().splitlines()
    assert len(top) == 3 and top[0].startswith("Topic 0: ")


def test_cli_runs_adlda_on_cpu(tmp_path):
    """Scheme `adlda` through the experiment CLI: the likelihood series
    and each topic's top words from one theme."""
    cfg = _write_run(tmp_path, scheme="adlda", device="cpu")
    parallel_lda.main([f"--run_cfg={cfg}"])
    runs = glob.glob(str(tmp_path / "runs" / "RunSuite*" / "Runone-*"))
    assert len(runs) == 1
    lls = [float(ln.split("\t")[1])
           for ln in open(os.path.join(runs[0], "likelihood.txt"))]
    assert len(lls) == 2 and lls[1] > lls[0] - 50
    top = open(os.path.join(runs[0], "TopWords.txt")).read().splitlines()
    assert len(top) == 3 and top[0].startswith("Topic 0: ")


def test_cli_rejects_unported_scheme(tmp_path):
    cfg = _write_run(tmp_path, scheme="sharded_ggs", device="cpu")
    with pytest.raises(ValueError, match="ggs"):
        parallel_lda.main([f"--run_cfg={cfg}"])


def test_cli_runs_spalias_priors_and_ppu_hdplda_on_cpu(tmp_path):
    """Two sections of one run file reach the registry's new schemes: a
    spalias_priors section with its topic_prior_filename (each topic's
    top words come from its anchors' theme, and phi.csv is exactly 0 on
    the other topics' anchors) and a ppu_hdplda section (K_max 6, a
    finite likelihood series)."""
    cfg = _write_run(tmp_path, scheme="spalias_priors", device="cpu")
    prior = tmp_path / "priors.txt"
    anchors = [["cat", "lynx"], ["car", "engine"], ["tree", "leaf"]]
    prior.write_text("".join(f"{k}, {', '.join(a)}\n"
                             for k, a in enumerate(anchors)))
    text = open(cfg).read().replace("configs = one", "configs = one, hdp")
    text = text.replace("scheme = spalias_priors",
                        f"scheme = spalias_priors\n"
                        f"topic_prior_filename = {prior}\nsave_phi = true\n"
                        f"save_vocabulary = true")
    with open(cfg, "w") as f:
        f.write(text + "\n[hdp]\nscheme = ppu_hdplda\ntopics = 6\n")
    parallel_lda.main([f"--run_cfg={cfg}"])
    run = glob.glob(str(tmp_path / "runs" / "RunSuite*" / "Runone-*"))
    assert len(run) == 1
    themes = [{"cat", "lynx", "leopard", "tiger", "kitten", "paw"},
              {"car", "engine", "wheel", "road", "drive", "fuel"},
              {"tree", "leaf", "forest", "branch", "root", "pine"}]
    top = open(os.path.join(run[0], "TopWords.txt")).read().splitlines()
    for k, line in enumerate(top):
        assert set(line.split(": ", 1)[1].split()[:4]) <= themes[k], line
    vocab = open(os.path.join(run[0], "lda_vocab.txt")).read().split()
    phi = np.loadtxt(os.path.join(run[0], "phi.csv"), delimiter=",")
    assert phi.shape == (3, 18)
    for k in range(3):
        for j, words in enumerate(anchors):
            cols = [vocab.index(w) for w in words]
            assert (phi[k, cols] == 0).all() == (j != k), (k, words)
    hdp = glob.glob(str(tmp_path / "runs" / "RunSuite*" / "Runhdp-*"))
    assert len(hdp) == 1
    lls = [float(ln.split("\t")[1])
           for ln in open(os.path.join(hdp[0], "likelihood.txt"))]
    assert len(lls) == 2 and np.isfinite(lls).all()
    top = open(os.path.join(hdp[0], "TopWords.txt")).read().splitlines()
    assert len(top) == 6
