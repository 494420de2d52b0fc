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


def test_cli_rejects_unported_scheme(tmp_path):
    cfg = _write_run(tmp_path, scheme="lightpclda", device="cpu")
    with pytest.raises(ValueError, match="ggs"):
        parallel_lda.main([f"--run_cfg={cfg}"])
