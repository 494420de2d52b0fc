"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, a CUDA request without CUDA raises, and PERF.md's kernel table
lists every Pallas kernel of the JAX package."""

import glob
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
sys.path.insert(0, sys.argv[1])
import ldagroupedgibbssampler_tpu_torch
import ldagroupedgibbssampler_tpu_torch.models.adlda
import ldagroupedgibbssampler_tpu_torch.models.cgs
import ldagroupedgibbssampler_tpu_torch.models.ggs
import ldagroupedgibbssampler_tpu_torch.models.ggs_aliasmh
import ldagroupedgibbssampler_tpu_torch.models.hdp
import ldagroupedgibbssampler_tpu_torch.models.lightlda
import ldagroupedgibbssampler_tpu_torch.models.nzvs
import ldagroupedgibbssampler_tpu_torch.models.pcgs
import ldagroupedgibbssampler_tpu_torch.models.polyaurn
import ldagroupedgibbssampler_tpu_torch.models.priors
import ldagroupedgibbssampler_tpu_torch.ops.cuda_lightlda
import ldagroupedgibbssampler_tpu_torch.ops.cuda_pcgs
import ldagroupedgibbssampler_tpu_torch.ops.kernels
import ldagroupedgibbssampler_tpu_torch.tui.parallel_lda
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "ldagroupedgibbssampler_tpu"
             or m.startswith("ldagroupedgibbssampler_tpu."))
print("LOADED:" + ",".join(bad))
"""


def test_port_imports_no_jax():
    # -I: a fresh interpreter that ignores PYTHONPATH and the user site, so
    # nothing but the port's own imports can load a module
    out = subprocess.run([sys.executable, "-I", "-c", _PROBE, ROOT],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("LOADED:")]
    assert line == ["LOADED:"], out.stdout


def test_cuda_request_without_cuda_raises(monkeypatch):
    from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
    from ldagroupedgibbssampler_tpu_torch.models.ggs import (
        LDAGroupedGibbsSampler)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        LDAGroupedGibbsSampler(LDAConfig(device="cuda"))
    assert LDAConfig().device == "cuda"     # the default asks for the card
    LDAGroupedGibbsSampler(LDAConfig(device="cpu"))


def test_unknown_scheme_names_ported_ones():
    from ldagroupedgibbssampler_tpu_torch import create_model
    from ldagroupedgibbssampler_tpu_torch.config.lda_config import LDAConfig
    with pytest.raises(ValueError, match="ggs_test.*pcgs"):
        create_model(LDAConfig(scheme="sharded_ggs", device="cpu"))


def test_port_has_every_scheme_of_the_jax_registry():
    """The port's SCHEMES keys are the JAX registry's SCHEMES keys, read
    from the JAX file as text (importing it would load JAX), and each
    names a class of the port."""
    import importlib

    from ldagroupedgibbssampler_tpu_torch.models.registry import SCHEMES
    with open(os.path.join(ROOT, "ldagroupedgibbssampler_tpu", "models",
                           "registry.py"), encoding="utf-8") as f:
        text = f.read()
    block = re.search(r"^SCHEMES = \{(.*?)^\}", text, re.M | re.S).group(1)
    jax_keys = re.findall(r'^    "(\w+)":', block, re.M)
    assert len(jax_keys) == 18
    assert sorted(SCHEMES) == sorted(jax_keys)
    for module, cls, _ in SCHEMES.values():
        assert hasattr(importlib.import_module(
            f"ldagroupedgibbssampler_tpu_torch.models.{module}"), cls)


def test_kernel_inventory_matches_perf_table():
    """Every function of the JAX package that reaches `pl.pallas_call` has
    one row in PERF.md's port kernel table, so a kernel added later
    without a row fails here."""
    calls = 0
    for path in glob.glob(os.path.join(
            ROOT, "ldagroupedgibbssampler_tpu", "ops", "*.py")):
        with open(path, encoding="utf-8") as f:
            calls += f.read().count("pl.pallas_call")
    with open(os.path.join(ROOT, "PERF.md"), encoding="utf-8") as f:
        rows = [ln for ln in f if re.match(
            r"^\|\s*\d+\s*\|\s*`?ldagroupedgibbssampler_tpu/ops/"
            r"pallas_\w+\.py:\d+", ln)]
    assert calls == 6
    assert len(rows) == calls, rows
