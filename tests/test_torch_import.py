"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, a CUDA request without CUDA raises, every module of the JAX
package has its counterpart in the port, and PERF.md's kernel table lists
every Pallas kernel of the JAX package."""

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
import ldagroupedgibbssampler_tpu_torch.classify
import ldagroupedgibbssampler_tpu_torch.classify.confusion
import ldagroupedgibbssampler_tpu_torch.classify.kl_classifier
import ldagroupedgibbssampler_tpu_torch.corpus._native_build
import ldagroupedgibbssampler_tpu_torch.corpus.native_blocks
import ldagroupedgibbssampler_tpu_torch.corpus.native_loader
import ldagroupedgibbssampler_tpu_torch.corpus.perplexity
import ldagroupedgibbssampler_tpu_torch.evaluation.diagnostics
import ldagroupedgibbssampler_tpu_torch.evaluation.foldin
import ldagroupedgibbssampler_tpu_torch.evaluation.hyperopt
import ldagroupedgibbssampler_tpu_torch.evaluation.marginal
import ldagroupedgibbssampler_tpu_torch.evaluation.topwords
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
import ldagroupedgibbssampler_tpu_torch.ops.alias
import ldagroupedgibbssampler_tpu_torch.ops.categorical
import ldagroupedgibbssampler_tpu_torch.ops.cuda_lightlda
import ldagroupedgibbssampler_tpu_torch.ops.cuda_pcgs
import ldagroupedgibbssampler_tpu_torch.ops.kernels
import ldagroupedgibbssampler_tpu_torch.parallel
import ldagroupedgibbssampler_tpu_torch.parallel.mesh
import ldagroupedgibbssampler_tpu_torch.parallel.sharded
import ldagroupedgibbssampler_tpu_torch.parallel.sharded_adlda
import ldagroupedgibbssampler_tpu_torch.parallel.sharded_ggs
import ldagroupedgibbssampler_tpu_torch.parallel.sharded_pcgs
import ldagroupedgibbssampler_tpu_torch.parallel.vocab_sharded_ggs
import ldagroupedgibbssampler_tpu_torch.similarity
import ldagroupedgibbssampler_tpu_torch.similarity.bm25
import ldagroupedgibbssampler_tpu_torch.similarity.corpus_statistics
import ldagroupedgibbssampler_tpu_torch.similarity.distances
import ldagroupedgibbssampler_tpu_torch.similarity.lda_distancer
import ldagroupedgibbssampler_tpu_torch.tui.bm25_search
import ldagroupedgibbssampler_tpu_torch.tui.common
import ldagroupedgibbssampler_tpu_torch.tui.kl_classifier
import ldagroupedgibbssampler_tpu_torch.tui.lda_similarity
import ldagroupedgibbssampler_tpu_torch.tui.parallel_lda
import ldagroupedgibbssampler_tpu_torch.tui.svmlight_export
import ldagroupedgibbssampler_tpu_torch.tui.topic_mass
import ldagroupedgibbssampler_tpu_torch.tui.train_test
import ldagroupedgibbssampler_tpu_torch.tui.xvalidation
import ldagroupedgibbssampler_tpu_torch.utils
import ldagroupedgibbssampler_tpu_torch.utils.matrix_io
import ldagroupedgibbssampler_tpu_torch.utils.sampling
import ldagroupedgibbssampler_tpu_torch.utils.timing
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


_TOOLS_PROBE = """
import sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
import tools.card_bf16_gate
import tools.card_geweke_check
import tools.card_largek_quality
import tools.card_pubmed_rehearsal
import tools.synth_corpus
chip_smoke.synth_corpus
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "ldagroupedgibbssampler_tpu"
             or m.startswith("ldagroupedgibbssampler_tpu."))
print("LOADED:" + ",".join(bad))
"""


def test_chain_check_tools_and_chip_smoke_import_no_jax():
    """The tools that chip_smoke.py's phases 9, 10 and 11 run on the
    card, and chip_smoke.py itself, load neither JAX nor the JAX
    package."""
    out = subprocess.run([sys.executable, "-I", "-c", _TOOLS_PROBE, ROOT],
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
        create_model(LDAConfig(scheme="no_such_scheme", device="cpu"))


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


def test_port_has_every_sharded_scheme_of_the_jax_registry():
    """The port's _SHARDED_SCHEMES keys, classes and descriptions are the
    JAX registry's _SHARDED_SCHEMES block, read as text, and each names a
    class of the port's parallel package."""
    import ast
    import importlib

    from ldagroupedgibbssampler_tpu_torch.models.registry import (
        _SHARDED_SCHEMES)
    with open(os.path.join(ROOT, "ldagroupedgibbssampler_tpu", "models",
                           "registry.py"), encoding="utf-8") as f:
        text = f.read()
    block = re.search(r"^_SHARDED_SCHEMES = (\{.*?^\})", text,
                      re.M | re.S).group(1)
    jax_schemes = ast.literal_eval(block)
    assert len(jax_schemes) == 5
    assert _SHARDED_SCHEMES == jax_schemes
    for module, cls, _ in _SHARDED_SCHEMES.values():
        assert hasattr(importlib.import_module(
            f"ldagroupedgibbssampler_tpu_torch.{module}"), cls)


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


def _modules(package: str) -> set:
    """The dotted module paths of a package's .py files, relative to it."""
    base = os.path.join(ROOT, package)
    out = set()
    for path in glob.glob(os.path.join(base, "**", "*.py"), recursive=True):
        rel = os.path.relpath(path, base)[: -len(".py")]
        out.add(rel.replace(os.sep, "."))
    return out


def test_every_jax_module_has_a_port_counterpart():
    """Each module of ldagroupedgibbssampler_tpu/ has one of the same path
    in the port, a Pallas module `ops/pallas_X` mapping to the port's
    hand-written kernel module `ops/cuda_X`: the port does all that the
    JAX package does, module by module."""
    jax_modules = _modules("ldagroupedgibbssampler_tpu")
    port = _modules("ldagroupedgibbssampler_tpu_torch")
    expected = {re.sub(r"^ops\.pallas_", "ops.cuda_", m) for m in jax_modules}
    assert len(jax_modules) >= 70
    assert sum(m.startswith("ops.pallas_") for m in jax_modules) == 4
    assert sorted(expected - port) == []


# JAX names with no counterpart of that name in the port, each with its
# reason; every other public name must have one
JAX_ONLY_NAMES = {
    "TpuLDASampler": "the port's base class is TorchLDASampler",
    "WSortedBlocks": "the Pallas count kernel's TPU tiling, used only by "
                     "benchmarks/micro.py and benchmarks/pallas_counts.py",
    "AlignedBlocks": "the Pallas count kernel's TPU tiling (as "
                     "WSortedBlocks)",
    "Corpus.w_sorted_blocks": "builds WSortedBlocks",
    "Corpus.aligned_blocks": "builds AlignedBlocks",
    "fused_zdraw_vmem_bytes": "the Pallas z-draw's VMEM budget",
    "stream_windows": "the Pallas streamed sweep's DMA windows",
    "doc_sequential_sweep": "the JAX off-TPU XLA sweep, a deliberate "
                            "divergence (ROADMAP C)",
    "lightlda_sweep": "the JAX XLA MH sweep at large K, a deliberate "
                      "divergence (ROADMAP C)",
}


def _public_names(package: str):
    """(top-level functions and classes, {Class.method}) of a package's
    modules, public names only."""
    import ast
    top, methods = set(), set()
    for path in glob.glob(os.path.join(ROOT, package, "**", "*.py"),
                          recursive=True):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                continue
            if not node.name.startswith("_"):
                top.add(node.name)
            if isinstance(node, ast.ClassDef):
                methods |= {f"{node.name}.{m.name}" for m in node.body
                            if isinstance(m, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
                            and not m.name.startswith("_")}
    return top, methods


def test_every_public_jax_name_has_a_port_counterpart():
    """Every public top-level function or class of the JAX package is a
    top-level function or class of the port, and every public method a
    method of some class of the port (the base class is renamed), but
    the allow-listed TPU-only names; an allow-listed name that the port
    gains, or that the JAX package loses, fails too."""
    jax_top, jax_methods = _public_names("ldagroupedgibbssampler_tpu")
    port_top, port_methods = _public_names("ldagroupedgibbssampler_tpu_torch")
    port_method_names = {m.split(".", 1)[1] for m in port_methods}
    missing = {n for n in jax_top if n not in port_top}
    missing |= {m for m in jax_methods
                if m.split(".", 1)[1] not in port_method_names}
    assert len(jax_top) >= 200 and len(jax_methods) >= 150
    assert sorted(missing) == sorted(JAX_ONLY_NAMES)
