"""The port's host layers against the JAX package's: cell blocks bit for
bit, text loading, INI parsing."""

import dataclasses

import numpy as np
import pytest

from ldagroupedgibbssampler_tpu.config.ini import parse_ini as jax_parse_ini
from ldagroupedgibbssampler_tpu.corpus.pipeline import (
    load_dataset as jax_load_dataset)
from ldagroupedgibbssampler_tpu.corpus.ragged import (
    build_cell_blocks as jax_build_cell_blocks)
from ldagroupedgibbssampler_tpu_torch.config.ini import parse_ini
from ldagroupedgibbssampler_tpu_torch.corpus.pipeline import load_dataset
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import (
    build_cell_blocks, build_cell_blocks_reference)


def _tokens(num_docs, num_types, seed, max_len=80):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len, num_docs)
    tokens = rng.integers(0, num_types, int(lens.sum())).astype(np.int32)
    doc_ids = np.repeat(np.arange(num_docs, dtype=np.int32), lens)
    return tokens, doc_ids


@pytest.mark.parametrize("num_docs,num_types,block,vspan,dspan", [
    (120, 700, 256, 128, 128),
    (300, 3000, 1024, 512, 512),
    (90, 400, 512, 256, 128),
    (40, 90, 128, 128, 512),
])
def test_cell_blocks_bit_identical(num_docs, num_types, block, vspan, dspan):
    tokens, doc_ids = _tokens(num_docs, num_types, seed=num_docs)
    kw = dict(block=block, vspan=vspan, dspan=dspan, chunk=128)
    ours = build_cell_blocks(tokens, doc_ids, num_types, num_docs, **kw)
    ref = jax_build_cell_blocks(tokens, doc_ids, num_types, num_docs, **kw)
    loop = build_cell_blocks_reference(tokens, doc_ids, num_types, num_docs,
                                       **kw)
    for f in dataclasses.fields(ref):
        a, b, c = (getattr(x, f.name) for x in (ours, ref, loop))
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
            assert np.array_equal(c, b), f.name
        else:
            assert a == b == c, f.name


def test_load_dataset_matches_jax(tmp_path):
    path = tmp_path / "docs.txt"
    rng = np.random.default_rng(0)
    words = ["Cat", "lynx's", "leopard", "x", "tiger-paw", "purr42", "oak",
             "pine", "forest", "éclair", "road", "brake"]
    with open(path, "w", encoding="utf-8") as f:
        for d in range(40):
            text = " ".join(words[i] for i in rng.integers(0, len(words), 15))
            f.write(f"docno:{d}\tL{d % 3}\t{text}\n")
        f.write("only-text-line with words\n")
    stop = tmp_path / "stop.txt"
    stop.write_text("oak\nroad\n")
    for kw in (dict(), dict(rare_threshold=3, stoplist_path=str(stop))):
        ours = load_dataset(str(path), **kw)
        ref = jax_load_dataset(str(path), **kw)
        assert np.array_equal(ours.tokens, ref.tokens)
        assert np.array_equal(ours.doc_offsets, ref.doc_offsets)
        assert ours.vocab == ref.vocab
        assert ours.labels == ref.labels and ours.doc_ids == ref.doc_ids


def test_parse_ini_matches_jax(tmp_path):
    path = tmp_path / "run.cfg"
    path.write_text(
        "configs = a, b\nno_runs = 2\ntopics = 20  # trailing comment\n"
        "alpha = 0.1\nbeta = 0.01\nseed = 4\ndiagnostic_interval = 5, 9\n"
        "batch_building_scheme = cc.mallet.topics.randomscan.document."
        "PercentageBatchBuilder\nlambda = 0.4\n\n"
        "[a]\nscheme = ggs\nzdraw_precise = true\n\n"
        "[b]\nscheme = ggs_test\ntopics = 7\ndevice = cpu\n")
    ours, ref = parse_ini(str(path)), jax_parse_ini(str(path))
    assert ours.sub_config_names() == ref.sub_config_names() == ["a", "b"]
    for name in ("a", "b"):
        c_ours = ours.activate(name, {"iterations": "12"})
        c_ref = ref.activate(name, {"iterations": "12"})
        for f in dataclasses.fields(c_ref):
            assert getattr(c_ours, f.name) == getattr(c_ref, f.name), f.name
    assert ours.activate("a").device == "cuda"
    assert ours.activate("b").device == "cpu"
    assert ref.activate("b").extra_keys == {"device": "cpu"}
