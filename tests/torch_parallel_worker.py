"""One rank of the port's multi-rank CPU tests
(tests/test_torch_parallel_gloo.py), run as its own process:

    python tests/torch_parallel_worker.py PORT RANK WORLD OUT_DIR

It joins a gloo group of WORLD ranks at 127.0.0.1:PORT and runs each of
the five sharded schemes on the planted-topic corpus of
tests/conftest.py::synthetic_corpus, with paranoid checks every iteration
(the exact recount of the gathered z against the merged counts, and every
replicated tensor bit-equal across the ranks). For each scheme it writes
OUT_DIR/<scheme>_<WORLD>_<RANK>.npz: the chain's gathered z, counts
(also as `get_type_topic_matrix`), beta and likelihood series, its replicated tensors as this rank holds them, a
second chain from the same seed, a z round trip, and the n_dk reduction's
dtype; and OUT_DIR/psum_<WORLD>_<RANK>.npz, whether an int16 all-reduce
was refused and the int16 route of `psum_counts` against int32. Then,
per scheme, it waits for OUT_DIR/jax_<scheme>_<WORLD>.npz (a JAX sharded
chain's canonical z, alpha and beta, written by the test) and writes
OUT_DIR/carried_<scheme>_<WORLD>_<RANK>.npz: the merged counts and
likelihood of that state carried into the port's ranks. It imports
neither JAX nor the JAX package.
"""

import dataclasses
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ldagroupedgibbssampler_tpu_torch.config.lda_config import (  # noqa: E402
    LDAConfig)
from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus  # noqa: E402
from ldagroupedgibbssampler_tpu_torch.models.registry import (  # noqa: E402
    _SHARDED_SCHEMES, create_model)
from ldagroupedgibbssampler_tpu_torch.parallel import (  # noqa: E402
    distributed_initialize, make_mesh, psum, state_from_jax_z)
from ldagroupedgibbssampler_tpu_torch.parallel.mesh import (  # noqa: E402
    psum_counts)

ITERS = 50
WAIT_S = 300.0


def config(scheme, **kw):
    """The sharded schemes' test configuration (both test files)."""
    base = dict(scheme=scheme, topics=3, alpha=1.0, beta=0.01, seed=7,
                exec_time=-1, token_block=256, vocab_span=4, doc_span=16,
                topic_interval=ITERS, device="cpu")
    base.update(kw)
    return LDAConfig(**base)


def planted_corpus():
    """tests/conftest.py's synthetic_corpus, as a port Corpus."""
    rng = np.random.default_rng(42)
    num_topics, types_per_topic, num_docs, doc_len = 3, 10, 60, 40
    vocab = [f"w{k}_{i}" for k in range(num_topics)
             for i in range(types_per_topic)]
    docs = []
    for d in range(num_docs):
        k = d % num_topics
        main = rng.integers(0, types_per_topic, int(doc_len * 0.9)) \
            + k * types_per_topic
        noise = rng.integers(0, len(vocab), doc_len - len(main))
        docs.append(list(np.concatenate([main, noise])))
    return Corpus.from_token_lists(docs, vocab)


def _arrays(model) -> dict:
    st = model.state
    out = dict(z=model.get_z_indicators(),
               nkw=model.get_topic_type_counts(),
               ndk=model.get_document_topic_matrix(),
               nk=model.get_tokens_per_topic(),
               phi=st.phi.numpy(), nkw_state=st.nkw.numpy(),
               type_topic=model.get_type_topic_matrix(),
               beta=model.get_beta(),
               ll=np.asarray([ll for _, ll in model.get_log_likelihoods()]))
    if st.theta is not None and st.theta.shape[0] == \
            model.full_corpus.num_docs:
        out["theta"] = st.theta.numpy()     # replicated (vocab_sharded_ggs)
    return out


def run_scheme(scheme, corpus, rank, world, out_dir):
    model = create_model(config(scheme, paranoid=True)).add_instances(corpus)
    ll0 = model.model_log_likelihood()
    model.sample(ITERS)
    first = _arrays(model)
    again = create_model(config(scheme)).add_instances(corpus)
    again.sample(ITERS)
    second = _arrays(again)
    z0 = (np.arange(corpus.num_tokens) % 3).astype(np.int32)
    again.set_z_indicators(z0)
    np.savez(os.path.join(out_dir, f"{scheme}_{world}_{rank}.npz"),
             ll0=ll0, **first, **{f"again_{k}": v for k, v in second.items()},
             roundtrip_z=again.get_z_indicators(),
             roundtrip_nkw=again.get_topic_type_counts(),
             roundtrip_ndk=again.get_document_topic_matrix(),
             ndk_dtype=str(getattr(model, "_ndk_dtype", "")),
             backend=str(model.mesh.backend))


def carry_jax_state(scheme, corpus, rank, world, out_dir):
    path = os.path.join(out_dir, f"jax_{scheme}_{world}.npz")
    deadline = time.time() + WAIT_S
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.2)
    with np.load(path) as d:
        z, alpha, beta = d["z"], d["alpha"], d["beta"]
    model = create_model(config(scheme)).add_instances(corpus)
    state_from_jax_z(model, z, alpha, beta)
    np.savez(os.path.join(out_dir, f"carried_{scheme}_{world}_{rank}.npz"),
             nkw=model.get_topic_type_counts(),
             ndk=model.get_document_topic_matrix(),
             nk=model.get_tokens_per_topic(), z=model.get_z_indicators(),
             ll=model.model_log_likelihood())


def main():
    port, rank, world, out_dir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    distributed_initialize(f"127.0.0.1:{port}", num_processes=world,
                           process_id=rank, device="cpu", timeout_s=120)
    corpus = planted_corpus()
    for scheme in _SHARDED_SCHEMES:
        run_scheme(scheme, corpus, rank, world, out_dir)
    # gloo has no int16 all-reduce: psum refuses it, int32 goes through
    mesh = make_mesh()
    try:
        psum(torch.ones(4, dtype=torch.int16), mesh)
        int16 = "accepted"
    except TypeError:
        int16 = "refused"
    try:       # gloo's own refusal, which psum's anticipates
        torch.distributed.all_reduce(torch.ones(4, dtype=torch.int16))
        gloo_int16 = "accepted"
    except RuntimeError:
        gloo_int16 = "refused"
    int32 = int(psum(torch.ones(4, dtype=torch.int32), mesh).sum())
    # the int16 route of psum_counts (NCCL's), here over gloo: non-negative
    # counts whose totals are below 2^15, an odd number of them
    counts = torch.as_tensor(np.random.default_rng(rank).integers(
        0, 2 ** 15 // world, (7, 5)), dtype=torch.int32)
    as_nccl = dataclasses.replace(mesh, backend="nccl")
    packed = psum_counts(counts.clone(), as_nccl, 2 ** 15 - 1)
    np.savez(os.path.join(out_dir, f"psum_{world}_{rank}.npz"),
             int16=int16, gloo_int16=gloo_int16, int32=int32,
             packed=packed.numpy(), plain=psum(counts, mesh).numpy())
    for scheme in _SHARDED_SCHEMES:
        carry_jax_state(scheme, corpus, rank, world, out_dir)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
