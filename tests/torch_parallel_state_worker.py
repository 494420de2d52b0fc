"""One rank of tests/test_torch_parallel_state.py, run as its own process:

    python tests/torch_parallel_state_worker.py PORT RANK WORLD OUT_DIR

It joins a gloo group of WORLD ranks at 127.0.0.1:PORT and, for each of
the five sharded schemes on the planted-topic corpus of
tests/torch_parallel_worker.py, runs the state paths a single-device
sampler has: a checkpoint (rank 0 writes OUT_DIR/ckpt_<scheme>.npz, every
rank loads it into a new sampler, which then runs one iteration with the
paranoid checks), a fold-in (`sample_z_given_phi`, then one more
iteration with the paranoid checks), a swap to a corpus of the same
documents with their tokens shuffled, and a swap to the same corpus
against a chain that never swapped. It writes what each rank saw to
OUT_DIR/state_<scheme>_<RANK>.npz and imports neither JAX nor the JAX
package.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ldagroupedgibbssampler_tpu_torch.corpus.ragged import Corpus  # noqa: E402
from ldagroupedgibbssampler_tpu_torch.models.registry import (  # noqa: E402
    _SHARDED_SCHEMES, create_model)
from ldagroupedgibbssampler_tpu_torch.parallel import (  # noqa: E402
    distributed_initialize)
from torch_parallel_worker import config, planted_corpus  # noqa: E402

ITERS = 3
FOLD_IN_ITERS = 6


def shuffled(corpus: Corpus) -> Corpus:
    """The same documents with each document's tokens drawn anew from the
    corpus's tokens (a Geweke replication's new words)."""
    rng = np.random.default_rng(5)
    return dataclasses.replace(corpus,
                               tokens=rng.permutation(corpus.tokens))


def local_state(model, prefix: str) -> dict:
    """This rank's state tensors, as numpy."""
    out = {}
    for f in dataclasses.fields(model.state):
        v = getattr(model.state, f.name)
        if isinstance(v, torch.Tensor):
            out[f"{prefix}{f.name}"] = v.numpy()
        elif v is not None:
            out[f"{prefix}{f.name}"] = np.asarray(v)
    return out


def whole(model, prefix: str) -> dict:
    """The gathered z and the merged counts."""
    return {f"{prefix}z": model.get_z_indicators(),
            f"{prefix}nkw": model.get_topic_type_counts(),
            f"{prefix}ndk": model.get_document_topic_matrix(),
            f"{prefix}nk": model.get_tokens_per_topic()}


def run_scheme(scheme, corpus, out_dir, rank):
    def chain(iters=ITERS, **kw):
        m = create_model(config(scheme, **kw)).add_instances(corpus)
        m.sample(iters)
        return m

    out = {}
    # checkpoint: rank 0 writes, every rank reads
    m = chain()
    path = os.path.join(out_dir, f"ckpt_{scheme}.npz")
    m.save_checkpoint(path)
    out.update(local_state(m, "saved_"))
    loaded = create_model(config(scheme, paranoid=True)).add_instances(
        corpus)
    loaded.load_checkpoint(path)
    out.update(local_state(loaded, "loaded_"))
    loaded.sample(1)
    out.update(whole(loaded, "next_"))
    # fold-in: the whole corpus's counts, and the chain goes on from them
    m = chain(paranoid=True)
    phi = m.state.phi.clone()
    m.sample_z_given_phi(FOLD_IN_ITERS)
    out.update(whole(m, "foldin_"))
    out["foldin_theta"] = m.get_fold_in_theta()
    out["foldin_phi_kept"] = torch.equal(m.state.phi, phi)
    m.sample(1)
    out.update(whole(m, "foldin_next_"))
    # swap to new words: latents kept, counts rebuilt
    m = chain()
    out.update(whole(m, "preswap_"))
    out["preswap_phi"] = m.state.phi.numpy().copy()
    if m.state.theta is not None:     # the whole corpus's GGS theta
        out["preswap_theta"] = m._docs_whole(m.state.theta).numpy().copy()
    m.swap_corpus_tokens(shuffled(corpus))
    out.update(whole(m, "swap_"))
    out["swap_phi"] = m.state.phi.numpy()
    if m.state.theta is not None:
        out["swap_theta"] = m._docs_whole(m.state.theta).numpy()
    # swap to the same words: the chain is the one that never swapped
    m = chain()
    m.swap_corpus_tokens(corpus)
    m.sample(1)
    out.update(whole(m, "sameswap_"))
    out["sameswap_phi"] = m.state.phi.numpy()
    m = chain(ITERS + 1)
    out.update(whole(m, "straight_"))
    out["straight_phi"] = m.state.phi.numpy()
    np.savez(os.path.join(out_dir, f"state_{scheme}_{rank}.npz"), **out)


def main():
    port, rank, world, out_dir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    distributed_initialize(f"127.0.0.1:{port}", num_processes=world,
                           process_id=rank, device="cpu", timeout_s=120)
    corpus = planted_corpus()
    for scheme in _SHARDED_SCHEMES:
        run_scheme(scheme, corpus, out_dir, rank)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
