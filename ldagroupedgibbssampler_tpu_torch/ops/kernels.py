"""The serial collapsed Gibbs sweep, in plain PyTorch.

The port's copy of `ldagroupedgibbssampler_tpu/ops/kernels.py::
cgs_serial_sweep`, which the JAX package runs as an XLA `lax.scan` (no
Pallas kernel): the correctness oracle of the collapsed samplers
(SerialCollapsedLDA.java:159-172 / ModifiedSimpleLDA.java:158-226).
`doc_sequential_sweep`, the JAX package's off-TPU sweep, has no
counterpart: every port scheme runs its sweep kernel instead, and its last
user without a kernel is the multi-chip `sharded_adlda` (ROADMAP item 17).
"""

from __future__ import annotations

import torch


def cgs_serial_sweep(w, doc_ids, mask, z, ndk, nkw, nk, alpha, beta,
                     generator=None, u=None):
    """Fully serial collapsed Gibbs sweep over every token, in corpus order.

    The exact Griffiths & Steyvers chain: for each token i with mask[i],
    its own assignment is removed from the counts, then
    score_k = (alpha_k + n_dk) (beta + N_kw) / (V beta + n_k) in f32,
    z = argmax(cumsum(score) > u_i * sum(score)) (topic 0 if no entry
    exceeds it, as the JAX argmax gives), and the counts take the new
    assignment. Tokens with mask False keep z and touch no count.

    w, doc_ids: int [N]; mask: bool [N]; z: int32 [N]; ndk int32 [D, K];
    nkw int32 [K, V]; nk int32 [K]; alpha f32 [K]; beta float (taken in
    f32, as the JAX package holds it). `u`: optional f32 [N] uniforms in
    [0, 1), else drawn from `generator` on z's device.

    One Python step per token on z's device: the oracle, for test sizes
    and small slices, not a path. Returns new (ndk, nkw, nk, z).
    """
    dev = z.device
    n = w.shape[0]
    num_topics, num_types = nkw.shape
    if u is None:
        u = torch.rand(n, generator=generator, device=dev)
    f32 = torch.float32
    beta32 = torch.tensor(beta, dtype=f32, device=dev)
    beta_v = beta32 * num_types
    alpha = alpha.to(f32)
    # f32 copies of the counts (integers below 2^24, so exact), N_kw as
    # [V, K] rows; own[k] is the one-hot row that takes a token out of them
    ndk_f, nkw_f, nk_f = ndk.to(f32), nkw.T.to(f32), nk.to(f32)
    own = torch.eye(num_topics, dtype=f32, device=dev)
    z_out = z.clone()
    u = u.to(f32)
    for i, (wt, dt, mt, zt) in enumerate(zip(w.tolist(), doc_ids.tolist(),
                                             mask.tolist(), z.tolist())):
        if not mt:
            continue
        nd, nw, e = ndk_f[dt], nkw_f[wt], own[zt]
        scores = ((alpha + (nd - e)) * (beta32 + (nw - e))
                  / (beta_v + (nk_f - e)))
        cdf = torch.cumsum(scores, 0)
        # first k with cdf_k > u * sum (cdf is non-decreasing); none: 0
        z_new = int(torch.searchsorted(cdf, u[i] * scores.sum(), right=True))
        z_new = 0 if z_new == num_topics else z_new
        if z_new != zt:
            move = own[z_new] - e
            nd += move
            nw += move
            nk_f += move
            z_out[i] = z_new
    i32 = torch.int32
    return ndk_f.to(i32), nkw_f.T.to(i32), nk_f.to(i32), z_out
