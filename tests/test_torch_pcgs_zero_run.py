"""The PCGS sweep's zero-run tie (ROADMAP C): in the lane kernel of
csrc/pcgs.cu each lane's running sums meet the scan's exclusive offsets in
another association, so where u * total lies between the two values of a
lane boundary, the count could pass into a run of topics whose probability
is 0. The kernel now moves such a draw to the last topic at or below it
with p > 0; chip_smoke.py `[3 pcgs]` holds it on the card to the case found
here. On the CPU: the case's arithmetic, and the plain version, whose
cumsum is monotone, never drawing a zero on it."""

import numpy as np
import pytest
import torch

import chip_smoke


@pytest.fixture(scope="module")
def case():
    return chip_smoke.pcgs_zero_run_case()


def test_the_unrepaired_lane_association_draws_a_zero_topic(case):
    """The seeded search finds products and a u24 on which the lane
    kernel's association, without the repair, counts into a zero run, while
    a left-to-right cumsum draws a topic with p > 0."""
    p = case["phi"]
    z = chip_smoke.lane_kernel_count(p, case["u24"])
    assert z == case["unrepaired"] and p[z] == 0
    cdf = np.cumsum(p, dtype=np.float32)
    u = np.float32(np.float32(case["u24"] * 2.0 ** -24) * cdf[-1])
    assert p[min(int((cdf <= u).sum()), len(p) - 1)] > 0


def test_the_plain_sweep_draws_no_zero_on_the_case():
    """The sweep on the one-token document of the case, on the CPU (the
    plain version), positive support off: the drawn topic has p > 0."""
    case = chip_smoke.pcgs_zero_run_case()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        zk, zr = chip_smoke.pcgs_zero_run_draw(torch, case, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert zk == zr and case["phi"][zk] > 0


def test_the_unrepaired_sweep_kernel_association_draws_a_zero_topic():
    """The same above kpad 256, where the shared-memory sweep kernel sums
    each 32-topic chunk by a Hillis-Steele scan: its count, without the
    repair, lands in the zero run at a chunk's end, while a left-to-right
    cumsum draws a topic with p > 0."""
    case = chip_smoke.pcgs_sweep_zero_run_case()
    assert case["kpad"] > 256
    p = case["phi"]
    z = chip_smoke.sweep_kernel_count(p, case["u24"], case["kpad"])
    assert z == case["unrepaired"] and p[z] == 0
    cdf = np.cumsum(p, dtype=np.float32)
    u = np.float32(np.float32(case["u24"] * 2.0 ** -24) * cdf[-1])
    assert p[min(int((cdf <= u).sum()), len(p) - 1)] > 0


def test_the_plain_sweep_draws_no_zero_on_the_kpad_384_case():
    """The one-token sweep of the K=300 case on the CPU, positive support
    off: the plain version's topic has p > 0."""
    case = chip_smoke.pcgs_sweep_zero_run_case()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        zk, zr = chip_smoke.pcgs_zero_run_draw(torch, case, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert zk == zr and case["phi"][zk] > 0
