"""The fused chain-step kernel on the card: one step against cuBLAS's
product and the chain-tail kernel, 8 steps on the benchmark check's input
against the plain chain, the launch count, and out's surroundings. Skips
without a card; on one:

    python -m pytest tests/test_torch_chain_step_card.py -m card -q
"""

import pytest
import torch

from portbench.checks import matmul_chain
from tpufd_torch import chain_step, chain_tail, health


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this host has none")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("size", [4096, 1000])
def test_one_step_differs_from_cublas_and_the_tail_only_through_p(card,
                                                                  size):
    """At the probe's size and at a multiple of 8 that is not one of the
    kernel's tiles: every element equals the chain tail of cuBLAS's bf16
    product p or of p one ulp away, the only difference the order in which
    the product is summed."""
    import chip_smoke

    gen = torch.Generator(device=card).manual_seed(size)
    x = chip_smoke.chain_step_input(size, gen)
    chip_smoke.check_chain_step(x)


@pytest.mark.card
def test_eight_steps_stay_in_the_checks_sound_range(card):
    """8 fused steps on the check's diag(d) + E input against the plain
    chain, seeds 1-24: chain_gap at most 0.02 (the sound range read
    0.0046-0.0149 with cuBLAS and the tail; the check's limit is 0.06)."""
    spec = {"size": 4096, "steps": 8}
    gaps = [matmul_chain.run(spec, seed, card,
                             health._matmul_chain)["chain_gap"]
            for seed in range(1, 25)]
    assert max(gaps) <= 0.02, gaps


@pytest.mark.card
@pytest.mark.parametrize("steps", [1, 2, 5])
def test_launches_count_one_per_step(card, steps):
    x = torch.full((4096, 4096), 0.00025, dtype=torch.bfloat16, device=card)
    chain_step.launches = 0
    tails = chain_tail.launches
    assert health._matmul_chain(x, steps) is x
    torch.cuda.synchronize(card)
    assert chain_step.launches == steps
    assert chain_tail.launches == tails


@pytest.mark.card
@pytest.mark.parametrize("size", [1000, 136, 8])
def test_out_is_written_and_nothing_around_it(card, size):
    import chip_smoke

    gen = torch.Generator(device=card).manual_seed(3)
    chip_smoke.chain_step_canary(size, gen)
