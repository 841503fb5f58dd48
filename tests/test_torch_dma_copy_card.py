"""The DMA-copy kernel on the card: bit-exact against its plain version
at chip_smoke.py's edge cases, its unaligned-launch count, and its time
per repeat flat in n. Skips without a card; on one:

    python -m pytest tests/test_torch_dma_copy_card.py -m card -q
"""

import pytest
import torch

from tpufd_torch import dma_copy, health

PROBE_SHAPE = health._dma_copy_shape(256, 2)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this host has none")
    return torch.device("cuda", 0)


def _bits(t):
    return t.view(torch.int16)


@pytest.mark.card
def test_bit_exact_at_every_edge_case(card):
    import chip_smoke

    plan = dma_copy.launch_plan(*PROBE_SHAPE, 2, card)
    gen = torch.Generator(device=card).manual_seed(7)
    for shape, chunks in chip_smoke.dma_edge_cases(plan):
        x = torch.randint(-32768, 32768, shape, dtype=torch.int16,
                          device=card, generator=gen).view(torch.bfloat16)
        for n in (1, 3):
            got = dma_copy.dma_copy(x, n, chunks)
            want = dma_copy.dma_copy_plain(x, n, chunks)
            assert torch.equal(_bits(got), _bits(want)), (shape, chunks, n)
            assert torch.equal(_bits(got), _bits(x)), (shape, chunks, n)


@pytest.mark.card
def test_only_a_misaligned_pair_counts_unaligned(card):
    """An input one element off its allocation's 16-byte alignment (the
    output is aligned) takes the element-by-element path and counts one;
    the probe's own salted buffers count none."""
    flat = torch.randint(-32768, 32768, (64 * 1024 + 1,), dtype=torch.int16,
                         device=card).view(torch.bfloat16)
    x = flat[1:].view(64, 1024)
    dma_copy.launches = dma_copy.unaligned_launches = 0
    got = dma_copy.dma_copy(x, 2, 2)
    torch.cuda.synchronize(card)
    assert torch.equal(_bits(got), _bits(x))
    assert (dma_copy.launches, dma_copy.unaligned_launches) == (1, 1)

    dma_copy.launches = dma_copy.unaligned_launches = 0
    health._dma_copy_probe_fn(card, 256, 2)(1, health._salt())
    torch.cuda.synchronize(card)
    assert (dma_copy.launches, dma_copy.unaligned_launches) == (1, 0)


@pytest.mark.card
def test_time_per_repeat_is_flat_in_n(card):
    """At the probe's shape, ms per repeat at n 4, 16 and 64 within 1% of
    each other: a repeat served from L2 would run faster than one from
    HBM."""
    import chip_smoke

    x = torch.randn(PROBE_SHAPE, device=card).to(torch.bfloat16)
    dma_copy.dma_copy(x, 1, 2)
    per_repeat = {
        n: min(chip_smoke.cuda_ms(lambda n=n: dma_copy.dma_copy(x, n, 2), 5)
               / n for _ in range(5))
        for n in (4, 16, 64)}
    assert max(per_repeat.values()) / min(per_repeat.values()) < 1.01, \
        per_repeat
