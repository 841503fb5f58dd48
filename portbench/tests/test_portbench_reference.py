"""The plain references against values worked by hand."""

import math

import pytest
import torch

from portbench.reference import chain, copy, labels


def bf16(values):
    return torch.tensor(values, dtype=torch.bfloat16)


def test_one_chain_step_by_hand():
    # a @ a = [[0.25, 0.25], [0, 0.25]]; 0.5 * (tanh(0.25) + 0.5) =
    # 0.3724593 -> bf16 0.373046875; 0.5 * (tanh(0.25) + 0.25) = 0.2474593
    # -> bf16 0.2470703125; 0.5 * (tanh(0) + 0) = 0.
    out = chain.chain(bf16([[0.5, 0.25], [0.0, 0.5]]), 1)
    assert out.tolist() == [[0.373046875, 0.2470703125],
                            [0.0, 0.373046875]]


def test_two_chain_steps_round_the_product_and_the_state():
    # Step 1 as above gives 0.373046875; its square 0.13916397 rounds to
    # bf16 0.1396484375, and 0.5 * (tanh(0.1396484375) + 0.373046875) =
    # 0.2559... rounds to 0.255859375.
    p = 0.1396484375
    expected = 0.5 * (math.tanh(p) + 0.373046875)
    out = chain.chain(bf16([[0.5]]), 2)
    assert out.item() == 0.255859375
    assert abs(out.item() - expected) < 2 ** -9


def test_the_control_stores_the_chain_in_scaled_float8():
    # As in the first test, float32: 0.3724593 and 0.2474593. The scale
    # puts the largest, 0.3724593, on e4m3's 448 exactly; 0.2474593 lands
    # on 297.65, which e4m3 (steps of 32 from 256) stores as 288.
    a = 0.5 * (math.tanh(0.25) + 0.5)
    out = chain.chain(bf16([[0.5, 0.25], [0.0, 0.5]]), 1,
                      torch.float8_e4m3fn)
    assert out.flatten().tolist() == pytest.approx(
        [a, a * 288 / 448, 0.0, a], rel=1e-6)


def test_the_scaled_store_keeps_the_range_where_float8_underflows():
    # 1e-4 is below e4m3's smallest subnormal (2^-9); scaled, it and a
    # tenth of it survive to 3 mantissa bits.
    t = torch.tensor([1e-4, 1e-5])
    assert t.to(torch.float8_e4m3fn).float().tolist() == [0.0, 0.0]
    out = chain.store(t, torch.float8_e4m3fn)
    assert out[0].item() == pytest.approx(1e-4, rel=1e-6)
    assert out[1].item() == pytest.approx(1e-5, rel=2 ** -4)


def test_gap_is_the_widest_gap_over_the_largest_reference_value():
    ref = torch.tensor([[2.0, -4.0]])
    assert chain.gap(torch.tensor([[2.5, -4.0]]), ref) == pytest.approx(
        0.125)
    assert chain.gap(torch.tensor([[2.0]]), ref) == math.inf
    assert chain.gap(torch.tensor([[math.nan, -4.0]]), ref) == math.inf


def test_copy_counts_elements_whose_bits_differ():
    x = bf16([[1.0, -2.0], [0.1, 3.0]])
    assert copy.mismatches(copy.copy(x), x) == 0
    y = x.clone()
    y[1, 0] = 0.2
    assert copy.mismatches(y, x) == 1
    assert copy.mismatches(x[:1], x) == 4
    # Through float8 1.0, -2.0 and 3.0 survive; bf16 0.1 does not.
    assert copy.mismatches(copy.copy(x, torch.float8_e4m3fn), x) == 1


def test_labels_worked_out_from_the_sizes():
    # 2 * 4096^3 * 8 = 1.09951e12 operations; at 1.5 ms, 733.0078 TFLOP/s.
    assert labels.matmul_tflops({"size": 4096}, 8) / 1.5e-3 == (
        pytest.approx(733.0078, abs=1e-4))
    # 256 MiB in 2 chunks is (131072, 1024) bf16: a read and a write of
    # 2^28 bytes a repeat, 16 repeats.
    assert copy.shape(256, 2) == (131072, 1024)
    assert labels.dma_copy_gbps({"mib": 256, "chunks": 2}, 16) == (
        pytest.approx(2 * 2**28 * 16 / 1e9))
    # 1 MiB is 512 rows, cut to a multiple of 3 chunks.
    assert copy.shape(1, 3) == (510, 1024)
    assert labels.hbm_gbps({"mib": 512}, 16) == pytest.approx(
        2 * 2**29 * 16 / 1e9)
