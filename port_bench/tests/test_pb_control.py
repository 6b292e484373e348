"""The comparison's control comes out not correct: the reference in the
program's place, computed in TF32, the precision below float32."""

import pytest
import torch

from conftest import TINY_TRAFFIC, tiny
from port_bench import control, harness

CELLS = ["a2_16x16_m1024.batch256", "a2_32x32_m4096.batch32",
         "a2_16x16_m1024.single"]
SEEDS = [2**31 + 101, 2**31 + 211, 2**31 + 307]


@pytest.mark.parametrize("kind", ["batch", "single"])
def test_reference_in_tf32_is_refused_at_a_tiny_size(kind):
    traffic = TINY_TRAFFIC[kind]
    e2e = [{"name": "setup_s", "unit": "s"}]
    with control.control("reference", traffic):
        result, compared = harness.run_cell(
            tiny(), traffic, e2e, [], 2**31 + 5, 0.05, False,
            torch.device("cpu"), 0.0)
    (value, limit), = compared.values()
    assert result["correct"] is False and value > limit
    assert value < -40.0          # TF32 rounding, not a broken answer


def test_k4_tf32_product_rounds_its_operands():
    from twoace_tpu_torch.ops.cplx import Pair
    from twoace_tpu_torch.ops.kernels import pair_matmul_plain

    g = torch.Generator().manual_seed(3)
    a = Pair(*(torch.randn(2, 8, 64, generator=g) for _ in range(2)))
    b = Pair(*(torch.randn(2, 64, 4, generator=g) for _ in range(2)))
    got = control.pair_matmul_tf32(a, b)
    want = pair_matmul_plain(a, b)
    rel = max(float((g_ - w).abs().max() / w.abs().max())
              for g_, w in zip(got, want))
    assert 1e-5 < rel < 1e-2       # TF32's 2^-11, not float32's 2^-24


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_reference_in_tf32_is_refused_on_the_card(cell, cuda):
    for seed in SEEDS:
        result, compared = control.run(cell, "reference", seed, 1.0, cuda)
        (value, limit), = compared.values()
        assert result["correct"] is False and value > limit, (seed, value)
