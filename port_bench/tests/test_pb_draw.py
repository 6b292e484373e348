"""The traffic generator: reproducible from the seed, different across
seeds, and measuring what the reference says."""

import pytest
import torch

from conftest import tiny
from port_bench import draw, reference

CPU = torch.device("cpu")
TRAFFIC = {"paths": 2, "angle_rad": 1.2}


def drawn(seed, index=0, count=3, config=None):
    config = config or tiny()
    cb = draw.codebook(config, seed, CPU)
    return cb, draw.channel_batch(config, TRAFFIC, cb, seed, index, count)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 3 * 2**40 + 5, -5])
def test_same_seed_same_draws(seed):
    cb1, d1 = drawn(seed)
    cb2, d2 = drawn(seed)
    assert torch.equal(cb1.a, cb2.a)
    assert torch.equal(d1.b, d2.b) and torch.equal(d1.h, d2.h)


def test_seeds_and_calls_differ():
    cb1, d1 = drawn(2**31 + 11)
    cb2, d2 = drawn(2**31 + 12)
    _, d3 = drawn(2**31 + 11, index=1)
    _, d4 = drawn(-(2**31 + 11))
    assert not torch.equal(cb1.a, cb2.a)
    assert not torch.equal(d1.h, d2.h)
    assert not torch.equal(d1.h, d3.h)
    assert not torch.equal(d1.h, d4.h)
    assert draw.stream_seed(5, draw.SOLVER, 0) != draw.stream_seed(
        5, draw.SOLVER, 1)


def test_call_draws_do_not_depend_on_order():
    cb, d1 = drawn(99, index=4)
    d0 = draw.channel_batch(tiny(), TRAFFIC, cb, 99, 3, 3)
    d1b = draw.channel_batch(tiny(), TRAFFIC, cb, 99, 4, 3)
    assert not torch.equal(d0.h, d1.h)
    assert torch.equal(d1.h, d1b.h)


def test_codebook_and_magnitudes():
    config = tiny()
    cb, d = drawn(3, config=config)
    n = config["nt"] * config["nr"]
    assert cb.a.shape == (config["m"], n)
    torch.testing.assert_close(cb.a.abs(), torch.full_like(cb.a.abs(),
                                                           n ** -0.5))
    levels = torch.round(torch.angle(cb.a) / (torch.pi / 2)) % 4
    assert set(levels.unique().tolist()) <= {0.0, 1.0, 2.0, 3.0}
    torch.testing.assert_close(d.b.double(), (d.h @ cb.a.T).abs(),
                               rtol=1e-6, atol=1e-7)
    assert d.b.dtype == torch.float32 and d.b.shape == (3, config["m"])
    torch.testing.assert_close(
        reference.channels(d.aoa, d.aod, d.gain, config["nt"], config["nr"]),
        d.h)


def test_channel_layout_is_vec_of_columns():
    """vec(H) stacks H's columns, H = sum_l g a_r(aoa) a_t(aod)^H."""
    aoa = torch.tensor([[0.3]], dtype=torch.float64)
    aod = torch.tensor([[-0.7]], dtype=torch.float64)
    g = torch.tensor([[1.5 - 0.5j]], dtype=torch.complex128)
    nt, nr = 3, 2
    x = reference.channels(aoa, aod, g, nt, nr)[0]
    ar = reference.steering(nr, aoa[0, 0])
    at = reference.steering(nt, aod[0, 0])
    h = g[0, 0] * torch.outer(ar, at.conj())                 # (nr, nt)
    torch.testing.assert_close(x, h.T.reshape(-1))
