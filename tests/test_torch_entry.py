"""The port's entry module against the JAX package's ``__graft_entry__``.

``entry()``'s step runs on the CPU here (each kernel's wrapper takes its
plain version) from the same arrays as JAX's ``entry()``, and is held to
JAX's jitted step; ``dryrun_multichip`` spawns its ranks over gloo.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from twoace_tpu_torch import entry as tentry


@pytest.fixture(scope="module")
def jax_step():
    """JAX's ``entry()``: its example arguments and its jitted step's ten
    outputs, numpy."""
    import jax

    import __graft_entry__ as g

    fn, args = g.entry()
    return ([np.asarray(a) for a in args],
            [np.asarray(o) for o in jax.jit(fn)(*args)])


def test_entry_arguments_are_jax_s(jax_step):
    """The same numpy construction (``default_rng(0)``) gives JAX's
    arguments bit for bit, in JAX's layout."""
    _, args = tentry.entry("cpu")
    assert len(args) == len(jax_step[0]) == 14
    for got, want in zip(args, jax_step[0]):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


def test_entry_step_matches_jax(jax_step):
    """One ADMM iteration against JAX's on the same arrays: each output
    pair within 2e-5 of its largest value (measured 6.1e-6, Z; JAX's
    Z-prox runs 6 Jacobi sweeps from cold, the port's K2 path starts
    from the exact eigenbasis), mu exactly 1.03 times, obj within 1e-5
    relative."""
    fn, args = tentry.entry("cpu")
    got = [o.numpy() for o in fn(*args)]
    want = jax_step[1]
    assert [g.shape for g in got] == [w.shape for w in want]
    for idx in ((0, 1), (2, 3), (4, 5), (6, 7)):
        scale = max(np.abs(want[i]).max() for i in idx)
        for i in idx:
            np.testing.assert_allclose(got[i], want[i], atol=2e-5 * scale)
    assert got[8] == pytest.approx(float(want[8]), rel=1e-7)
    assert got[9] == pytest.approx(float(want[9]), rel=1e-5)


def test_entry_step_is_one_launch_of_each_kernel_s_plain_version():
    """On the CPU the wrappers take their plain versions: no launch is
    counted, and a second step from the first's state keeps going."""
    from twoace_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    fn, args = tentry.entry("cpu")
    reset_launch_counts()
    out = fn(*args)
    assert not any(launch_counts().values())
    again = fn(*args[:5], *out[:8], out[8])
    assert all(bool(torch.isfinite(o).all()) for o in again)
    assert float(again[8]) == pytest.approx(1e-3 * 1.03 ** 2)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU host")
def test_entry_points_raise_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.dryrun_multichip(1)


@pytest.fixture
def one_thread(monkeypatch):
    """One thread a spawned rank: the session's workers share the host's
    cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_dryrun_multichip_on_the_cpu(one_thread):
    """Two ranks over gloo (rows 2): the three sharded solves of
    ``__graft_entry__.dryrun_multichip`` and their checks, on each rank."""
    ranks = tentry.dryrun_multichip(2, "cpu")
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1)]
    assert all(r["shape"] == (1, 2) for r in ranks)


def test_entry_module_main_on_the_cpu(one_thread):
    """``python -m twoace_tpu_torch.entry --device cpu --ranks 1``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tentry.main(["--device", "cpu", "--ranks", "1"])
    out = buf.getvalue()
    assert "entry ok: [(1024, 20), (1024, 20), (256, 20)" in out
    assert "dryrun_multichip(1) ok" in out
