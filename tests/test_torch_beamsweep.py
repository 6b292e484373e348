"""The port's sector-sweep baseline (``twoace_tpu_torch.ops.beamsweep``)
against the JAX package's ``ops/beamsweep.py``, on the CPU, on the same
numpy inputs.

The beam pick is an argmax and agrees exactly.  The angle refinement
scans a 0.05-degree grid with complex64 steering vectors, whose phase the
two packages round in different precisions; its argmax is held to one
grid step.  The random-subset sweeps draw from different streams, so
each package is held to the exact expectation, enumerated over every
subset, within five standard errors of its ``n_runs`` draws.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from twoace_tpu import config as jcfg
from twoace_tpu.ops import beamsweep as jbs
from twoace_tpu.sensing import codebooks as jcb
from twoace_tpu_torch import config as tcfg
from twoace_tpu_torch.ops import beamsweep as tbs

CFG_J, CFG_T = jcfg.ArrayConfig(nt=8, nr=4), tcfg.ArrayConfig(nt=8, nr=4)
STEP = 0.05
AOD, AOA = (-60.0, 60.0), (-50.0, 50.0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _beams(mt=6, mr=5):
    f, w = jcb.directional_beams_angular(mt, mr, CFG_J, AOD, AOA)
    return np.asarray(f), np.asarray(w)


def _channel(seed=0):
    """vec(H) of a two-path 4 x 8 channel (Rx index fastest)."""
    rng = np.random.default_rng(seed)
    h = 0
    for _ in range(2):
        at, ar = rng.uniform(-0.8, 0.8, 2)
        a_t = np.exp(-1j * CFG_J.k_d * np.sin(at) * np.arange(8)) / np.sqrt(8)
        a_r = np.exp(-1j * CFG_J.k_d * np.sin(ar) * np.arange(4)) / np.sqrt(4)
        h = h + (rng.normal() + 1j * rng.normal()) * np.outer(a_r, a_t.conj())
    return h.T.reshape(-1).astype(np.complex64)


def _same_sweep(got, want):
    """The same winning beams (to complex64 rounding: the port builds
    complex64 beams, JAX under x64 complex128) and angles within a step."""
    for g, w in ((got.f_best, want.f_best), (got.w_best, want.w_best)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=1e-6)
    for g, w in ((got.aod_deg, want.aod_deg), (got.aoa_deg, want.aoa_deg)):
        assert abs(float(g) - float(w)) <= STEP + 1e-9


@pytest.mark.parametrize("refine", [True, False])
def test_beam_sweep_matches_jax(refine):
    """The argmax pair of a random power grid (Tx-major) and its refined
    angles; without refinement both angles are 0."""
    f, w = _beams()
    power = np.random.default_rng(1).uniform(size=30)
    got = tbs.beam_sweep(torch.tensor(power), torch.tensor(f),
                         torch.tensor(w), CFG_T, 6, 5, refine=refine)
    want = jbs.beam_sweep(jnp.asarray(power), jnp.asarray(f), jnp.asarray(w),
                          CFG_J, 6, 5, refine=refine)
    _same_sweep(got, want)
    if not refine:
        assert float(got.aod_deg) == float(got.aoa_deg) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sweep_channel_matches_jax_noiseless(seed):
    """SLS end to end on a two-path channel: the powers |w^H H f|^2 to
    float32 rounding (1e-5 of the largest), the same winning pair, the
    refined angles within one step."""
    vec_h = _channel(seed)
    got = tbs.sweep_channel(None, torch.tensor(vec_h), CFG_T, 6, 5, AOD, AOA)
    want = jbs.sweep_channel(None, jnp.asarray(vec_h), CFG_J, 6, 5, AOD, AOA)
    scale = np.abs(_np(want.rss)).max()
    np.testing.assert_allclose(_np(got.rss), _np(want.rss), rtol=0,
                               atol=1e-5 * scale)
    _same_sweep(got, want)


def test_sweep_channel_noise_is_drawn_from_the_generator():
    """At a finite SNR the powers carry exponential noise of mean
    10^(-snr/10) (0.1 at 10 dB: the mean of 256 draws within 30%, five
    standard errors), the same for the same generator seed."""
    vec_h = torch.tensor(_channel(3))
    clean = tbs.sweep_channel(None, vec_h, CFG_T, 16, 16, AOD, AOA).rss

    def noisy(seed):
        return tbs.sweep_channel(torch.Generator().manual_seed(seed), vec_h,
                                 CFG_T, 16, 16, AOD, AOA, snr_db=10.0).rss

    noise = noisy(4) - clean
    assert torch.all(noise >= 0)
    assert float(noise.mean()) == pytest.approx(0.1, rel=0.3)
    assert torch.equal(noisy(4), noisy(4))
    assert not torch.equal(noisy(4), noisy(5))


def _exact_subset_best(rss, m):
    """E[max of the m x m submatrix] over every m-subset, and its standard
    deviation."""
    vals = [rss[np.ix_(s, s)].max()
            for s in itertools.combinations(range(rss.shape[0]), m)]
    return float(np.mean(vals)), float(np.std(vals))


@pytest.mark.parametrize("m", [1, 2, 4, 6])
def test_subset_sweep_rss_matches_the_exact_expectation_as_jax(m):
    """Both packages' Monte-Carlo mean of the best RSS over random m-beam
    subsets of a 6 x 6 grid within five standard errors of the exact
    expectation (m = 6: the grid's maximum, exactly); the port's 4000
    draws come in four chunks."""
    rss = np.random.default_rng(5).uniform(size=(6, 6))
    mean, std = _exact_subset_best(rss, m)
    runs = 4000
    got = float(tbs.subset_sweep_rss(torch.Generator().manual_seed(0),
                                     torch.tensor(rss), m, runs))
    want = float(jbs.subset_sweep_rss(jax.random.PRNGKey(0),
                                      jnp.asarray(rss), m, runs))
    for v in (got, want):
        assert abs(v - mean) <= 5 * std / np.sqrt(runs) + 1e-12
    if m == 6:
        assert got == pytest.approx(rss.max(), rel=1e-12)
        assert want == pytest.approx(rss.max(), rel=1e-12)


def test_aggregate_beamforming_matches_jax():
    """The per-budget table: each method's best repeat (a 2-D entry) or
    its row as given, and the two simulated sweeps, their budgets capped
    at the grid size, each within five standard errors of the exact
    expectation."""
    rng = np.random.default_rng(6)
    rss_bf = {"a2": rng.uniform(size=(3, 3)), "plomp": rng.uniform(size=3)}
    phi, theta = rng.uniform(size=(2, 5, 5))
    m_grid = (2, 3, 9)
    runs = 3000
    got = tbs.aggregate_beamforming(rss_bf, phi, theta, m_grid, None, runs,
                                    device="cpu")
    want = jbs.aggregate_beamforming(rss_bf, phi, theta, m_grid, None, runs)
    assert sorted(got) == sorted(want) == [
        "a2", "plomp", "sweep_phi", "sweep_theta_phi"]
    for name in ("a2", "plomp"):
        np.testing.assert_array_equal(got[name], want[name])
    for name, grid in (("sweep_phi", phi), ("sweep_theta_phi", theta)):
        for i, m in enumerate(m_grid):
            mean, std = _exact_subset_best(grid, min(m, 5))
            for v in (got[name][i], want[name][i]):
                assert abs(v - mean) <= 5 * std / np.sqrt(runs) + 1e-12
