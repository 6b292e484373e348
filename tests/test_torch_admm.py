"""The port's complex-dtype solver family (``twoace_tpu_torch.ops.admm``,
``ops.dispatch``) against the JAX package's and the MATLAB-transcript
goldens, at complex128 on the CPU (K5 runs its plain version there).

- ``infer_admm`` from the same x0 and U as JAX: both ``scale_by_row``
  forms of the spectral-profile prox, the nuclear prox and the prox-free
  (inferMinL2) loop, to 1e-9 of the largest entry after up to 120 trips.
  JAX's prox runs its LAPACK eigh (``eig_backend="xla"``, one compile
  instead of a Jacobi sweep schedule per shape); the two packages then
  differ only in rounding, which the loop carries from trip to trip.
- ``infer_admm`` against the golden InferADMM trajectory ``ia_*`` at 1e-6
  (the oracle's own tolerance, ``test_golden_matlab.py``).
- Whole solves against the golden full scaffold ``full_*`` (8x8, m 256):
  below -60 dB and quality within 5e-3, as JAX is held there.  The random
  streams differ (torch generators, not JAX keys), so whole solves are
  compared on converged NMSE and quality.  JAX's own whole solves are
  compiled once per shape and configuration (about 10-30 s each on the
  CPU), so the version dispatch is held against the ground truth and
  against JAX's ``solve_minl2`` only; ``test_torch_campaign.py`` holds
  the A2 solver against JAX's through the campaign.
- Padded b = 0 rows give the unpadded answer.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nmse_db, steer
from twoace_tpu.config import AdmmConfig as JAdmm
from twoace_tpu.ops import admm as ja
from twoace_tpu.ops import prox as jp
from twoace_tpu_torch.config import AdmmConfig
from twoace_tpu_torch.ops import admm as ta
from twoace_tpu_torch.ops import dispatch as td
from twoace_tpu_torch.ops import prox as tp

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_v1.npz")
NT = NR = 4
N = NT * NR


@pytest.fixture(scope="module")
def g():
    return dict(np.load(GOLDEN))


def _channel(rng, paths=2):
    return sum((rng.normal() + 1j * rng.normal())
               * np.outer(steer(NR, rng.uniform(-1.2, 1.2)),
                          steer(NT, rng.uniform(-1.2, 1.2)).conj())
               .T.reshape(-1) for _ in range(paths))


def _problem(seed=0, m=48):
    rng = np.random.default_rng(seed)
    a = np.exp(1j * rng.integers(0, 4, (m, N)) * (np.pi / 2)) / np.sqrt(N)
    x = _channel(rng)
    return a, np.abs(a @ x), x


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("case", ["row_spectral", "col_spectral",
                                  "row_nuclear", "row_minl2", "col_minl2"])
def test_infer_admm_matches_jax(case):
    a, b, _ = _problem(1)
    m = a.shape[0]
    rng = np.random.default_rng(2)
    x0 = rng.normal(size=(N, 6)) + 1j * rng.normal(size=(N, 6))
    sbr = case.startswith("row")
    if not sbr:
        x0 = np.linalg.qr(x0)[0]
    kind = case.split("_")[1]
    lad = tp.profile_ladder(NT, NR, m, N, False)
    if kind == "spectral":
        jprox = lambda z, mu: jp.spectral_profile_prox(z, NT, NR, lad, "xla")
        tprox = lambda z, mu: tp.spectral_profile_prox(z, NT, NR, lad)
        ju = tu = None
    elif kind == "nuclear":
        jprox = lambda z, mu: jp.nuclear_prox(z, 1.0 / mu, "xla")
        tprox = lambda z, mu: tp.nuclear_prox(z, 1.0 / mu)
        ju = tu = None
    else:
        jprox = tprox = None
        ju, tu = ja._pinv(jnp.asarray(a)), ta._pinv(_t(a))
    kw = dict(scale_by_row=sbr, maxiter=120)
    xj, yj, cj = ja.infer_admm(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(x0), prox=jprox, u_mat=ju, **kw)
    xt, yt, ct = ta.infer_admm(_t(a), _t(b), _t(x0), prox=tprox, u_mat=tu,
                               **kw)
    for got, want in ((xt, xj), (yt, yj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-9 * np.abs(want).max())
    assert bool(ct) == bool(cj)


def test_infer_admm_matches_golden_trajectory(g):
    lad = tp.profile_ladder(4, 4, 64, 16, False)
    before = ta.infer_admm.trips
    x, y, _ = ta.infer_admm(_t(g["ia_a"]), _t(g["ia_b"]), _t(g["ia_xs"]),
                            scale_by_row=True, maxiter=60,
                            prox=lambda z, mu: tp.spectral_profile_prox(
                                z, 4, 4, lad))
    np.testing.assert_allclose(x.numpy(), g["ia_x"], atol=1e-6)
    np.testing.assert_allclose(y.numpy(), g["ia_y"], atol=1e-6)
    assert 0 < ta.infer_admm.trips - before <= 60


def test_full_solver_matches_golden_scaffold(g):
    res = ta.solve_lowrank_multi(torch.Generator().manual_seed(5),
                                 _t(g["full_a"]), _t(g["full_b"]), 8, 8,
                                 AdmmConfig(maxiter=200))
    assert res.x.dtype == torch.complex128 and res.x.shape == (64,)
    assert nmse_db(res.x.numpy(), g["full_xtrue"]) < -60.0
    assert abs(float(res.quality) - float(g["full_quality"])) < 5e-3


def test_x_seed_plants_the_callers_direction():
    """A seed equal to the channel is planted in column 0 of every
    restart's init; the scaffold keeps it (quality 1, the channel)."""
    a, b, x = _problem(8, m=40)
    cfg = AdmmConfig(maxiter=100, n_restarts=1)
    res = ta.solve_lowrank_multi(torch.Generator().manual_seed(0), _t(a),
                                 _t(b), NT, NR, cfg, x_seed=_t(3.0 * x))
    assert nmse_db(res.x.numpy(), x) < -60.0
    assert float(res.quality) > 0.99


def test_minl2_matches_jax():
    a, b, x = _problem(3, m=56)
    cfg = AdmmConfig(maxiter=200)
    rj = ja.solve_minl2(jax.random.PRNGKey(3), jnp.asarray(a), jnp.asarray(b),
                        JAdmm(maxiter=200))
    rt = td.admm_v2(torch.Generator().manual_seed(3), _t(b), _t(a), NT, NR,
                    0, cfg)
    # noiseless, m = 56 > 3n: both recover the channel to their rounding
    # floor (about -200 dB at complex128)
    assert abs(float(rt.quality) - float(rj.quality)) < 1e-6
    assert nmse_db(np.asarray(rj.x), x) < -60.0
    assert nmse_db(rt.x.numpy(), x) < -60.0
    np.testing.assert_allclose(rt.y.numpy(), _t(a).numpy() @ rt.x.numpy(),
                               atol=1e-12)


@pytest.mark.parametrize("version,nuclear,impl", [
    (1, False, "complex"), (2, False, "complex"), (3, False, "complex"),
    (4, False, "complex"), (4, True, "complex"), (4, False, "pair")])
def test_admm_v2_versions_recover_the_channel(version, nuclear, impl):
    a, b, x = _problem(4)
    res = td.admm_v2(torch.Generator().manual_seed(0), _t(b), _t(a), NT, NR,
                     version, AdmmConfig(maxiter=200), nuclear=nuclear,
                     impl=impl)
    assert res.x.shape == (N,) and res.y.shape == (a.shape[0],)
    if nuclear:
        # the single-restart nuclear scaffold finds only the dominant
        # direction here: JAX's own solve reaches -5.8 dB (quality 0.47)
        # and -5.8 dB (0.34) from keys 0 and 1, the port -6.7 dB (0.57)
        # and -5.9 dB (0.84) from seeds 0 and 1
        assert -20.0 < nmse_db(res.x.numpy(), x) < -3.0
        return
    floor = -30.0 if impl == "pair" else -60.0      # float32 pair path
    assert nmse_db(res.x.numpy(), x) < floor
    assert float(res.quality) > 0.999


def test_admm_v2_escalation_runs_once_on_nonzero_quality(monkeypatch):
    """Out-of-range versions run V2 with lambda 5 and width nt; any nonzero
    quality ends the escalation (the reference's quirks)."""
    calls = []
    real = td.solve_lowrank_multi

    def spy(gen, a, b, nt, nr, cfg, **kw):
        calls.append((cfg.lam, cfg.rank, cfg.profile.ladder, kw))
        return real(gen, a, b, nt, nr, cfg, **kw)

    monkeypatch.setattr(td, "solve_lowrank_multi", spy)
    a, b, x = _problem(5)
    res = td.admm_v2(torch.Generator().manual_seed(0), _t(b), _t(a), NT, NR,
                     7, AdmmConfig(maxiter=200))
    assert calls == [(5.0, NT, "v2", {"n_restarts": 1})]
    # the held-out quality of the lambda = 5 restart is low (JAX: 0.35 from
    # key 0 on this problem), but nonzero, and the refine recovers the
    # channel (JAX: -81.5 dB)
    assert float(res.quality) != 0.0
    assert nmse_db(res.x.numpy(), x) < -40.0


def test_padded_rows_give_the_unpadded_answer():
    a, b, _ = _problem(6, m=40)
    pad = 24
    a_p = np.concatenate([a, np.zeros((pad, N))])
    b_p = np.concatenate([b, np.zeros(pad)])
    an, bn, a_norm, b_norm = ta._normalize_problem(_t(a), _t(b), 1e-8)
    apn, bpn, ap_norm, bp_norm = ta._normalize_problem(_t(a_p), _t(b_p), 1e-8)
    torch.testing.assert_close(ap_norm, a_norm, rtol=1e-14, atol=0.0)
    torch.testing.assert_close(bp_norm, b_norm, rtol=1e-14, atol=0.0)
    rng = np.random.default_rng(7)
    x0 = _t(rng.normal(size=(N, 5)) + 1j * rng.normal(size=(N, 5)))
    lad = tp.profile_ladder(NT, NR, 40, N, False)
    prox = lambda z, mu: tp.spectral_profile_prox(z, NT, NR, lad)
    x, y, _ = ta.infer_admm(an, bn, x0, scale_by_row=True, prox=prox,
                            maxiter=80)
    xp, yp, _ = ta.infer_admm(apn, bpn, x0, scale_by_row=True, prox=prox,
                              maxiter=80)
    torch.testing.assert_close(xp, x, rtol=0.0, atol=1e-10)
    torch.testing.assert_close(yp[:40], y, rtol=0.0, atol=1e-10)
    assert float(yp[40:].abs().max()) == 0.0
