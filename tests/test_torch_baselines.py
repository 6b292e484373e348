"""The port's sparse and lifted baselines (``ops/omp.py``, ``gamp.py``,
``phaselift.py``, ``twostage.py``, ``cpr_baselines.py`` and
``dispatch.recover_sparse``) against the JAX package's, on the same numpy
inputs, at complex128 (the conftest enables x64).

Tolerance: 1e-8 of the largest entry, after a global phase alignment
where the answer's gauge is free (an eigenvector's phase, and everything
computed from it).  The baselines draw nothing, so no draws are handed
over.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from twoace_tpu import config as jcfg
from twoace_tpu.ops import cpr_baselines as jcpr
from twoace_tpu.ops import dispatch as jdisp
from twoace_tpu.ops import omp as jomp
from twoace_tpu.ops import phaselift as jpl
from twoace_tpu.ops import twostage as jts
from twoace_tpu_torch import config as tcfg
from twoace_tpu_torch.ops import cpr_baselines as tcpr
from twoace_tpu_torch.ops import dispatch as tdisp
from twoace_tpu_torch.ops import gamp as tgamp
from twoace_tpu_torch.ops import omp as tomp
from twoace_tpu_torch.ops import phaselift as tpl
from twoace_tpu_torch.ops import twostage as tts

# the JAX package exports the function under the module's name
jgamp = importlib.import_module("twoace_tpu.ops.gamp")

RTOL = 1e-8
PL_J = jcfg.PhaseLiftConfig(max_iters=60)
PL_T = tcfg.PhaseLiftConfig(max_iters=60)
TS_J = jcfg.TwoStageConfig(phaselift=PL_J)
TS_T = tcfg.TwoStageConfig(phaselift=PL_T)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, align=False):
    g, w = _np(got), _np(want)
    if align:
        inner = np.vdot(g.reshape(-1), w.reshape(-1))
        g = g * np.exp(1j * np.angle(inner))
    scale = max(np.abs(w).max(), 1e-300)
    assert np.abs(g - w).max() <= rtol * scale, \
        f"max diff {np.abs(g - w).max():.3e} vs scale {scale:.3e}"


def _problem(seed, m, n, s, noise=0.01):
    """A complex (m, n) matrix, an s-sparse z and y = A z + noise."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))) / np.sqrt(2 * m)
    z = np.zeros(n, complex)
    z[rng.choice(n, s, replace=False)] = rng.normal(size=s) + 1j * rng.normal(size=s)
    y = a @ z + noise * (rng.normal(size=m) + 1j * rng.normal(size=m))
    return a, z, y


@pytest.mark.parametrize("m,n,steps", [(12, 20, 4), (6, 20, 9), (16, 10, 3)])
def test_omp_matches_jax(m, n, steps):
    """Fixed min(max_steps, m, n) trips, masked normal-equation solves,
    first index on ties; (6, 20, 9) runs m trips."""
    a, _, y = _problem(0, m, n, 3)
    _close(tomp.omp(torch.tensor(a), torch.tensor(y), steps),
           jomp.omp(jnp.asarray(a), jnp.asarray(y), max_steps=steps))


def test_omp_freezes_once_the_residual_vanishes():
    """An exactly 2-sparse y: the support stops growing after two picks,
    as in JAX, though four trips run."""
    a, z, _ = _problem(2, 12, 20, 2)
    y = a @ z
    got = tomp.omp(torch.tensor(a), torch.tensor(y), 4)
    _close(got, jomp.omp(jnp.asarray(a), jnp.asarray(y), max_steps=4))
    assert int((got.abs() > 0).sum()) == 2
    _close(got, z, rtol=1e-10)


@pytest.mark.parametrize("learn,adaptive", [(True, False), (False, True),
                                            (True, True)])
def test_gamp_awgn_matches_jax(learn, adaptive):
    a, _, y = _problem(2, 24, 40, 3)
    kw = dict(lam0=3 / 40, psi0=1e-3, iters=200, learn_lambda=learn,
              adaptive_damping=adaptive)
    got = tgamp.gamp(torch.tensor(a), torch.tensor(y), **kw)
    want = jgamp.gamp(jnp.asarray(a), jnp.asarray(y), **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_gamp_magnitude_output_matches_jax():
    a, _, y = _problem(3, 30, 20, 2)
    x0 = np.random.default_rng(4).normal(size=20) * (1 + 0.5j)
    kw = dict(lam0=0.1, psi0=1e-3, iters=50, output="magnitude")
    got = tgamp.gamp(torch.tensor(a), torch.tensor(np.abs(y)),
                     x0=torch.tensor(x0), **kw)
    want = jgamp.gamp(jnp.asarray(a), jnp.asarray(np.abs(y)),
                      x0=jnp.asarray(x0), **kw)
    for g, w in zip(got, want):
        if g is got.tau_x:
            # tau_x = pi (nu + |gamma|^2) - |x_hat|^2 cancels to ~1e-11 here:
            # held against the scale of the terms it is the difference of
            assert np.abs(_np(g) - _np(w)).max() <= RTOL * float(
                np.abs(_np(want.x)).max() ** 2)
        else:
            _close(g, w)


@pytest.mark.parametrize("snr_db,learn", [(20.0, True), (0.0, False)])
def test_embgamp_matches_jax(snr_db, learn):
    a, _, y = _problem(5, 24, 40, 3)
    _close(tgamp.embgamp(torch.tensor(y), torch.tensor(a), snr_db, 3 / 40,
                         learn_lambda=learn),
           jgamp.embgamp(jnp.asarray(y), jnp.asarray(a), snr_db, 3 / 40,
                         learn_lambda=learn))


def _intensities(seed, m, n):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))) / np.sqrt(2 * n)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    return a, np.abs(a @ x) ** 2, x


def test_phaselift_fista_matches_jax():
    """60 trips of the lifted FISTA (an eigh each): the PSD iterate and
    the objective agree; the extracted vector after phase alignment."""
    a, b, _ = _intensities(6, 40, 8)
    got = tpl.phaselift_fista(torch.tensor(a), torch.tensor(b), PL_T)
    want = jpl.phaselift_fista(jnp.asarray(a), jnp.asarray(b), PL_J)
    _close(got.lifted, want.lifted)
    _close(got.objective, want.objective)
    _close(got.x, want.x, align=True)


def test_phaselift_bm_batched_matches_jax_per_instance():
    """The factored PhaseLift batched over three instances against JAX's,
    one instance at a time (JAX vmaps it), for 40 trips.  V's column
    phases are free (the spectral init's eigenvectors); V V^H, the loss
    and x up to a global phase are not.  The normalised-step descent
    amplifies rounding about 1e3-fold every 40 trips (measured at
    float64, JAX against the port), so longer runs are held by what they
    recover (next test), not trip for trip."""
    cfg_j = jcfg.PhaseLiftConfig(max_iters=40, bm_rank=3)
    cfg_t = tcfg.PhaseLiftConfig(max_iters=40, bm_rank=3)
    probs = [_intensities(7 + i, 48, 8) for i in range(3)]
    a = np.stack([p[0] for p in probs])
    b = np.stack([p[1] for p in probs])
    got = tpl.phaselift_bm(None, torch.tensor(a), torch.tensor(b), cfg_t)
    for i in range(3):
        want = jpl.phaselift_bm(None, jnp.asarray(a[i]), jnp.asarray(b[i]),
                                cfg_j)
        _close(got.lifted[i], want.lifted)
        _close(got.objective[i], want.objective)
        _close(got.x[i], want.x, align=True)


def test_phaselift_bm_full_run_recovers_as_jax_does():
    """The default 4000 trips: the port and JAX both recover x (NMSE
    -36 to -48 dB measured for these instances; held at -30 dB)."""
    probs = [_intensities(7 + i, 48, 8) for i in range(3)]
    a = np.stack([p[0] for p in probs])
    b = np.stack([p[1] for p in probs])
    got = tpl.phaselift_bm(None, torch.tensor(a), torch.tensor(b)).x.numpy()
    for i, (_, _, x) in enumerate(probs):
        want = np.asarray(jpl.phaselift_bm(None, jnp.asarray(a[i]),
                                           jnp.asarray(b[i])).x)
        for est in (got[i], want):
            c = np.vdot(est, x) / np.vdot(est, est)
            err = np.linalg.norm(x - c * est) ** 2 / np.linalg.norm(x) ** 2
            assert 10 * np.log10(err) <= -30.0


def test_mcs_rules_match_jax_exactly():
    """adaptive_mcs and static_mcs give JAX's integer: from the same
    singular values, and from each package's own SVD of the same matrix
    at the headline Vs_M shapes' ratios."""
    rng = np.random.default_rng(9)
    for m, n, s in ((4, 2401, 3), (36, 2401, 3), (121, 300, 3), (50, 60, 2),
                    (30, 30, 1)):
        sv = np.sort(rng.gamma(2.0, size=min(m, n)))[::-1]
        assert tts.adaptive_mcs(sv, m, n, s, TS_T) == \
            jts.adaptive_mcs(sv, m, n, s, TS_J)
        assert tts.static_mcs(m, n, s, TS_T) == jts.static_mcs(m, n, s, TS_J)
    for m, n in ((4, 96), (20, 96), (48, 96)):
        a, _, _ = _problem(10 + m, m, n, 3)
        sv_t = torch.linalg.svdvals(torch.tensor(a)).numpy()
        sv_j = np.asarray(jnp.linalg.svd(jnp.asarray(a), compute_uv=False))
        assert tts.adaptive_mcs(sv_t, m, n, 3, TS_T) == \
            jts.adaptive_mcs(sv_j, m, n, 3, TS_J)


@pytest.mark.parametrize("noise_power", [1e-2, 1.0])
def test_two_stage_recovery_matches_jax(noise_power):
    """PLOMP and PLGAMP (with the GAMP -> OMP gate) and the stage-1
    vector, up to the global phase the stage-1 eigenvector leaves free;
    the same mCS."""
    a, _, y = _problem(11, 20, 48, 2)
    b2 = np.abs(y) ** 2
    got = tts.two_stage_recovery(torch.tensor(b2), torch.tensor(a), 2,
                                 noise_power, TS_T)
    mcs = jts.adaptive_mcs(np.asarray(jnp.linalg.svd(
        jnp.asarray(a), compute_uv=False)), 20, 48, 2, TS_J)
    want = jts.two_stage_recovery(jnp.asarray(b2), jnp.asarray(a), 2,
                                  noise_power, TS_J)
    assert got.mcs == mcs
    _close(got.compressed, want.compressed, align=True)
    # one phase for all three: they share the stage-1 gauge
    phase = np.exp(1j * np.angle(np.vdot(_np(got.compressed),
                                         _np(want.compressed))))
    for g, w in ((got.plomp, want.plomp), (got.plgamp, want.plgamp)):
        _close(_np(g) * phase, w)


def test_forced_gamp_collapse_takes_the_omp_answer(monkeypatch):
    """PLGAMP and conventional CS keep GAMP's answer unless it is
    non-finite or collapsed to the zero fixed point: forced to either,
    they answer the OMP solve."""
    a, _, y = _problem(12, 20, 48, 2)
    at, b2 = torch.tensor(a), torch.tensor(np.abs(y) ** 2)
    for bad in (lambda x: torch.zeros_like(x),
                lambda x: torch.full_like(x, float("nan"))):
        def collapsed(y_, a_, *args, _bad=bad, **kw):
            return _bad(torch.zeros(a_.shape[1], dtype=a_.dtype))

        monkeypatch.setattr(tts, "embgamp", collapsed)
        monkeypatch.setattr(tcpr, "embgamp", collapsed)
        ts = tts.two_stage_recovery(b2, at, 2, 1e-2, TS_T)
        assert torch.equal(ts.plgamp, ts.plomp)
        got = tcpr.conventional_cs(torch.tensor(y), at, 2, 1e-4)
        assert torch.equal(got, tomp.omp(at, torch.tensor(y), 2))
    monkeypatch.undo()
    ts = tts.two_stage_recovery(b2, at, 2, 1e-2, TS_T)
    assert not torch.equal(ts.plgamp, ts.plomp)   # a healthy GAMP is kept


@pytest.mark.parametrize("phase", ["perfect", "noisy", "omp"])
def test_conventional_cs_matches_jax(phase):
    a, _, y = _problem(13, 24, 48, 2)
    if phase == "noisy":
        rng = np.random.default_rng(14)
        y = y * (rng.normal(size=24) + 1j * rng.normal(size=24)) / np.sqrt(2)
    use_gamp = phase != "omp"
    _close(tcpr.conventional_cs(torch.tensor(y), torch.tensor(a), 2, 1e-2,
                                use_gamp),
           jcpr.conventional_cs(jnp.asarray(y), jnp.asarray(a), 2, 1e-2,
                                use_gamp))


def test_recover_sparse_matches_jax_and_refuses_unported_methods():
    a, _, y = _problem(15, 20, 48, 2)
    rng = np.random.default_rng(16)
    noisy = y * (rng.normal(size=20) + 1j * rng.normal(size=20)) / np.sqrt(2)
    b2 = np.abs(y) ** 2
    flags_j = jcfg.MethodFlags(admm_lowrank_v4=False, plomp=True, plgamp=True)
    flags_t = tcfg.MethodFlags(admm_lowrank_v4=False, plomp=True, plgamp=True)
    got = tdisp.recover_sparse(None, torch.tensor(b2), torch.tensor(a),
                               flags_t, 2, 1e-2, torch.tensor(y),
                               torch.tensor(noisy), ts_cfg=TS_T)
    want = jdisp.recover_sparse(None, jnp.asarray(b2), jnp.asarray(a),
                                flags_j, 2, 1e-2, jnp.asarray(y),
                                jnp.asarray(noisy), ts_cfg=TS_J)
    assert sorted(got) == sorted(want) == [
        "noisy_phase_cs", "perfect_phase_cs", "plgamp", "plomp"]
    for name in ("perfect_phase_cs", "noisy_phase_cs"):
        _close(got[name], want[name])
    phase = np.exp(1j * np.angle(np.vdot(_np(got["plomp"]),
                                         _np(want["plomp"]))))
    for name in ("plomp", "plgamp"):
        _close(_np(got[name]) * phase, want[name])
    for name in ("phaselift", "cprl", "prgamp", "sparse_pl"):
        flags = dataclasses.replace(flags_t, **{name: True})
        with pytest.raises(NotImplementedError, match=name):
            tdisp.recover_sparse(None, torch.tensor(b2), torch.tensor(a),
                                 flags, 2)


def test_recover_sparse_reports_mcs_and_seconds():
    """``info`` receives the two-stage recovery's own compression size and
    the host seconds of each group that ran."""
    a, _, y = _problem(15, 20, 48, 2)
    b2, at = torch.tensor(np.abs(y) ** 2), torch.tensor(a)
    flags = tcfg.MethodFlags(admm_lowrank_v4=False, plomp=True)
    info = {}
    tdisp.recover_sparse(None, b2, at, flags, 2, 1e-2, torch.tensor(y),
                         ts_cfg=TS_T, info=info)
    assert info["mcs"] == tts.two_stage_recovery(b2, at, 2, 1e-2, TS_T).mcs
    assert sorted(info["seconds"]) == ["perfect+noisy CS", "plomp+plgamp"]
    assert all(v > 0 for v in info["seconds"].values())
    info = {}
    tdisp.recover_sparse(None, b2, at, tcfg.MethodFlags(admm_lowrank_v4=False),
                         2, 1e-2, torch.tensor(y), info=info)
    assert "mcs" not in info and sorted(info["seconds"]) == ["perfect+noisy CS"]
