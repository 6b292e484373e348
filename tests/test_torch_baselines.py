"""The port's sparse and lifted baselines (``ops/omp.py``, ``gamp.py``,
``phaselift.py``, ``twostage.py``, ``cpr_baselines.py`` and
``dispatch.recover_sparse``) against the JAX package's, on the same numpy
inputs, at complex128 (the conftest enables x64).

Tolerance: 1e-8 of the largest entry, after a global phase alignment
where the answer's gauge is free (an eigenvector's phase, and everything
computed from it).  The baselines draw nothing, so no draws are handed
over, with two exceptions: PRGAMP's spectral initialization starts an
orthogonal iteration from a random block, so the port is handed JAX's
initial vector; and the pair-form Burer-Monteiro PhaseLift, which JAX
runs in float32 from a random start, is held by its result (stated
tolerances in its tests).
"""

import importlib

import jax
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
from torch_parity import jpair, nmse_db, tpair

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


def _jax_spectral_init(monkeypatch):
    """Hand the port's PRGAMP the JAX package's spectral initialization
    (its orthogonal iteration starts from a JAX draw)."""
    from twoace_tpu.ops.spectral_init import spectral_initialize

    def fed(a, b, r, *args, **kw):
        return torch.tensor(np.asarray(spectral_initialize(
            jnp.asarray(_np(a)), jnp.asarray(_np(b)), r)))

    monkeypatch.setattr(tgamp, "spectral_initialize", fed)


def test_recover_sparse_matches_jax_and_refuses_unported_methods(monkeypatch):
    """Every recover_sparse entry against JAX's: the z-domain PhaseLift,
    CPRL, PRGAMP (given JAX's spectral initialization), SparsePL, PLOMP,
    PLGAMP and both CS solves; none raises.  Both dispatchers' CPRL is cut
    to 50 trips: on this 20 x 48 problem its smoothed L1 step
    r / sqrt(r^2 + 1e-6) amplifies rounding once residuals near 0 (the
    port and JAX part by 4e-2 of the largest entry after 100 trips, 2.6e-9
    after 50, measured); its own test holds 100 trips of a milder one."""
    _jax_spectral_init(monkeypatch)
    monkeypatch.setattr(jdisp, "cprl",
                        lambda b, a: jcpr.cprl(b, a, iters=50))
    monkeypatch.setattr(tdisp, "cprl",
                        lambda b, a: tcpr.cprl(b, a, iters=50))
    a, _, y = _problem(15, 20, 48, 2)
    rng = np.random.default_rng(16)
    noisy = y * (rng.normal(size=20) + 1j * rng.normal(size=20)) / np.sqrt(2)
    b2 = np.abs(y) ** 2
    names = ("phaselift", "cprl", "prgamp", "sparse_pl", "plomp", "plgamp")
    flags_j = jcfg.MethodFlags(admm_lowrank_v4=False,
                               **{k: True for k in names})
    flags_t = tcfg.MethodFlags(admm_lowrank_v4=False,
                               **{k: True for k in names})
    got = tdisp.recover_sparse(None, torch.tensor(b2), torch.tensor(a),
                               flags_t, 2, 1e-2, torch.tensor(y),
                               torch.tensor(noisy), pl_cfg=PL_T, ts_cfg=TS_T)
    want = jdisp.recover_sparse(None, jnp.asarray(b2), jnp.asarray(a),
                                flags_j, 2, 1e-2, jnp.asarray(y),
                                jnp.asarray(noisy), pl_cfg=PL_J, ts_cfg=TS_J)
    assert sorted(got) == sorted(want) == sorted(
        names + ("noisy_phase_cs", "perfect_phase_cs"))
    for name in ("perfect_phase_cs", "noisy_phase_cs", "sparse_pl"):
        _close(got[name], want[name], align=name == "sparse_pl")
    for name in ("phaselift", "cprl", "prgamp"):
        _close(got[name], want[name], align=True)
    phase = np.exp(1j * np.angle(np.vdot(_np(got["plomp"]),
                                         _np(want["plomp"]))))
    for name in ("plomp", "plgamp"):
        _close(_np(got[name]) * phase, want[name])


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


@pytest.mark.parametrize("snr_db", [30.0, 5.0])
def test_vamp_matches_jax(snr_db):
    """VAMP and its CS entry: the estimate and the final precision (the
    SVD factors' phases are free, the estimate is not)."""
    a, _, y = _problem(21, 24, 48, 2)
    kw = dict(lam0=2 / 48, phi0=1.0, gamma_w=10.0 ** (snr_db / 10.0),
              iters=50)
    got = tgamp.vamp(torch.tensor(a), torch.tensor(y), **kw)
    want = jgamp.vamp(jnp.asarray(a), jnp.asarray(y), **kw)
    _close(got.x, want.x)
    _close(got.precision, want.precision)
    _close(tgamp.vamp_cs(torch.tensor(y), torch.tensor(a), snr_db, 2 / 48),
           jgamp.vamp_cs(jnp.asarray(y), jnp.asarray(a), snr_db, 2 / 48))


def test_prgamp_matches_jax_given_its_spectral_init(monkeypatch):
    """PRGAMP's 300 trips from JAX's spectral initialization; from the
    port's own start block (its initial vector about 3e-6 from JAX's) the
    answer lies 1.2e-4 of its largest entry from JAX's after phase
    alignment (measured; held at 1e-3)."""
    a, _, y = _problem(22, 30, 20, 2)
    y_mag = np.abs(y)
    own = tgamp.prgamp(torch.tensor(y_mag), torch.tensor(a))
    _jax_spectral_init(monkeypatch)
    got = tgamp.prgamp(torch.tensor(y_mag), torch.tensor(a))
    want = jgamp.prgamp(jnp.asarray(y_mag), jnp.asarray(a))
    _close(got, want)
    _close(own, want, rtol=1e-3, align=True)


def test_cprl_matches_jax():
    """100 trips of CPRL (a soft threshold and a PSD projection each),
    with JAX's float32 trip counter in the step size (1.3e-10 apart
    measured; 7e-7 after the default 500 trips, where the smoothed L1
    step has amplified rounding)."""
    a, _, y = _problem(23, 24, 16, 2)
    b2 = np.abs(y) ** 2
    got = tcpr.cprl(torch.tensor(b2), torch.tensor(a), iters=100)
    want = jcpr.cprl(jnp.asarray(b2), jnp.asarray(a), iters=100)
    assert np.abs(_np(want)).max() > 0
    _close(got, want, align=True)


@pytest.mark.parametrize("s", [1, 3])
def test_lifted_omp_matches_jax(s):
    a, _, y = _problem(24, 20, 6, 1)
    b2 = np.abs(y) ** 2
    want = jcpr.lifted_omp(jnp.asarray(b2), jnp.asarray(a), s)
    assert np.abs(_np(want)).max() > 0
    _close(tcpr.lifted_omp(torch.tensor(b2), torch.tensor(a), s), want,
           align=True)


@pytest.mark.parametrize("keep", [0, 7])
def test_sparse_phaselift_matches_jax(keep):
    """The correlation screen (5% of 48 columns, or 7) and 60 FISTA trips
    on the kept columns; the screen's ties take the lower index."""
    a, _, y = _problem(25, 20, 48, 2)
    a[:, 30] = a[:, 5]                          # two columns score alike
    b2 = np.abs(y) ** 2
    got = tcpr.sparse_phaselift(torch.tensor(b2), torch.tensor(a), keep,
                                PL_T)
    want = jcpr.sparse_phaselift(jnp.asarray(b2), jnp.asarray(a), keep,
                                 PL_J)
    assert np.count_nonzero(_np(got)) == np.count_nonzero(_np(want)) == (
        keep or 3)
    _close(got, want, align=True)


@pytest.mark.parametrize("scale", [0.8, 0.5, 100.0])
def test_unconventional_cs_matches_jax(scale):
    """The bisection on lam in [0, 1]: inside the bracket (scale 0.8, the
    norm lands on 1), pinned at lam = 0 (0.5: the norm is below 1
    already) and at lam = 1 (100: above 1 still)."""
    rng = np.random.default_rng(26)
    f = rng.normal(size=(8, 12)) + 1j * rng.normal(size=(8, 12))
    b = (rng.normal(size=12) + 1j * rng.normal(size=12)) * scale
    got = tcpr.unconventional_cs(torch.tensor(b), torch.tensor(f))
    want = jcpr.unconventional_cs(jnp.asarray(b), jnp.asarray(f))
    _close(got, want)
    if scale == 0.8:
        assert np.linalg.norm(_np(got)) == pytest.approx(1.0, abs=1e-9)


def _bm_pair_problem():
    """A float32 problem whose leading eigenvalue of A^H diag(b) A stands
    clear: 48 Gaussian rows, n = 8, b = |A x|^2."""
    a, b, x = _intensities(27, 48, 8)
    return a.astype(np.complex64), b.astype(np.float32), x


@pytest.mark.parametrize("rank", [1, 8])
def test_phaselift_bm_pair_matches_jax_after_a_few_trips(rank):
    """The pair-form solver's spectral start and its first 5 trips: the
    objective and the phase-aligned estimate within 5e-3 of JAX's.  JAX
    starts from a float32 orthogonal iteration and a Jacobi eigh on the
    real embedding (its start lies about 3e-4 from the exact one, measured
    at both ranks); the momentum descent amplifies that difference, to
    about 0.1 after 20 trips at rank 1, so the iterates are held here and
    the converged result in the next test."""
    a, b, _ = _bm_pair_problem()
    cfg_j = jcfg.PhaseLiftConfig(max_iters=5, bm_rank=rank)
    cfg_t = tcfg.PhaseLiftConfig(max_iters=5, bm_rank=rank)
    got = tpl.phaselift_bm_pair(None, tpair(a), torch.tensor(b), cfg_t)
    want = jpl.phaselift_bm_pair(jax.random.PRNGKey(0), jpair(a),
                                 jnp.asarray(b), cfg_j)
    assert got.x_re.dtype == torch.float32
    _close(_np(got.x_re) + 1j * _np(got.x_im),
           np.asarray(want.x_re) + 1j * np.asarray(want.x_im), rtol=5e-3,
           align=True)
    assert float(got.objective) == pytest.approx(float(want.objective),
                                                 rel=5e-3)


def test_phaselift_bm_pair_converges_as_jax_does():
    """The default 4000 trips at rank 8: both recover x (-37 and -38 dB
    measured; held at -30 dB), the objectives agree within 10% (0.881 and
    0.905 measured) and the estimates within 5% after phase alignment
    (1.3% measured)."""
    a, b, x = _bm_pair_problem()
    got = tpl.phaselift_bm_pair(None, tpair(a), torch.tensor(b))
    want = jpl.phaselift_bm_pair(jax.random.PRNGKey(0), jpair(a),
                                 jnp.asarray(b))
    x_t = _np(got.x_re) + 1j * _np(got.x_im)
    x_j = np.asarray(want.x_re) + 1j * np.asarray(want.x_im)
    assert nmse_db(x_t, x) <= -30.0 and nmse_db(x_j, x) <= -30.0
    assert float(got.objective) == pytest.approx(float(want.objective),
                                                 rel=0.1)
    _close(x_t, x_j, rtol=5e-2, align=True)
