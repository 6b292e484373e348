"""The port's Vs_M / Vs_SNR slice against the JAX package's, on the CPU:
``models/sparse.py``, ``models/measurement.py``, the sensing matrix, the
sparse and angle metrics, ``pipeline/simulation.py``.

Random draws differ between the packages (``jax.random`` keys against
``torch.Generator``s), so the port's draw helpers are handed JAX's draws
where a function is held to JAX's value; whole sweeps, which draw their
own channels, are held to JAX's curves within 3 dB.  Deterministic parts
are compared at complex128 (the conftest enables x64) to 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from twoace_tpu import config as jcfg
from twoace_tpu.models import channel as jch
from twoace_tpu.models import measurement as jmeas
from twoace_tpu.models import sparse as jsp
from twoace_tpu.pipeline import simulation as jsim
from twoace_tpu.sensing import codebooks as jcb
from twoace_tpu.sensing import sensing_matrix as jsm
from twoace_tpu.utils import metrics as jm
from twoace_tpu_torch import config as tcfg
from twoace_tpu_torch.models import channel as tch
from twoace_tpu_torch.models import measurement as tmeas
from twoace_tpu_torch.models import sparse as tsp
from twoace_tpu_torch.pipeline import simulation as tsim
from twoace_tpu_torch.sensing import codebooks as tcb
from twoace_tpu_torch.sensing import sensing_matrix as tsm
from twoace_tpu_torch.utils import metrics as tm

ATOL = 1e-10
ARR_J, ARR_T = jcfg.ArrayConfig(nt=4, nr=4), tcfg.ArrayConfig(nt=4, nr=4)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _t(x):
    return torch.tensor(np.asarray(x))


def _jax_channel(seed, cfg=ARR_J, n_paths=2, batch=3):
    ch = jch.generate_channel(jax.random.PRNGKey(seed), cfg,
                              jcfg.ChannelConfig(n_paths=n_paths), batch=batch,
                              dtype=jnp.complex128)
    return ch, tch.Channel(*(_t(v) for v in ch))


@pytest.mark.parametrize("cfg,area", [((4, 4), 95.0), ((8, 4), 60.0)])
def test_sparse_formulation_matches_jax(cfg, area):
    """AD, z (nearest grid point, paths outside the window dropped; the
    channel's +-47.5 degree paths overflow a 60-degree window) and the
    leakage (Rx index fastest)."""
    cj, ct = jcfg.ArrayConfig(*cfg), tcfg.ArrayConfig(*cfg)
    ch_j, ch_t = _jax_channel(1, cj, batch=6)
    want = jsp.sparse_formulation(cj, ch_j, area, dtype=jnp.complex128)
    got = tsp.sparse_formulation(ct, ch_t, area, dtype=torch.complex128)
    for f in ("ad", "z", "z_leakage", "a_tx", "a_rx"):
        _close(getattr(got, f), getattr(want, f))
    for f in ("tx_window", "rx_window"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    if area < 95.0:
        dropped = np.sum(np.abs(_np(got.z)) > 0, axis=1) < 2
        assert dropped.any()


def _feed_normal(monkeypatch, draws):
    """Make the port's CN(0, 1) draws return JAX's, in turn."""
    queue = list(draws)

    def draw(generator, shape, dtype, device):
        out = torch.tensor(np.asarray(queue.pop(0)))
        assert tuple(out.shape) == tuple(shape)
        return out.to(dtype).to(device)

    monkeypatch.setattr(tmeas, "complex_normal", draw)
    return queue


@pytest.mark.parametrize("colored", [False, True])
def test_generate_measurement_matches_jax_given_its_draws(monkeypatch,
                                                          colored):
    """IID noise, and colored noise through the combiner (one (nr, mr)
    draw per user tiled over the mt Tx probes); then the noisy-phase
    scrambling from the second stream; and the noiseless case."""
    rng = np.random.default_rng(2)
    batch, mt, mr, n = 3, 5, 2, 16
    m = mt * mr
    fw = rng.normal(size=(batch, m, n)) + 1j * rng.normal(size=(batch, m, n))
    vh = rng.normal(size=(batch, n)) + 1j * rng.normal(size=(batch, n))
    w = (rng.normal(size=(batch, 4, mr)) + 1j * rng.normal(size=(batch, 4, mr))
         if colored else None)
    key = jax.random.PRNGKey(3)
    shape = (batch, 4, mr) if colored else (batch, m)
    left = _feed_normal(monkeypatch, [
        jmeas._complex_normal(key, shape, jnp.complex128),
        jmeas._complex_normal(jax.random.fold_in(key, 1), (batch, m),
                              jnp.complex128)])
    want = jmeas.generate_measurement(
        key, jnp.asarray(fw), jnp.asarray(vh), 7.0, True,
        w=None if w is None else jnp.asarray(w), mt=mt)
    got = tmeas.generate_measurement(None, _t(fw), _t(vh), 7.0, True,
                                     w=None if w is None else _t(w), mt=mt)
    assert not left
    for f in want._fields:
        _close(getattr(got, f), getattr(want, f), atol=1e-9)
    _feed_normal(monkeypatch, [jmeas._complex_normal(
        jax.random.fold_in(key, 1), (batch, m), jnp.complex128)])
    want = jmeas.generate_measurement(key, jnp.asarray(fw), jnp.asarray(vh),
                                      7.0, False)
    got = tmeas.generate_measurement(None, _t(fw), _t(vh), 7.0, False)
    assert float(got.noise_power) == pytest.approx(1e-10)
    for f in ("norm_square", "perfect_phase", "noisy_phase", "isnr"):
        _close(getattr(got, f), getattr(want, f), atol=1e-9)


def test_measurement_draws_come_from_the_generator():
    """Same generator seed, same noise; the noise power follows the SNR."""
    rng = np.random.default_rng(4)
    fw = _t(rng.normal(size=(2, 400, 8)) + 0j)
    vh = _t(np.zeros((2, 8)) + 0j)
    one, two = (tmeas.generate_measurement(torch.Generator().manual_seed(5),
                                           fw, vh, 10.0) for _ in range(2))
    assert torch.equal(one.perfect_phase, two.perfect_phase)
    assert torch.equal(one.noisy_phase, two.noisy_phase)
    power = float(torch.mean(one.norm_square))
    assert power == pytest.approx(0.1, rel=0.15)


def test_directional_sensing_matches_jax():
    """Directional_Beam_Angular (the SimulationConfig default): angle-
    uniform 2-bit beams, FW = kron(F^T, W^H), one FW for the batch."""
    rng = np.random.default_rng(6)
    ad = rng.normal(size=(16, 30)) + 1j * rng.normal(size=(16, 30))
    want = jsm.generate_sensing_matrix(
        jax.random.PRNGKey(0), "Directional_Beam_Angular", 3, 5, ARR_J,
        jnp.asarray(ad), (-30.0, 30.0), (-40.0, 40.0), batch=2)
    got = tsm.generate_sensing_matrix(
        None, "Directional_Beam_Angular", 3, 5, ARR_T, _t(ad),
        (-30.0, 30.0), (-40.0, 40.0), batch=2)
    for f in want._fields:
        _close(getattr(got, f), getattr(want, f), atol=1e-6)
    f_j, w_j = jcb.directional_beams_angular(3, 5, ARR_J, (-30, 30), (-40, 40))
    f_t, w_t = tcb.directional_beams_angular(3, 5, ARR_T, (-30, 30), (-40, 40),
                                             device="cpu")
    _close(f_t, f_j, atol=1e-6)
    _close(w_t, w_j, atol=1e-6)


def test_random_phase_state_sensing_matches_jax_given_its_bits(monkeypatch):
    """Random_Phase_State: per-instance rows from per-instance draws,
    F and W zero; the port's rows are prefix-stable in M."""
    key = jax.random.PRNGKey(7)
    m, batch = 6, 3
    bits = [np.asarray(jcb.random_phase_bits(jax.random.fold_in(key, i), m,
                                             16, 2)) for i in range(batch)]
    rng = np.random.default_rng(8)
    ad = rng.normal(size=(16, 25)) + 1j * rng.normal(size=(16, 25))
    want = jsm.generate_sensing_matrix(key, "Random_Phase_State", m, 1,
                                       ARR_J, jnp.asarray(ad), batch=batch)
    queue = list(bits)
    monkeypatch.setattr(tcb, "random_phase_bits",
                        lambda *a, **k: torch.tensor(queue.pop(0)))
    got = tsm.generate_sensing_matrix(None, "Random_Phase_State", m, 1, ARR_T,
                                      _t(ad), batch=batch)
    assert not queue
    for f in want._fields:
        _close(getattr(got, f), getattr(want, f), atol=1e-6)
    assert not got.f.abs().any() and not got.w.abs().any()
    monkeypatch.undo()
    small, big = (tsm.generate_sensing_matrix(
        torch.Generator().manual_seed(1), "Random_Phase_State", mm, 1, ARR_T,
        _t(ad), batch=2).fw for mm in (6, 20))
    assert torch.equal(small, big[:, :6])
    assert not torch.equal(small[0], small[1])


def test_unported_sensing_modes_and_methods_raise():
    ad = torch.zeros(16, 4, dtype=torch.complex64)
    for mode in tsm.UNPORTED_MODES:
        with pytest.raises(NotImplementedError, match=mode):
            tsm.generate_sensing_matrix(None, mode, 2, 2, ARR_T, ad,
                                        (-30, 30), (-30, 30))
    with pytest.raises(ValueError, match="unknown sensing"):
        tsm.generate_sensing_matrix(None, "Nope", 2, 2, ARR_T, ad)
    with pytest.raises(ValueError, match="aod_range"):
        tsm.generate_sensing_matrix(None, "Directional_Beam_Angular", 2, 2,
                                    ARR_T, ad)
    sim = tsim.SimulationConfig(array=ARR_T, n_trials=1,
                                beam_method="Random_Phase_State",
                                methods=tcfg.MethodFlags(
                                    admm_lowrank_v4=False, cprl=True))
    with pytest.raises(NotImplementedError, match="cprl"):
        tsim.sweep_measurements(None, [4], sim, 95.0, device="cpu")
    sim = dataclasses.replace(sim, methods=tcfg.MethodFlags(), impl="tpu",
                              add_noise=False)
    with pytest.raises(ValueError, match="impl"):
        tsim.sweep_measurements(None, [4], sim, 95.0, device="cpu")


def test_angle_metrics_match_jax_with_ties():
    """angles_from_sparse takes the lower index first among equal
    magnitudes (lax.top_k's order), angle_error sorts equal AoDs stably
    (jnp.argsort), sparse_projection_omp takes the first column of largest
    correlation, all-zero estimates included."""
    rng = np.random.default_rng(9)
    cfg_j, cfg_t = jcfg.ArrayConfig(nt=4, nr=4), tcfg.ArrayConfig(nt=4, nr=4)
    tx_w, rx_w = np.arange(2, 15), np.arange(2, 15)
    z = rng.normal(size=(4, 169)) + 1j * rng.normal(size=(4, 169))
    z[1] = 0.0                                  # every entry ties
    z[2, [5, 40, 90]] = 7.0                     # a three-way tie at the top
    z[3, [3, 60]] = [5.0, 5.0j]                 # exactly equal magnitudes
    for k in (2, 3):
        got = tm.angles_from_sparse(_t(z), cfg_t, tx_w, rx_w, k)
        want = jm.angles_from_sparse(jnp.asarray(z), cfg_j, tx_w, rx_w, k)
        for g, w in zip(got, want):
            _close(g, w)
    aod_e = np.array([[10.0, 10.0, -5.0], [3.0, 3.0, 3.0]])
    aoa_e = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    aod_t = np.array([[10.0, -5.0, 10.0], [3.0, 1.0, 3.0]])
    aoa_t = np.array([[2.5, 0.0, 1.5], [6.0, 5.5, 4.5]])
    got = tm.angle_error(_t(aod_e), _t(aoa_e), _t(aod_t), _t(aoa_t))
    want = jm.angle_error(*(jnp.asarray(v) for v in (aod_e, aoa_e, aod_t,
                                                      aoa_t)))
    for f in want._fields:
        _close(getattr(got, f), getattr(want, f))
    ad = rng.normal(size=(16, 169)) + 1j * rng.normal(size=(16, 169))
    est = rng.normal(size=(3, 16)) + 1j * rng.normal(size=(3, 16))
    est[1] = 0.0
    got = tm.sparse_projection_omp(_t(est), _t(ad), 3)
    for u in range(3):
        _close(got[u], jm.sparse_projection_omp(jnp.asarray(est[u]),
                                                jnp.asarray(ad), 3))


def _jax_cell(seed, m, trials=2, snr_db=20.0):
    """A 4x4 Random_Phase_State cell drawn by JAX, in complex128."""
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 4)
    ch = jch.generate_channel(ks[0], ARR_J, jcfg.ChannelConfig(n_paths=2),
                              batch=trials, dtype=jnp.complex128)
    rep = jsp.sparse_formulation(ARR_J, ch, 95.0, dtype=jnp.complex128)
    sensing = jsm.generate_sensing_matrix(ks[1], "Random_Phase_State", m, 1,
                                          ARR_J, rep.ad, batch=trials)
    sensing = sensing._replace(fw=sensing.fw.astype(jnp.complex128),
                               measurement_mat=sensing.measurement_mat.astype(
                                   jnp.complex128))
    meas = jmeas.generate_measurement(ks[2], sensing.fw, ch.vec_h, snr_db)
    port = (tch.Channel(*(_t(v) for v in ch)),
            tsp.SparseRepresentation(*(v if isinstance(v, np.ndarray)
                                       else _t(v) for v in rep)),
            tsm.SensingMatrix(*(_t(v) for v in sensing)),
            tmeas.Measurements(*(_t(v) for v in meas)))
    return (ch, rep, sensing, meas), port, ks[3]


CELL_METHODS = dict(admm_lowrank_v4=True, phaselift=True, plomp=True,
                    plgamp=True)
ADMM = dict(maxiter=200, n_restarts=1)


def _sims(**kw):
    base = dict(channel=dict(n_paths=2), snr_db=20.0,
                beam_method="Random_Phase_State", methods=CELL_METHODS,
                admm=ADMM)
    base.update(kw)
    out = []
    for cfg in (jcfg, tcfg):
        out.append((jsim if cfg is jcfg else tsim).SimulationConfig(
            array=cfg.ArrayConfig(nt=4, nr=4),
            channel=cfg.ChannelConfig(**base["channel"]),
            snr_db=base["snr_db"], beam_method=base["beam_method"],
            methods=cfg.MethodFlags(**base["methods"]),
            admm=cfg.AdmmConfig(**base["admm"]),
            n_trials=base.get("n_trials", 2), impl=base.get("impl", "complex")))
    return out


@pytest.mark.parametrize("impl", ["complex", "pair"])
def test_recover_all_and_evaluate_match_jax_on_its_cell(impl):
    """JAX's 4x4 cell (2 paths, 2 trials, M 48, SNR 20) through both
    packages' _recover_all and _evaluate.  The sparse baselines draw
    nothing and match to 1e-8 of the largest NMSE; the A2 solves draw
    their own splits and inits, so A2 is held within 1 dB above -60 dB;
    the Burer-Monteiro PhaseLift amplifies rounding about 1e3-fold every
    40 trips, so its 4000-trip answer is held within 1 dB too."""
    (ch, rep, sensing, meas), port, key = _jax_cell(11, 48)
    sim_j, sim_t = _sims(impl=impl)
    want = jsim._recover_all(key, dataclasses.replace(sim_j, impl="complex"),
                             meas, sensing, rep, ch)
    got = tsim._recover_all(torch.Generator().manual_seed(0), sim_t,
                            port[3], port[2], port[1], port[0])
    assert sorted(got) == sorted(want) == sorted(
        ["admm_lowrank_v4", "phaselift", "plomp", "plgamp",
         "perfect_phase_cs", "noisy_phase_cs"])
    nm_j, ang_j, tr_j = jsim._evaluate(want, rep, ch, sim_j)
    nm_t, ang_t, tr_t = tsim._evaluate(got, port[1], port[0], sim_t)
    for name in want:
        db_t, db_j = 10 * np.log10(tr_t[name]), 10 * np.log10(tr_j[name])
        if name in ("admm_lowrank_v4", "phaselift"):
            assert np.all(np.abs(np.maximum(db_t, -60) - np.maximum(db_j, -60))
                          <= 1.0), (name, db_t, db_j)
        else:
            np.testing.assert_allclose(tr_t[name], tr_j[name], rtol=0,
                                       atol=1e-8 * max(tr_j[name].max(), 1))
            assert ang_t[name] == pytest.approx(ang_j[name], abs=1e-9), name
        assert nm_t[name] == pytest.approx(np.mean(tr_t[name]))


def _curves_close(got, want, tol_db=3.0):
    assert sorted(got.nmse) == sorted(want.nmse)
    np.testing.assert_array_equal(got.grid, want.grid)
    for name in want.nmse:
        db_t = 10 * np.log10(got.nmse[name])
        db_j = 10 * np.log10(np.asarray(want.nmse[name]))
        assert np.all(np.abs(db_t - db_j) <= tol_db), (name, db_t, db_j)
        assert got.nmse_trials[name].shape == np.asarray(
            want.nmse_trials[name]).shape
        assert np.all(np.isfinite(got.aoda_err[name]))


def test_sweep_measurements_matches_jax_curves():
    """Vs_M end to end at 4x4 (2 paths, SNR 20, Random_Phase_State, 12
    trials) at M 4 (fewer probes than unknowns: every method near 0 dB)
    and M 64 (= 4n, every method resolved): each curve within 3 dB of
    JAX's, each package drawing its own channels.  A curve is the dB of
    the mean linear NMSE, which one poor trial moves by several dB (the
    per-trial spread of PLOMP and PLGAMP is about +-4 dB here): hence 12
    trials."""
    sim_j, sim_t = _sims(n_trials=12)
    want = jsim.sweep_measurements(jax.random.PRNGKey(1), [4, 64], sim_j, 95.0)
    got = tsim.sweep_measurements(torch.Generator().manual_seed(1), [4, 64],
                                  sim_t, 95.0, device="cpu")
    _curves_close(got, want)


def test_sweep_snr_matches_jax_curves():
    """Vs_SNR end to end at 4x4, M 64, SNR 10 and 30, 12 trials: each
    curve within 3 dB of JAX's."""
    sim_j, sim_t = _sims(n_trials=12,
                         methods=dict(admm_lowrank_v4=True, plomp=True))
    want = jsim.sweep_snr(jax.random.PRNGKey(2), [10.0, 30.0], 64, sim_j, 95.0)
    got = tsim.sweep_snr(torch.Generator().manual_seed(2), [10.0, 30.0], 64,
                         sim_t, 95.0, device="cpu")
    _curves_close(got, want)


@pytest.mark.parametrize("plomp", [True, False])
def test_sweep_records_seconds_and_mcs(plomp):
    """A sweep's per-point host seconds (the whole cell and each method
    group it ran) and the two-stage compression size of each trial: one
    per trial while PLOMP runs, none otherwise."""
    _, sim_t = _sims(n_trials=2,
                     methods=dict(admm_lowrank_v4=False, plomp=plomp))
    res = tsim.sweep_measurements(torch.Generator().manual_seed(3), [16, 32],
                                  sim_t, 95.0, device="cpu")
    groups = ["perfect+noisy CS"] + (["plomp+plgamp"] if plomp else [])
    assert sorted(res.seconds) == sorted(["cell"] + groups)
    for name in groups:
        assert np.all(res.seconds[name] > 0)
        assert np.all(res.seconds[name] <= res.seconds["cell"])
    assert res.mcs.dtype == np.int64
    assert res.mcs.shape == ((2, 2) if plomp else (2, 0))
    assert np.all((res.mcs >= 1) & (res.mcs <= np.array([[16], [32]])))
