"""The port's Vs_M / Vs_SNR slice against the JAX package's, on the CPU:
``models/sparse.py``, ``models/measurement.py``, the sensing matrix, the
sparse and angle metrics, ``pipeline/simulation.py``.

Random draws differ between the packages (``jax.random`` keys against
``torch.Generator``s), so the port's draw helpers are handed JAX's draws
where a function is held to JAX's value; whole sweeps, handed the draws
JAX's own sweep makes (its A2 and noisy-phase CS still draw their own),
are held to JAX's curves within 3 dB.  Deterministic parts are compared
at complex128 (the conftest enables x64) to 1e-10.
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
from twoace_tpu_torch.utils.rng import fold_in

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
    """The four sensing modes that raised before they were ported now run
    (each is held against JAX in test_torch_sensing.py); unknown modes,
    missing ranges and an unknown impl still raise ValueError."""
    ad = torch.zeros(16, 4, dtype=torch.complex64)
    for mode in ("Directional_Beam", "Directional_Random_Beam",
                 "Region_Random_Beam", "Random_Beam_Bayes"):
        sm = tsm.generate_sensing_matrix(torch.Generator().manual_seed(0),
                                         mode, 2, 2, ARR_T, ad, (-30, 30),
                                         (-30, 30), batch=2)
        assert sm.fw.shape == (2, 4, 16) and sm.fw.abs().gt(0).all()
    with pytest.raises(ValueError, match="unknown sensing"):
        tsm.generate_sensing_matrix(None, "Nope", 2, 2, ARR_T, ad)
    with pytest.raises(ValueError, match="aod_range"):
        tsm.generate_sensing_matrix(None, "Directional_Beam_Angular", 2, 2,
                                    ARR_T, ad)
    # CPRL, which raised before it was ported, runs (and is timed)
    sim = tsim.SimulationConfig(array=ARR_T, n_trials=1,
                                beam_method="Random_Phase_State",
                                methods=tcfg.MethodFlags(
                                    admm_lowrank_v4=False, cprl=True))
    res = tsim.sweep_measurements(None, [4], sim, 95.0, device="cpu")
    assert np.isfinite(res.nmse["cprl"]).all() and res.seconds["cprl"] > 0
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


def _port_draws(ch, rep, sensing, meas):
    """JAX's draws of a cell as the port's tensors."""
    return (tch.Channel(*(_t(v) for v in ch)),
            tsp.SparseRepresentation(*(v if isinstance(v, np.ndarray)
                                       else _t(v) for v in rep)),
            tsm.SensingMatrix(*(_t(v) for v in sensing)),
            tmeas.Measurements(*(_t(v) for v in meas)))


def _feed_jax_cells(monkeypatch):
    """Record the draws of JAX's sweep as it makes them (its _one_cell
    calls these four, simulation.py:232-248) and hand them to the port's
    sweep, cell by cell.  Returns the queue of recorded cells, empty once
    the port's sweep has drawn every one."""
    queue, parts = [], []

    def record(name):
        fn = getattr(jsim, name)

        def wrapper(*a, **k):
            out = fn(*a, **k)
            parts.append(out)
            if len(parts) == 4:
                queue.append(_port_draws(*parts))
                parts.clear()
            return out
        return wrapper

    for name in ("generate_channel", "sparse_formulation",
                 "generate_sensing_matrix", "generate_measurement"):
        monkeypatch.setattr(jsim, name, record(name))
    monkeypatch.setattr(tsim, "draw_cell", lambda *a, **k: queue.pop(0))
    return queue


@pytest.mark.parametrize("mode", ["Random_Phase_State",
                                  "Directional_Beam_Angular"])
def test_draw_cell_composes_the_draws(mode):
    """The port's draw_cell, which the sweep tests above replace by JAX's
    draws: the channels, sparse formulation, sensing matrix and
    measurements it returns are the port's own helpers called with
    ``fold_in(g, 0 / 1 / 2)``, over (-area/2, area/2), and the noise
    colored by W only where the mode has a combiner (iid where it has
    none), exactly (the same CPU draws)."""
    sim = tsim.SimulationConfig(array=ARR_T,
                                channel=tcfg.ChannelConfig(n_paths=2),
                                snr_db=5.0, beam_method=mode, n_trials=2)
    mt, mr = (6, 1) if mode == "Random_Phase_State" else (3, 2)
    g = torch.Generator().manual_seed(21)
    ch, rep, sensing, meas = tsim.draw_cell(g, sim, mt, mr, 60.0,
                                            device="cpu")
    ch_w = tch.generate_channel(fold_in(g, 0), ARR_T, sim.channel, batch=2,
                                device="cpu")
    rep_w = tsp.sparse_formulation(ARR_T, ch_w, 60.0)
    sens_w = tsm.generate_sensing_matrix(
        fold_in(g, 1), mode, mt, mr, ARR_T, rep_w.ad,
        aod_range=(-30.0, 30.0), aoa_range=(-30.0, 30.0), batch=2)
    w_rule, w_other = ((None, sens_w.w) if mode == "Random_Phase_State"
                       else (sens_w.w, None))
    meas_w = tmeas.generate_measurement(fold_in(g, 2), sens_w.fw, ch_w.vec_h,
                                        5.0, True, w=w_rule, mt=mt)
    for got, want in ((ch, ch_w), (rep, rep_w), (sensing, sens_w),
                      (meas, meas_w)):
        for a, b in zip(got, want):
            if isinstance(b, torch.Tensor):
                assert torch.equal(a, b)
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    other = tmeas.generate_measurement(fold_in(g, 2), sens_w.fw, ch_w.vec_h,
                                       5.0, True, w=w_other, mt=mt)
    assert not torch.equal(other.perfect_phase, meas.perfect_phase)


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
    return ((ch, rep, sensing, meas), _port_draws(ch, rep, sensing, meas),
            ks[3])


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


@pytest.fixture(scope="module")
def jax_cell():
    """JAX's 4x4 cell (2 paths, 2 trials, M 48, SNR 20), its _recover_all
    (complex) and _evaluate, shared by both impls' cases."""
    (ch, rep, sensing, meas), port, key = _jax_cell(11, 48)
    sim_j, _ = _sims()
    want = jsim._recover_all(key, sim_j, meas, sensing, rep, ch)
    return want, jsim._evaluate(want, rep, ch, sim_j), port


@pytest.mark.parametrize("impl", ["complex", "pair"])
def test_recover_all_and_evaluate_match_jax_on_its_cell(impl, jax_cell):
    """JAX's 4x4 cell (2 paths, 2 trials, M 48, SNR 20) through both
    packages' _recover_all and _evaluate (JAX's run once, in complex, for
    both impls).  The sparse baselines draw nothing and match to 1e-8 of
    the largest NMSE; the A2 solves draw their own splits and inits, so
    A2 is held within 1 dB above -60 dB; the Burer-Monteiro PhaseLift
    amplifies rounding about 1e3-fold every 40 trips, so its 4000-trip
    answer is held within 1 dB too."""
    want, (nm_j, ang_j, tr_j), port = jax_cell
    _, sim_t = _sims(impl=impl)
    got = tsim._recover_all(torch.Generator().manual_seed(0), sim_t,
                            port[3], port[2], port[1], port[0])
    assert sorted(got) == sorted(want) == sorted(
        ["admm_lowrank_v4", "phaselift", "plomp", "plgamp",
         "perfect_phase_cs", "noisy_phase_cs"])
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


def test_sweep_measurements_matches_jax_curves(monkeypatch):
    """Vs_M at 4x4 (2 paths, SNR 20, Random_Phase_State, 3 trials) from
    the draws to the curves, with JAX's draws handed over cell by cell in
    place of draw_cell's (held on its own in
    test_draw_cell_composes_the_draws), at M 4 (fewer probes than
    unknowns: every method near 0 dB) and M 64 (= 4n, every method
    resolved): each curve within 3 dB of JAX's.  A curve is the dB of
    the mean linear NMSE, which one poor trial moves by several dB when
    the two packages draw their own channels (the per-trial spread of
    PLOMP and PLGAMP is about +-4 dB here); on JAX's draws only A2's
    splits and inits and the noisy-phase CS's phase noise differ."""
    sim_j, sim_t = _sims(n_trials=3)
    queue = _feed_jax_cells(monkeypatch)
    want = jsim.sweep_measurements(jax.random.PRNGKey(1), [4, 64], sim_j,
                                   95.0)
    assert len(queue) == 2
    got = tsim.sweep_measurements(torch.Generator().manual_seed(1), [4, 64],
                                  sim_t, 95.0, device="cpu")
    assert not queue
    _curves_close(got, want)


def test_sweep_snr_matches_jax_curves(monkeypatch):
    """Vs_SNR at 4x4, M 64, SNR 10 and 30, 3 trials, the port handed
    JAX's draws in place of draw_cell's: each curve within 3 dB of
    JAX's."""
    sim_j, sim_t = _sims(n_trials=3,
                         methods=dict(admm_lowrank_v4=True, plomp=True))
    queue = _feed_jax_cells(monkeypatch)
    want = jsim.sweep_snr(jax.random.PRNGKey(2), [10.0, 30.0], 64, sim_j,
                          95.0)
    assert len(queue) == 2
    got = tsim.sweep_snr(torch.Generator().manual_seed(2), [10.0, 30.0], 64,
                         sim_t, 95.0, device="cpu")
    assert not queue
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


def test_array_response_mse_and_beamforming_gain_match_jax():
    """Both metrics at an 8 x 4 array.  The steering matrices are
    complex64 in both packages (JAX rounds their phase in float64 first):
    the array-response MSE within 1e-5 relative.  The gains go through an
    SVD whose singular vectors carry a free phase; on the CPU both
    packages call LAPACK and agree, so the analog (2-bit) gain, which
    depends on that phase, is held with the digital one, to 1e-10."""
    rng = np.random.default_rng(30)
    cj, ct = jcfg.ArrayConfig(nt=4, nr=8), tcfg.ArrayConfig(nt=4, nr=8)
    aod_e, aoa_e = rng.uniform(-40, 40, (2, 3, 2))
    aod_t, aoa_t = aod_e + rng.normal(size=(3, 2)), aoa_e - 2.0
    got = tm.array_response_mse(*(_t(v) for v in (aod_e, aoa_e, aod_t,
                                                  aoa_t)), ct)
    want = jm.array_response_mse(*(jnp.asarray(v) for v in (
        aod_e, aoa_e, aod_t, aoa_t)), cj)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)
    assert np.all(_np(got) > 0)
    h = rng.normal(size=(3, 8, 4)) + 1j * rng.normal(size=(3, 8, 4))
    est = h + 0.3 * (rng.normal(size=h.shape) + 1j * rng.normal(size=h.shape))
    vec_est = est.transpose(0, 2, 1).reshape(3, -1)
    got = tm.beamforming_gain(_t(vec_est), _t(h), ct)
    want = jm.beamforming_gain(jnp.asarray(vec_est), jnp.asarray(h), cj)
    for g, w in zip(got, want):
        _close(g, w)
    assert np.all(_np(got[0]) <= _np(got[1]) + 1e-12)


def _stub_cell(calls):
    """A stand-in for both packages' ``_one_cell``: MAEE and NMSE curves
    that depend on (Mt, range, G) only, one method NaN at Mt = 3."""
    def cell(key, sim, mt, mr, area, *rest):
        g = sim.array.nqt
        calls.append((mt, mr, area, g, sim.array.nqr))
        an = {"a2": 3.0 * abs(np.sin(0.7 * mt + 0.05 * area + 0.01 * g)),
              "plomp": float("nan") if mt == 3 else 0.05 * (mt + g)}
        nm = {"a2": 0.1 * mt, "plomp": 0.2 + 0.001 * g}
        return nm, an, {k: np.full(2, v) for k, v in nm.items()}
    return cell


@pytest.mark.parametrize("table", [True, False])
def test_vs_sr_selection_matches_jax_on_identical_curves(monkeypatch, table):
    """measurements_needed_vs_range with both packages' cells replaced by
    the same stub: the same (M, G) table per range (G as NQt = NQr), the
    same closest-match budgets (nanargmin, NaN points skipped) reported as
    Mt*Mr, the same curves, and point j of range i drawn from
    fold_in(generator, i * 1024 + j).  Without the table: one shared grid,
    G = grid_t by default, total rows under a combiner-less mode; a range
    the table lacks raises in both."""
    calls_j, calls_t, folds = [], [], []
    monkeypatch.setattr(jsim, "_one_cell", _stub_cell(calls_j))
    monkeypatch.setattr(tsim, "_one_cell", _stub_cell(calls_t))
    real_fold = tsim.fold_in
    monkeypatch.setattr(tsim, "fold_in", lambda g, d: (folds.append(d),
                                                       real_fold(g, d))[1])
    if table:
        kw = dict(ranges_deg=(20.0, 50.0, 80.0))
        beam = "Directional_Beam_Angular"
    else:
        kw = dict(ranges_deg=(25.0, 35.0), m_grid=(3, 4, 5))
        beam = "Random_Phase_State"
    sims = [pkg.SimulationConfig(array=cfg.ArrayConfig(nt=4, nr=4),
                                 beam_method=beam)
            for pkg, cfg in ((jsim, jcfg), (tsim, tcfg))]
    want = jsim.measurements_needed_vs_range(
        jax.random.PRNGKey(0), maee_targets=(0.5, 1.5, 2.5), sim=sims[0],
        **kw)
    got = tsim.measurements_needed_vs_range(
        torch.Generator().manual_seed(0), maee_targets=(0.5, 1.5, 2.5),
        sim=sims[1], device="cpu", **kw)
    assert calls_t == calls_j
    assert got.m_grids == want.m_grids and got.g_grids == want.g_grids
    if table:
        assert got.m_grids == [list(tsim.VS_SR_GRIDS[r][0])
                               for r in (20, 50, 80)]
        assert tsim.VS_SR_GRIDS == jsim.VS_SR_GRIDS
    else:
        assert got.g_grids == [[16] * 3] * 2
    assert folds == [i * 1024 + j for i, ms in enumerate(got.m_grids)
                     for j in range(len(ms))]
    assert got.maee_targets == want.maee_targets
    np.testing.assert_array_equal(got.ranges, want.ranges)
    assert sorted(got.m_needed) == sorted(want.m_needed) == ["a2", "plomp"]
    for k in want.m_needed:
        np.testing.assert_array_equal(got.m_needed[k], want.m_needed[k])
        for acc in ("maee_curves", "nmse_curves"):
            for g, w in zip(getattr(got, acc)[k], getattr(want, acc)[k]):
                np.testing.assert_array_equal(g, w)
    if not table:
        for pkg, sim in ((jsim, sims[0]), (tsim, sims[1])):
            with pytest.raises(ValueError, match="no reference"):
                pkg.measurements_needed_vs_range(None, (25.0,), sim=sim)


VSSR_RANGES = (20.0, 60.0)
VSSR_M, VSSR_G = (3,), (16,)


def _vssr_sims():
    """VS_SR's cell at 4 x 4: one path with Rician K 5, SNR 0 with noise,
    directional beams, PLOMP + PLGAMP (and the two CS references), 2
    trials."""
    return [pkg.SimulationConfig(
        array=cfg.ArrayConfig(nt=4, nr=4),
        channel=cfg.ChannelConfig(n_paths=1, rician_k=5), snr_db=0.0,
        beam_method="Directional_Beam_Angular",
        methods=cfg.MethodFlags(admm_lowrank_v4=False, plomp=True,
                                plgamp=True), n_trials=2)
        for pkg, cfg in ((jsim, jcfg), (tsim, tcfg))]


def _jax_vssr_draws(key, sim):
    """The channels, sensing matrices and measurements JAX's
    measurements_needed_vs_range draws at each point, in order, as the
    port's tensors (complex128 under x64)."""
    draws = {"channel": [], "sensing_matrix": [], "measurement": []}
    for r_i, sr in enumerate(VSSR_RANGES):
        for j, (m, g) in enumerate(zip(VSSR_M, VSSR_G)):
            cfg = dataclasses.replace(sim.array, nqt=g, nqr=g)
            ks = jax.random.split(jax.random.fold_in(key, r_i * 1024 + j), 4)
            ch = jch.generate_channel(ks[0], cfg, sim.channel,
                                      batch=sim.n_trials)
            rep = jsp.sparse_formulation(cfg, ch, sr)
            sensing = jsm.generate_sensing_matrix(
                ks[1], sim.beam_method, m, m, cfg, rep.ad,
                aod_range=(-sr / 2, sr / 2), aoa_range=(-sr / 2, sr / 2),
                batch=sim.n_trials)
            meas = jmeas.generate_measurement(ks[2], sensing.fw, ch.vec_h,
                                              sim.snr_db, True, w=sensing.w,
                                              mt=m)
            for name, tup, cls in (("channel", ch, tch.Channel),
                                   ("sensing_matrix", sensing,
                                    tsm.SensingMatrix),
                                   ("measurement", meas,
                                    tmeas.Measurements)):
                draws[name].append(cls(*(_t(v) for v in tup)))
    return draws


def test_vs_sr_matches_jax_given_its_draws(monkeypatch):
    """measurements_needed_vs_range at 4 x 4 over two ranges at Mt = Mr =
    3, G = 16, the port handed JAX's channels, sensing matrices and
    measurements in order (complex128, as JAX draws them under x64): the
    sparse baselines draw nothing, so every MAEE point (the same
    supports), every selected budget and the NMSE curves agree, the curves
    to 1e-6 relative (4.9e-8 measured after 4000 FISTA trips).  The selection over several points is held by the stub
    test above; one point a range keeps JAX's compiles to two (its
    measurements_needed_vs_range clears its caches after every point)."""
    sim_j, sim_t = _vssr_sims()
    key = jax.random.PRNGKey(3)
    draws = _jax_vssr_draws(key, sim_j)
    for name in draws:
        monkeypatch.setattr(tsim, "generate_" + name,
                            lambda *a, _q=draws[name], **k: _q.pop(0))
    kw = dict(ranges_deg=VSSR_RANGES, m_grid=VSSR_M, g_grid=VSSR_G,
              maee_targets=(5.0, 10.0, 20.0))
    want = jsim.measurements_needed_vs_range(key, sim=sim_j, **kw)
    got = tsim.measurements_needed_vs_range(None, sim=sim_t, device="cpu",
                                            **kw)
    assert not any(draws.values())
    assert sorted(got.m_needed) == sorted(want.m_needed) == [
        "noisy_phase_cs", "perfect_phase_cs", "plgamp", "plomp"]
    for k in want.m_needed:
        np.testing.assert_array_equal(got.m_needed[k], want.m_needed[k])
        for acc in ("maee_curves", "nmse_curves"):
            for g, w in zip(getattr(got, acc)[k], getattr(want, acc)[k]):
                np.testing.assert_allclose(g, w, rtol=1e-6)
    assert sorted(got.seconds) == ["cell", "perfect+noisy CS", "plomp+plgamp"]


def test_sweep_measurements_trace_matches_jax():
    """Three supplied 4 x 4 traces (magnitude-normalized), directional
    beams over 180 degrees without noise, M = 9 and 16: the measurements
    draw nothing, so PLOMP, PLGAMP and perfect-phase CS are held to JAX's
    within 0.5 dB.  The port solves in complex64, JAX under x64 in
    complex128 (its beams promote), and 4000 FISTA trips on these
    full-rank traces land apart along PhaseLift's flat directions:
    measured 0.07 dB (PLOMP), 0.17 dB (PLGAMP), 1e-6 dB (perfect CS).
    Noisy-phase CS draws its phase noise (finite only).  Angle errors are
    NaN; n_trials follows the traces."""
    rng = np.random.default_rng(31)
    traces = (rng.normal(size=(3, 4, 4)) + 1j * rng.normal(size=(3, 4, 4))
              ).astype(np.complex64)
    sims = [pkg.SimulationConfig(
        array=cfg.ArrayConfig(nt=4, nr=4), add_noise=False,
        beam_method="Directional_Beam_Angular",
        methods=cfg.MethodFlags(admm_lowrank_v4=False, plomp=True,
                                plgamp=True), n_trials=7)
        for pkg, cfg in ((jsim, jcfg), (tsim, tcfg))]
    want = jsim.sweep_measurements_trace(jax.random.PRNGKey(0),
                                         jnp.asarray(traces), [3, 4], sims[0])
    got = tsim.sweep_measurements_trace(torch.Generator().manual_seed(0),
                                        traces, [3, 4], sims[1],
                                        device="cpu")
    np.testing.assert_array_equal(got.grid, want.grid)
    assert sorted(got.nmse) == sorted(want.nmse) == [
        "noisy_phase_cs", "perfect_phase_cs", "plgamp", "plomp"]
    for k in want.nmse:
        assert np.isnan(got.aoda_err[k]).all() and got.aoda_err[k].shape == (2,)
        if k == "noisy_phase_cs":
            assert np.isfinite(got.nmse[k]).all()
        else:
            np.testing.assert_allclose(10 * np.log10(got.nmse[k]),
                                       10 * np.log10(want.nmse[k]),
                                       rtol=0, atol=0.5)
    assert np.all(got.seconds["cell"] >= got.seconds["plomp+plgamp"])


def test_infer_channel_windows_matches_jax():
    """Two 48-probe windows of a 4 x 4 2-bit codebook, the second measuring
    another channel: both packages recover each window's channel below
    -60 dB as (nr, nt) matrices (the solves draw their own splits and
    starts, so they are held on what they recover)."""
    from torch_parity import codebook, nmse_db, steer

    rng = np.random.default_rng(32)
    cb = codebook(rng, 96, 16).astype(np.complex128)
    xs = [sum(g * np.outer(steer(4, ar), steer(4, at).conj()).T.reshape(-1)
              for g, ar, at in paths)
          for paths in (((1.0, 0.3, -0.5), (0.5j, -0.7, 0.2)),
                        ((0.8, -0.2, 0.6), (0.4, 0.5, -0.1)))]
    amps = np.concatenate([np.abs(cb[:48] @ xs[0]), np.abs(cb[48:] @ xs[1])])
    admm = dict(maxiter=150, n_restarts=1)
    want = jsim.infer_channel_windows(
        jax.random.PRNGKey(0), jnp.asarray(cb), jnp.asarray(amps), ARR_J,
        window=48, n_windows=2, admm=jcfg.AdmmConfig(**admm))
    got = tsim.infer_channel_windows(
        torch.Generator().manual_seed(0), cb, amps, ARR_T, window=48,
        n_windows=2, admm=tcfg.AdmmConfig(**admm), device="cpu")
    assert got.shape == np.asarray(want).shape == (2, 4, 4)
    for est in (got, np.asarray(want)):
        for i, x in enumerate(xs):
            # (nr, nt) -> vec(H), Rx index fastest
            assert nmse_db(est[i].T.reshape(-1), x) < -60.0
