"""The port's sensing layer (``twoace_tpu_torch.sensing``: the codebook
families, antenna grouping, Bayes A-optimal selection, the sensing-matrix
modes and Bayes beam builders, the codebook images and the TCP provider)
against the JAX package's, on the CPU.

Both packages get the same numpy inputs.  Where a function draws, the
port is handed JAX's draw: the random-gain beams' numpy seed, the
multires tiers' group bits, the selection's initial design.  With those,
the host-numpy families agree exactly.  The Bayes exchange picks JAX's
indices in complex128 on real rows, and a plain exchange's (every swap
re-inverted) on complex rows; the sensing modes and beam builders are
held to JAX's given one selection.  JAX jits ``bayes_a_opt_select``
once per shape, so the selections here use few, small shapes (C <= 256,
n <= 16).
"""

import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import steer
from twoace_tpu import config as jcfg
from twoace_tpu.sensing import bayes_opt as jbo
from twoace_tpu.sensing import codebooks as jcb
from twoace_tpu.sensing import grouping as jgr
from twoace_tpu.sensing import sensing_matrix as jsm
from twoace_tpu_torch import config as tcfg
from twoace_tpu_torch.models import steering as tsteer
from twoace_tpu_torch.sensing import bayes_opt as tbo
from twoace_tpu_torch.sensing import codebooks as tcb
from twoace_tpu_torch.sensing import grouping as tgr
from twoace_tpu_torch.sensing import sensing_matrix as tsm
from twoace_tpu_torch.utils.rng import fold_in

NT = NR = 4
N = NT * NR
ARR_J = jcfg.ArrayConfig(nt=NT, nr=NR)
ARR_T = tcfg.ArrayConfig(nt=NT, nr=NR)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax(fn):
    """Run a JAX reference call, ``fn()``, under one ``jax.jit``: one XLA
    compile in place of one per eager op (each costs a tenth of a second
    on the CPU).  Calls that read a traced value on the host run eagerly."""
    out = jax.jit(fn)()
    jax.effects_barrier()
    return out


def _jax_seed(key):
    """The numpy seed JAX's random-gain beams draw from ``key``."""
    return int(jax.random.randint(key, (), 0, 2 ** 31 - 1))


def _channel(seed=0):
    """A two-path 4x4 channel as (nt, nr) and vec(H) (Rx fastest)."""
    rng = np.random.default_rng(seed)
    h = sum(g * np.outer(steer(NT, at), steer(NR, ar))
            for g, at, ar in ((1.0, 0.4, -0.3),
                              (0.6 * np.exp(1j * rng.uniform(0, 6)), -0.8,
                               0.5)))
    return h, h.reshape(-1)


# ------------------------------------------------------------------ grouping

def test_grouping_matches_jax():
    """The grouping copy is host numpy: equal to JAX's to the bit."""
    rng = np.random.default_rng(0)
    offsets = rng.uniform(0, 2 * np.pi, 16)
    coords = jgr.ura_coordinates(16)
    np.testing.assert_array_equal(tgr.ura_coordinates(16), coords)
    np.testing.assert_array_equal(tgr.ura_coordinates(10, 3),
                                  jgr.ura_coordinates(10, 3))
    np.testing.assert_array_equal(tgr.location_phase(coords, 0.3, -0.2),
                                  jgr.location_phase(coords, 0.3, -0.2))
    gt, bt = tgr.group_antennas(offsets, 4, azimuth_rad=0.2)
    gj, bj = jgr.group_antennas(offsets, 4, azimuth_rad=0.2)
    assert gt == gj
    np.testing.assert_array_equal(bt, bj)
    az, el = np.linspace(-40, 40, 5), np.linspace(-10, 10, 3)
    ideal = jgr.ideal_steering_ura(az, el, coords, coords[::-1])
    np.testing.assert_array_equal(
        tgr.ideal_steering_ura(az, el, coords, coords[::-1]), ideal)
    phase = rng.uniform(-np.pi, np.pi, ideal.shape)
    np.testing.assert_array_equal(tgr.antenna_phase_shifts(phase, ideal),
                                  jgr.antenna_phase_shifts(phase, ideal))
    beam_map = np.arange(1, 17)
    np.testing.assert_array_equal(
        tgr.per_panel_phase_offsets(phase, az, el, beam_map),
        jgr.per_panel_phase_offsets(phase, az, el, beam_map))


# ----------------------------------------------------------------- codebooks

def test_directional_beam_families_match_jax():
    """Spatial, random-gain and region beams (given JAX's numpy seed) at
    4x4 over 60 degrees: the same quantized beams (tol 1e-6, the port's
    complex64 against JAX's complex128)."""
    key = jax.random.PRNGKey(3)
    for got, want in (
            (tcb.directional_beams_spatial(3, 2, ARR_T, 60.0, device="cpu"),
             jcb.directional_beams_spatial(3, 2, ARR_J, 60.0)),
            (tcb.directional_random_beams(None, 3, 2, ARR_T, 60.0,
                                          seed=_jax_seed(key), device="cpu"),
             jcb.directional_random_beams(key, 3, 2, ARR_J, 60.0)),
            (tcb.region_random_beams(None, 3, 2, ARR_T, 60.0,
                                     seed=_jax_seed(key), device="cpu"),
             jcb.region_random_beams(key, 3, 2, ARR_J, 60.0))):
        for g, w in zip(got, want):
            assert g.dtype == torch.complex64
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-6)
    # rank elimination appends pairwise sums of drawn columns: the first
    # mt - RE columns are the independent design, and the rank drops
    f, w = tcb.directional_beams_spatial(
        7, 7, ARR_T, 60.0, rank_eliminated=2,
        generator=torch.Generator().manual_seed(0), device="cpu")
    f5, _ = tcb.directional_beams_spatial(5, 5, ARR_T, 60.0, device="cpu")
    assert f.shape == (NT, 7) and w.shape == (NR, 7)
    assert torch.equal(f[:, :5], f5)
    with pytest.raises(ValueError, match="generator"):
        tcb.directional_beams_spatial(7, 7, ARR_T, 60.0, rank_eliminated=2,
                                      device="cpu")


def test_sweep_multires_aco_codebooks_match_jax():
    """Sweeps, groupings, multires tiers (given JAX's group bits) and the
    ACO masks: the same bits and rows."""
    cfg_t, cfg_j = tcfg.ArrayConfig(nt=16, nr=16), jcfg.ArrayConfig(16, 16)
    for got, want in ((tcb.sweep_codebook_2d(cfg_t, 6, 6, device="cpu"),
                       lambda: jcb.sweep_codebook_2d(cfg_j, 6, 6)),
                      (tcb.sweep_codebook(cfg_t, 32, device="cpu"),
                       lambda: jcb.sweep_codebook(cfg_j, 32)),
                      (tcb.aco_sweep_codebook(NT, ref_bit=1, device="cpu"),
                       lambda: jcb.aco_sweep_codebook(NT, ref_bit=1))):
        bits, rows = _jax(lambda: (want().bits, want().rows()))
        np.testing.assert_array_equal(_np(got.bits), np.asarray(bits))
        np.testing.assert_allclose(_np(got.rows()), np.asarray(rows),
                                   atol=1e-6)
    assert tcb.default_groupings(6) == jcb.default_groupings(6)
    key, rounds = jax.random.PRNGKey(4), (3, 4, 5)
    calib = np.array([0, 2, 3, 1, 0, 1, 2, 3])
    group_bits = [np.asarray(jax.random.randint(
        jax.random.fold_in(key, t), (r, len(g)), 0, 4))
        for t, (r, g) in enumerate(zip(rounds, jcb.default_groupings(8)))]
    inf_t, act_t = tcb.multires_codebook(None, 8, rounds, calibration=calib,
                                         group_bits=group_bits, device="cpu")
    inf_j, act_j = jcb.multires_codebook(key, 8, rounds, calibration=calib)
    np.testing.assert_array_equal(_np(inf_t.bits), np.asarray(inf_j.bits))
    np.testing.assert_array_equal(_np(act_t.bits), np.asarray(act_j.bits))
    np.testing.assert_array_equal(act_t.calibration, act_j.calibration)
    drawn, _ = tcb.multires_codebook(torch.Generator().manual_seed(0), 8,
                                     rounds, device="cpu")
    bits = _np(drawn.bits)
    assert bits.shape == (12, 8) and bits.max() < 4
    assert (bits[:3, :4] == bits[:3, :1]).all()      # groups of 4 share bits


def test_aco_csi_and_conj_bits_match_jax():
    """rss_to_csi's DFT recovery and the conjugate-phase bits, float64:
    within 1e-12; the bits equal."""
    rng = np.random.default_rng(2)
    rss = rng.uniform(0.1, 2.0, NT * 4)
    csi_t = tcb.rss_to_csi(torch.tensor(rss), NT)
    csi_j = np.asarray(_jax(lambda: jcb.rss_to_csi(jnp.asarray(rss), NT)))
    np.testing.assert_allclose(_np(csi_t), csi_j, atol=1e-12)
    np.testing.assert_array_equal(
        _np(tcb.conj_phase_bits(csi_t)),
        np.asarray(_jax(lambda: jcb.conj_phase_bits(jnp.asarray(csi_j)))))


def _gain(h, wt_bits, wr_bits):
    wt = np.exp(1j * np.asarray(wt_bits) * np.pi / 2)
    wr = np.exp(1j * np.asarray(wr_bits) * np.pi / 2)
    return abs(wt @ h @ wr)


def test_svd_beamformer_and_evaluation_codebook_match_jax():
    """The SVD beamformer's bits depend on each SVD's per-vector phase, so
    both packages' bits are compared by their beam gain |wt^T H wr|
    (within 1e-5 relative), with and without compensation; the
    evaluation codebook's rows likewise, its ACO rows exactly, its probe
    rows by shape and alphabet."""
    h, vec = _channel()
    comp = np.linspace(-0.5, 0.5, NT)
    for c in (None, comp):
        bt = tcb.svd_beamformer_bits(torch.tensor(h, dtype=torch.complex64),
                                     compensation=c)
        bj = _jax(lambda: jcb.svd_beamformer_bits(
            jnp.asarray(h, jnp.complex64), compensation=c))
        np.testing.assert_allclose(_gain(h, *bt), _gain(h, *bj), rtol=1e-5)
    aco = (np.arange(NT) % 4, np.arange(NR)[::-1] % 4)
    h2 = _channel(1)[1]
    est = np.stack([vec, h2]).astype(np.complex64)
    tx_t, rx_t = tcb.evaluation_codebook(
        torch.Generator().manual_seed(0), torch.tensor(est),
        h_directional=torch.tensor(h2.astype(np.complex64)),
        wt_aco_bits=aco[0], wr_aco_bits=aco[1], nt=NT, nr=NR, n_probe=5)
    tx_j, rx_j = _jax(lambda: jcb.evaluation_codebook(
        jax.random.PRNGKey(0), jnp.asarray(est),
        h_directional=jnp.asarray(h2.astype(np.complex64)),
        wt_aco_bits=aco[0], wr_aco_bits=aco[1], nt=NT, nr=NR, n_probe=5))
    assert tx_t.shape == tx_j.shape == (9, NT) and rx_t.shape == (9, NR)
    for i, hh in enumerate((vec, h2, h2)):
        np.testing.assert_allclose(
            _gain(hh.reshape(NT, NR), tx_t[i], rx_t[i]),
            _gain(hh.reshape(NT, NR), tx_j[i], rx_j[i]), rtol=1e-5)
    np.testing.assert_array_equal(_np(tx_t[3]), aco[0])
    np.testing.assert_array_equal(_np(rx_t[3]), aco[1])
    assert 0 <= int(tx_t[4:].min()) and int(rx_t[4:].max()) < 4


# ----------------------------------------------------------------- bayes_opt

def _bayes_inputs(seed, c, n, dtype=np.complex128, phases=4):
    rng = np.random.default_rng(seed)
    cand = np.exp(1j * rng.integers(0, phases, (c, n)) * 2 * np.pi / phases)
    return (cand / np.sqrt(n)).astype(dtype)


def _one_selection(monkeypatch):
    """Hand both packages' sensing-matrix builders one selection, the
    first M candidates, so the builders are held to JAX's given the same
    selection (the exchange itself is held to the plain exchange and to
    JAX's below, without a JAX compile per builder shape).  Returns what
    each package handed its selection: ``seen[tag] = (candidates, prior
    or None, m)``."""
    seen = {}

    def on_jax(key, cand, m, prior_k=None):
        # a callback: the builders run under jax.jit
        jax.debug.callback(lambda c, *p: seen.update(jax=(
            np.asarray(c), np.asarray(p[0]) if p else None, m)),
            cand, *(() if prior_k is None else (prior_k,)), ordered=True)
        return jnp.arange(m)

    def on_torch(generator, cand, m, prior_k=None):
        seen["torch"] = (_np(cand), None if prior_k is None
                         else _np(prior_k), m)
        return torch.arange(m)

    monkeypatch.setattr(jsm, "bayes_a_opt_select", on_jax)
    monkeypatch.setattr(tsm, "bayes_a_opt_select", on_torch)
    return seen


def _same_selection_inputs(seen, rtol=1e-5, atol=1e-6):
    for got, want in zip(seen["torch"], seen["jax"]):
        if want is None or np.isscalar(want):
            assert got == want
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _plain_exchange(cand, m, init, prior=None, weight=None, sweeps=2):
    """The A-optimal exchange with no algebra (complex128 numpy): for each
    slot, every candidate's swap re-inverts ``X^H X + K_u`` and takes
    ``sum_u Re trace(A inv(.))``; the best swap is kept under the same
    rule (the first sweep always, later ones below -sqrt(eps))."""
    n = cand.shape[1]
    prior = np.eye(n)[None] if prior is None else np.asarray(prior)
    weight = np.eye(n) if weight is None else np.asarray(weight)
    acutoff = -np.sqrt(np.finfo(np.float64).eps)

    def crit(rows):
        x = cand[rows]
        return sum(np.trace(weight @ np.linalg.inv(x.conj().T @ x + k)).real
                   for k in prior)

    rows = list(np.asarray(init))
    for i in range(sweeps * m):
        slot = i % m
        now = crit(rows)
        delta = np.array([crit(rows[:slot] + [c] + rows[slot + 1:])
                          for c in range(len(cand))]) - now
        idx = int(np.argmin(delta))
        if i < m or delta[idx] < acutoff:
            rows[slot] = idx
    return np.array(rows)


def _hermitian_pd(rng, n, floor):
    g = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    return g @ g.conj().T / n + floor * np.eye(n)


@pytest.mark.parametrize("case", ["one_user", "weighted_users",
                                  "complex_prior"])
def test_bayes_select_matches_plain_exchange(case):
    """The exchange's Sherman-Morrison algebra against the plain exchange
    in complex128, C 40, m 6, n 8, the same indices: one user with K = I
    (the default every sensing mode uses); two users with Hermitian
    (non-diagonal, complex) priors and a complex Hermitian weight A; two
    users with the complex diagonal noise prior of
    ``noise_prior_from_vech`` (not Hermitian, as directional_beam_bayes
    builds it)."""
    cand = _bayes_inputs(11, 40, 8)
    rng = np.random.default_rng(12)
    init = rng.integers(0, 40, 6)
    prior = weight = None
    if case == "weighted_users":
        prior = np.stack([_hermitian_pd(rng, 8, 0.5) for _ in range(2)])
        weight = _hermitian_pd(rng, 8, 0.2)
    elif case == "complex_prior":
        vh = rng.uniform(0.5, 2.0, (2, 8)) * np.exp(
            1j * rng.uniform(-1.0, 1.0, (2, 8)))
        prior = _np(tbo.noise_prior_from_vech(torch.tensor(vh), 0.0))
    want = _plain_exchange(cand, 6, init, prior, weight)
    got = tbo.bayes_a_opt_select(
        None, torch.tensor(cand), 6, initial=init,
        prior_k=None if prior is None else torch.tensor(prior),
        weight_a=None if weight is None else torch.tensor(weight))
    np.testing.assert_array_equal(_np(got), want)
    assert not np.array_equal(want, init)


def test_bayes_select_matches_jax_complex128():
    """Given JAX's initial design, the exchange picks JAX's indices in
    complex128 on real rows (BPSK), where JAX's starting matrix is the one
    its updates track: one user with K = I, and two users with diagonal
    priors and a weight A (the weighted product the default skips).  On
    complex rows JAX's picks do not lower the criterion of the initial
    design (its starting matrix is not the one its ``x x^H`` updates
    track); the port's do."""
    key, m = jax.random.PRNGKey(1), 6
    init = np.asarray(jax.random.randint(key, (m,), 0, 40))
    real = np.real(_bayes_inputs(6, 40, 8, phases=2)).astype(np.complex128)
    want = np.asarray(jbo.bayes_a_opt_select(key, jnp.asarray(real), m))
    got = tbo.bayes_a_opt_select(None, torch.tensor(real), m, initial=init)
    np.testing.assert_array_equal(_np(got), want)
    rng = np.random.default_rng(5)
    prior = np.stack([np.diag(rng.uniform(0.5, 2.0, 8)) for _ in range(2)])
    weight = np.diag(rng.uniform(0.5, 1.5, 8)).astype(np.complex128)
    want = np.asarray(jbo.bayes_a_opt_select(
        key, jnp.asarray(real), m, prior_k=jnp.asarray(prior),
        weight_a=jnp.asarray(weight)))
    got = tbo.bayes_a_opt_select(None, torch.tensor(real), m,
                                 prior_k=torch.tensor(prior),
                                 weight_a=torch.tensor(weight), initial=init)
    np.testing.assert_array_equal(_np(got), want)
    cand = _bayes_inputs(0, 40, 8)
    jax_sel = np.asarray(jbo.bayes_a_opt_select(key, jnp.asarray(cand), m))
    ours = _np(tbo.bayes_a_opt_select(None, torch.tensor(cand), m,
                                      initial=init))
    assert tbo.a_criterion(cand[ours]) < tbo.a_criterion(cand[init]) \
        <= tbo.a_criterion(cand[jax_sel])


def test_priors_match_jax():
    """prior_from_channel (complex64, float32 steering: rtol 1e-5) and
    noise_prior_from_vech (complex128: rtol 1e-12)."""
    h, vec = _channel()
    got = tbo.prior_from_channel(torch.tensor(h.T, dtype=torch.complex64),
                                 ARR_T, 9)
    want = _jax(lambda: jbo.prior_from_channel(
        jnp.asarray(h.T, jnp.complex64), ARR_J, 9))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    vh = np.stack([vec, vec * 0.5]).astype(np.complex128)
    vh[0, 3] = 0.0
    np.testing.assert_allclose(
        _np(tbo.noise_prior_from_vech(torch.tensor(vh), 3.0)),
        np.asarray(_jax(lambda: jbo.noise_prior_from_vech(jnp.asarray(vh),
                                                        3.0))),
        rtol=1e-12)


# ----------------------------------------------------- sensing-matrix modes

def test_sensing_modes_match_jax(monkeypatch):
    """The four modes that were ported last, at 4x4, Mt = 3, Mr = 2, batch
    2, against JAX's on JAX's draws (the random-gain beams' seed and the
    Bayes candidates handed over, one selection for both): F, W, FW and
    the measurement matrix within 1e-5; the Bayes mode hands its
    selection JAX's candidates and M."""
    key = jax.random.PRNGKey(7)
    ad_j = jnp.asarray(np.asarray(
        tsteer.angle_dictionary(ARR_T, 95.0, dtype=torch.complex128,
                                device="cpu")))
    ad_t = torch.tensor(np.asarray(ad_j))
    monkeypatch.setattr(tcb, "_beam_seed", lambda g, s: _jax_seed(key))
    cand = np.asarray(jcb.random_sensing_rows(key, 256, N))
    monkeypatch.setattr(tsm, "random_sensing_rows",
                        lambda *a, **k: torch.tensor(cand))
    seen = _one_selection(monkeypatch)
    for mode in ("Directional_Beam", "Directional_Random_Beam",
                 "Region_Random_Beam", "Random_Beam_Bayes"):
        call = lambda: jsm.generate_sensing_matrix(  # noqa: E731
            key, mode, 3, 2, ARR_J, ad_j, (-30.0, 30.0), (-30.0, 30.0),
            batch=2)
        # the directional beams are built on the host
        want = _jax(call) if mode == "Random_Beam_Bayes" else call()
        got = tsm.generate_sensing_matrix(None, mode, 3, 2, ARR_T, ad_t,
                                          (-30.0, 30.0), (-30.0, 30.0),
                                          batch=2)
        for f in want._fields:
            np.testing.assert_allclose(_np(getattr(got, f)),
                                       np.asarray(getattr(want, f)),
                                       atol=1e-5, err_msg=f"{mode} {f}")
    _same_selection_inputs(seen)


def test_bayes_beam_builders_match_jax(monkeypatch):
    """Both Bayes beam builders against JAX's, given one selection:
    the same candidates, per-user priors and M handed to the selection
    (complex64, rtol 1e-5), and the same rows or quantized beams from it:
    directional_beam_bayes with directional candidates (option 1) and
    the noise prior, directional_beam_bayes_v2 over a Tx dictionary with
    the channel priors.  Then the port's own picks lower the two-user
    criterion of its initial design.  Option 2's random candidates carry
    the reference's phase_bit**2 levels of pi/levels."""
    key = jax.random.PRNGKey(9)
    _, vec = _channel()
    vh = np.stack([vec, vec[::-1]]).astype(np.complex64)
    seen = _one_selection(monkeypatch)
    want = _jax(lambda: jsm.directional_beam_bayes(
        key, 2, 2, ARR_J, jnp.asarray(vh), snr_db=5.0, option=1,
        candidate_size=6))
    got = tsm.directional_beam_bayes(None, 2, 2, ARR_T, torch.tensor(vh),
                                     snr_db=5.0, option=1, candidate_size=6)
    np.testing.assert_allclose(_np(got.fw), np.asarray(want.fw), atol=1e-6)
    assert got.fw.shape == (2, 4, N) and not got.fw[1].abs().any()
    _same_selection_inputs(seen)

    ad = np.asarray(tsteer.dictionary(NT, 4 * NT, ARR_T.k_d, device="cpu"))
    h_users = np.stack([_channel(s)[0].T for s in (0, 1)]).astype(
        np.complex64)
    f_j, _ = _jax(lambda: jsm.directional_beam_bayes_v2(
        key, 2, 2, ARR_J, jnp.asarray(ad), jnp.asarray(h_users), snr_db=3.0))
    f_t, _ = tsm.directional_beam_bayes_v2(None, 2, 2, ARR_T,
                                           torch.tensor(ad),
                                           torch.tensor(h_users), snr_db=3.0)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-6)
    _same_selection_inputs(seen)
    monkeypatch.undo()
    gen = torch.Generator().manual_seed(1)
    _, sel = tsm.directional_beam_bayes_v2(gen, 2, 2, ARR_T, torch.tensor(ad),
                                           torch.tensor(h_users), snr_db=3.0)
    cand, prior, _ = seen["torch"]
    init = torch.randint(0, 181, (4,), generator=fold_in(gen, 11))
    assert tbo.a_criterion(cand[_np(sel)], prior) < \
        tbo.a_criterion(cand[_np(init)], prior)

    got = tsm.directional_beam_bayes(torch.Generator().manual_seed(2), 2, 2,
                                     ARR_T, torch.tensor(vh), option=2,
                                     candidate_size=5)
    rows = got.fw[0]
    assert torch.allclose(rows.abs(), torch.full_like(rows.abs(),
                                                      1 / math.sqrt(N)))
    # each row is kron(f, conj(w)): its phases are differences of levels
    steps = torch.remainder(torch.angle(rows * math.sqrt(N)),
                            2 * math.pi) / (math.pi / 4)
    assert torch.allclose(steps, torch.round(steps), atol=1e-4)


def test_pick_beams_bayes_beam():
    """Bayes_Beam picks through bayes_a_opt_select over a with-replacement
    candidate draw (the selection itself is held to the plain exchange
    above): M
    indices of the codebook whose design beats the initial one."""
    cb = torch.tensor(_bayes_inputs(3, 60, N, np.complex64))
    gen = torch.Generator().manual_seed(4)
    idx = tsm.pick_beams(gen, "Bayes_Beam", 8, cb)
    cand_idx = torch.randint(0, 60, (60,),
                             generator=torch.Generator().manual_seed(4))
    init = torch.randint(0, 60, (8,), generator=fold_in(
        torch.Generator().manual_seed(4), 1))
    assert idx.shape == (8,)
    assert tbo.a_criterion(cb[idx]) < tbo.a_criterion(cb[cand_idx[init]])


# ------------------------------------------------------- native: brd, TCP

native = pytest.mark.skipif(shutil.which("g++") is None,
                            reason="no C++ toolchain")


@native
def test_codebook_image_roundtrip(tmp_path):
    """The port's TBRD binding over native/libtbrd.so, as
    tests/test_native.py holds JAX's: sectors, counts, the module mask,
    corruption, and the generator scripts' output set."""
    from twoace_tpu_torch.sensing.brd import (CodebookImage,
                                              export_codebook_set,
                                              read_phase_table)

    p = str(tmp_path / "rx.tbrd")
    img = CodebookImage.create(p, n_ant=16, n_sectors=4)
    assert img.info() == (16, 4, 4, 0xFFFFFFFF)
    phases = np.random.default_rng(0).integers(0, 4, (4, 16))
    img.set_all(phases)
    amp, back = img.get_all()
    np.testing.assert_array_equal(back, phases)
    np.testing.assert_array_equal(amp, np.full((4, 16), 7))
    img.set_beam(2, np.arange(16) % 4, amp=np.full(16, 3))
    a2, p2 = img.get_beam(2)
    np.testing.assert_array_equal(p2, np.arange(16) % 4)
    np.testing.assert_array_equal(a2, np.full(16, 3))
    img.set_beam_num(3)
    img.enable_modules(0b0101)
    assert img.info() == (16, 4, 3, 0b0101)
    raw = bytearray(open(p, "rb").read())
    raw[-1] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    with pytest.raises(OSError, match="checksum"):
        img.get_all()
    bits = np.random.default_rng(1).integers(0, 4, (6, 8))
    paths = export_codebook_set(str(tmp_path), "rx_random", bits)
    assert len(paths) == 6
    np.testing.assert_array_equal(CodebookImage(paths[2]).get_all()[1][0],
                                  bits[2])
    np.testing.assert_array_equal(
        read_phase_table(str(tmp_path / "rx_random.txt")), bits)


@native
def test_tcp_provider_roundtrip():
    """The port's TcpProvider against native/rss_server, rows given as a
    tensor: noiseless RSS within one RSSI step of 10 log10 |rows h|^2
    (atol 0.04 dB, as tests/test_native.py), the noise's median near
    truth, the zero channel at the calibration floor, and a protocol
    error surfaced."""
    from twoace_tpu_torch.sensing.tcp_provider import (ServerProcess,
                                                       TcpProvider)

    rng = np.random.default_rng(0)
    h = (rng.normal(size=N) + 1j * rng.normal(size=N)) * 1e-3
    rows = rng.normal(size=(5, N)) + 1j * rng.normal(size=(5, N))
    expect = 10 * np.log10(np.abs(rows @ h) ** 2)
    with ServerProcess(n_dumps=11) as srv:
        prov = TcpProvider(port=srv.port)
        try:
            prov.set_channel(torch.tensor(h))
            prov.set_noise(0.0)
            np.testing.assert_allclose(prov.measure(torch.tensor(rows)),
                                       expect, atol=0.04)
            prov.set_noise(1.0, seed=7)
            assert np.abs(prov.measure(rows) - expect).max() < 1.5
            prov.set_channel(np.zeros(N, complex))
            np.testing.assert_allclose(prov.measure(rows), -74.3875,
                                       atol=1e-6)
            assert "error" in prov._rpc({"cmd": "bogus"})
        finally:
            prov.close()
