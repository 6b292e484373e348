"""The port's testbed driver (``twoace_tpu_torch.pipeline.testbed``, with
``utils.checkpoint``) and its Z-free solver branch against the JAX
package's, on the CPU.

The campaigns run at 4x4 with few rounds through noiseless providers in
both packages; the port is handed JAX's random and multires bits, so the
probe rows and the RSS agree to rounding.  The estimation draws its own
probe subsets and restarts (torch generators, not JAX keys), so both
packages estimate from the same rows and RSS, at one grid point (the
whole 64-row budget: JAX compiles its solver once per shape, about 12 s
with one restart) and are held within 1 dB NMSE.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jpair, np_pair, steer, tpair
from twoace_tpu import config as jcfg
from twoace_tpu.ops import pair_solver as jps
from twoace_tpu.pipeline import recovery as jrec
from twoace_tpu.pipeline import testbed as jtb
from twoace_tpu.sensing import codebooks as jcb
from twoace_tpu.sensing import provider as jprov
from twoace_tpu.utils import checkpoint as jck
from twoace_tpu.utils import spectral_analysis as jspec
from twoace_tpu_torch import config as tcfg
from twoace_tpu_torch.ops import pair_solver as tps
from twoace_tpu_torch.pipeline import recovery as trec
from twoace_tpu_torch.pipeline import testbed as ttb
from twoace_tpu_torch.sensing import provider as tprov
from twoace_tpu_torch.utils import checkpoint as tck
from twoace_tpu_torch.utils import profiling as tprof
from twoace_tpu_torch.utils import spectral_analysis as tspec
from twoace_tpu_torch.utils.metrics import nmse_h_projection

NT = NR = 4
N = NT * NR
ROUNDS, SECTORS, MULTIRES = 8, 8, (2, 3, 3)


def _channel():
    """A two-path 4x4 vec(H) at testbed power (about -50 dBm a probe)."""
    return 3e-4 * sum(
        g * np.outer(steer(NR, ar), steer(NT, at).conj()).T.reshape(-1)
        for g, ar, at in ((1.0, 0.3, -0.5), (0.5j, -0.7, 0.2)))


def _configs(**kw):
    base = dict(n_theta_phi=4, n_phi=4, n_directional=4,
                n_random_rounds=ROUNDS, sectors_per_round=SECTORS,
                multires_rounds=MULTIRES)
    base.update(kw)
    return (jtb.TestbedConfig(array=jcfg.ArrayConfig(nt=NT, nr=NR), **base),
            ttb.TestbedConfig(array=tcfg.ArrayConfig(nt=NT, nr=NR), **base))


#: the campaigns held to JAX's, at one sector a round: JAX compiles each
#: new eager shape on its first use (seconds on the CPU), so every round's
#: probe has the same (1, n) shape
SMALL = dict(n_theta_phi=4, n_phi=4, n_directional=1, n_random_rounds=4,
             sectors_per_round=1, multires_rounds=(1, 1, 2))


def _jax_bits(key, cfg):
    """The random and multires campaigns' bits as JAX's runner draws them
    (testbed.py:124-127, :199-203)."""
    rounds, sectors = cfg.n_random_rounds, cfg.sectors_per_round
    k1, k2 = jax.random.split(jax.random.fold_in(key, 4))
    random = (jcb.random_codebook(k1, rounds * sectors, NT).bits,
              jcb.random_codebook(k2, rounds, NR).bits)
    k1, k2 = jax.random.split(jax.random.fold_in(key, 5))
    tiers = tuple(cfg.multires_rounds)
    multires = (jcb.multires_codebook(k2, NT, tuple(r * sectors
                                                    for r in tiers))[0].bits,
                jcb.multires_codebook(k1, NR, tiers)[0].bits)
    return [tuple(np.asarray(b) for b in bits) for bits in (random, multires)]


def _runners(tmp_path=None, **kw):
    """A JAX and a port runner on the same channel through noiseless,
    unquantized synthetic providers."""
    x = _channel()
    cfg_j, cfg_t = _configs(checkpoint_dir=None if tmp_path is None
                            else str(tmp_path), **kw)
    run_j = jtb.TestbedRunner(cfg_j, jprov.SyntheticProvider(
        vec_h=jnp.asarray(x), noise_dbm_std=0.0, quantize_rssi=False),
        key=jax.random.PRNGKey(0))
    run_t = ttb.TestbedRunner(cfg_t, tprov.SyntheticProvider(
        vec_h=torch.tensor(x), noise_dbm_std=0.0, quantize_rssi=False),
        device="cpu")
    return run_j, run_t, x


def test_campaigns_match_jax_given_its_bits():
    """All five campaigns at 4x4, at their fewest rounds: the same probe
    rows (to 1e-6: the port's rows are complex64, JAX's complex128 under
    x64) and the same
    noiseless RSS (to 1e-4 dB), one provider call a round; the ACO
    sweep's codewords equal."""
    run_j, run_t, _ = _runners(**SMALL)
    random_bits, multires_bits = _jax_bits(jax.random.PRNGKey(0), run_t.cfg)
    run_j.run_sweep_campaigns().run_directional_campaign()
    run_j.run_random_campaign().run_multires_campaign()
    calls = run_t.provider._calls
    run_t.run_sweep_campaigns().run_directional_campaign()
    assert run_t.provider._calls - calls == 4 + 4 + 1
    run_t.run_random_campaign(*random_bits)
    run_t.run_multires_campaign(*multires_bits)
    assert sorted(run_t.results) == sorted(run_j.results) == [
        "directional", "multires", "phi", "random", "theta_phi"]
    for name, want in run_j.results.items():
        got = run_t.results[name]
        np.testing.assert_allclose(got["rows"].numpy(), want["rows"],
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got["rss_dbm"], want["rss_dbm"],
                                   atol=1e-4, err_msg=name)
    for got, want in zip(run_t.collect_aco(), run_j.collect_aco()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # drawn by the port itself: the same shapes, rows of unit modulus
    run_t.run_random_campaign()
    rows = run_t.results["random"]["rows"]
    assert rows.shape == (4, N)
    np.testing.assert_allclose(rows.abs().numpy(), 1.0, atol=1e-6)


def test_checkpoint_resume_and_store_interop(tmp_path):
    """A second runner on the same checkpoint_dir loads every stored
    round (no provider call, bit-identical RSS) and measures only the
    missing ones; the port's CampaignStore reads what JAX's wrote and
    the reverse."""
    _, run_t, x = _runners(tmp_path)
    first = run_t.run_random_campaign().results["random"]["rss_dbm"]
    prov = tprov.SyntheticProvider(vec_h=torch.tensor(x), noise_dbm_std=3.0)
    again = ttb.TestbedRunner(run_t.cfg, prov, device="cpu")
    assert np.array_equal(
        again.run_random_campaign().results["random"]["rss_dbm"], first)
    assert prov._calls == 0
    os.remove(os.path.join(str(tmp_path), "random_00002.npz"))
    resumed = again.run_random_campaign().results["random"]["rss_dbm"]
    assert prov._calls == 1
    changed = np.flatnonzero(resumed != first)
    assert len(changed) and np.all(changed % ROUNDS == 2)  # round 2 only
    store_j, store_t = jck.CampaignStore(str(tmp_path)), tck.CampaignStore(
        str(tmp_path))
    assert store_t.completed_rounds("random") == store_j.completed_rounds(
        "random") == list(range(ROUNDS))
    store_j.save("jax", {"a": np.arange(3.0)}, 7)
    np.testing.assert_array_equal(store_t.load("jax", 7)["a"], np.arange(3.0))
    store_t.save("aco", {"b": np.ones(2)})
    np.testing.assert_array_equal(store_j.load("aco")["b"], np.ones(2))
    assert store_t.load("missing") is None


def test_estimate_and_beams_match_jax(monkeypatch, tmp_path):
    """``estimate("random", "a2only")`` of both packages on the port's
    noisy 64-row campaign (0.3 dB jitter, RSSI words) at one grid point,
    M 64: NMSE within 1 dB of JAX's (both near -8 dB).  Then
    beamforming_comparison of the same estimates through noiseless
    providers, its RSS equal to JAX's to 1e-4 dB (the port's rows are
    complex64; the SVD bits may differ by each SVD's phase, not by their
    gain), and the evaluation codebook's SVD and ACO beams at those RSS
    (less 10 log10(n) dB: unit-norm rows) and JAX's provider's (the
    codebook itself is held to JAX's in test_torch_sensing.py)."""
    x = _channel()
    _, cfg_t = _configs(checkpoint_dir=str(tmp_path))
    run_t = ttb.TestbedRunner(cfg_t, tprov.SyntheticProvider(
        vec_h=torch.tensor(x), noise_dbm_std=0.3), device="cpu")
    data = run_t.run_random_campaign().results["random"]
    run_j, _, _ = _runners()
    # JAX solves the same rows in complex128 (its while_loop wants one
    # precision throughout under x64)
    run_j.results["random"] = {
        "rows": data["rows"].numpy().astype(np.complex128),
        "rss_dbm": data["rss_dbm"]}
    for mod in (jrec, trec):
        monkeypatch.setattr(mod, "probe_budget_grid",
                            lambda nt, nr: (ROUNDS * SECTORS,))
    cc = dict(n_paths=2, admm=dict(maxiter=300, n_restarts=1))
    out_j = run_j.estimate("random", "a2only", cc=jrec.CampaignConfig(
        array=jcfg.ArrayConfig(nt=NT, nr=NR), n_paths=2,
        admm=jcfg.AdmmConfig(**cc["admm"])))
    out_t = run_t.estimate("random", "a2only", cc=trec.CampaignConfig(
        array=tcfg.ArrayConfig(nt=NT, nr=NR), n_paths=2,
        admm=tcfg.AdmmConfig(**cc["admm"])))
    assert out_t.m_grid == tuple(out_j.m_grid) == (ROUNDS * SECTORS,)
    assert os.path.exists(os.path.join(str(tmp_path),
                                       "estimate_random_a2only_1.npz"))
    ests = [o.h_amp[0, 0] * np.exp(1j * o.h_angle[0, 0])
            for o in (out_t, out_j)]
    db = [10 * np.log10(float(nmse_h_projection(torch.tensor(e)[None],
                                                torch.tensor(x)[None])[0]))
          for e in ests]
    assert abs(db[0] - db[1]) <= 1.0 and db[0] < -5, db

    run_j, run_t, _ = _runners()
    est = {"a2only": ests[0], "true": x}
    bf_t = run_t.beamforming_comparison(est)
    bf_j = run_j.beamforming_comparison(est)
    for k in est:
        assert bf_t[k] == pytest.approx(bf_j[k], abs=1e-4)
    aco = (np.arange(NT) % 4, np.arange(NR)[::-1] % 4)
    rss_t, tx_t, rx_t = run_t.evaluate_codebook_rss(
        np.stack(list(est.values())), aco_bits=aco)
    assert tx_t.shape == (53, NT) and rx_t.shape == (53, NR)
    # its SVD beams are beamforming_comparison's at 1/sqrt(n) amplitude,
    # its ACO beam JAX's provider's on the same row
    np.testing.assert_allclose(
        rss_t[:2], [bf_j[k] - 10 * np.log10(N) for k in est], atol=1e-4)
    aco_row = np.kron(np.exp(0.5j * np.pi * aco[0]) / np.sqrt(NT),
                      np.exp(0.5j * np.pi * aco[1]) / np.sqrt(NR))
    assert rss_t[2] == pytest.approx(
        float(run_j.provider.measure(jnp.asarray(aco_row[None]))[0]),
        abs=1e-4)
    assert np.isfinite(rss_t).all()


def test_thermal_guard_and_device():
    """The guard waits after every measured round; the runner builds on
    the card unless asked for the CPU."""
    _, run_t, x = _runners()
    waits = []
    run_t.guard = tprov.ThermalGuard(read_temps=lambda: (60.0, 50.0),
                                     sleep_fn=waits.append)
    reads = []
    run_t.guard.read_temps = lambda: reads.append(1) or (60.0, 50.0)
    run_t.run_random_campaign()
    assert len(reads) == ROUNDS and not waits
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttb.TestbedRunner(run_t.cfg, run_t.provider)


# ------------------------------------------------------------- utilities

SPECTRA = ("singular_profile", "captured_energy", "eig_decay", "nuclear_norm")


def test_spectral_analysis_and_profiling_match_jax():
    """The spectral-profile analysis of a batch of 4x4 channels (complex128:
    within 1e-10), and the recorder: nothing kept and one shared no-op
    span without a profiler; under one, nested spans with their parent
    and call ids on the host clock, a loop's lane trips read from its
    tensor at the snapshot, and a barrier on a tensor tree."""
    rng = np.random.default_rng(4)
    h = rng.normal(size=(3, NT, NR)) + 1j * rng.normal(size=(3, NT, NR))
    h[0] = np.outer(steer(NT, 0.2), steer(NR, -0.4))       # rank one
    ht, hj = torch.tensor(h), jnp.asarray(h)
    # JAX's side under one jax.jit: one compile in place of one per op
    want = jax.jit(lambda x: (
        [getattr(jspec, name)(x) for name in SPECTRA],
        jspec.l1_norm(x.reshape(3, -1)), jspec.power_law_fit(x),
        jspec.ladder_deviation(x, NT, NR)))(hj)
    for name, w in zip(SPECTRA, want[0]):
        np.testing.assert_allclose(getattr(tspec, name)(ht).numpy(),
                                   np.asarray(w), atol=1e-10, err_msg=name)
    np.testing.assert_allclose(tspec.l1_norm(ht.reshape(3, -1)).numpy(),
                               np.asarray(want[1]), atol=1e-10)
    for got, w in zip(tspec.power_law_fit(ht), want[2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-10)
    got, want = tspec.ladder_deviation(ht, NT, NR), want[3]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-10)

    tprof.reset()
    assert tprof.span("a") is tprof.span("b")
    with tprof.span("pair.single"):
        tprof.record_trips("per-op", 2, 8, N, "k2", 3, 5, torch.ones(3))
    assert tprof.snapshot() == ([], [])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tprof.span("a") is not tprof.span("b")
        with tprof.span("pair.single"):
            with tprof.span("setup.splits"):
                pass
            with tprof.span("stage.refine"):
                it = torch.tensor([[4, 7]], dtype=torch.int32)
                tprof.record_trips("per-op", 1, 8, N, "k2", 2, 7, it)
        with tprof.span("pair.single"):
            pass
    it += 100                          # read at the snapshot, not before
    spans, trips = tprof.snapshot()
    assert [(sp.name, sp.parent, sp.call) for sp in spans] == [
        ("pair.single", -1, 0), ("setup.splits", 0, 0),
        ("stage.refine", 0, 0), ("pair.single", -1, 3)]
    assert all(sp.start_ns <= sp.end_ns for sp in spans)
    assert (spans[0].start_ns <= spans[1].start_ns <= spans[2].end_ns
            <= spans[0].end_ns <= spans[3].start_ns)
    assert trips == [tprof.Trips("per-op", 1, 8, N, "k2", 2, 7, 211, 2, 0)]
    tprof.sync({"x": [ht, (ht,)]})
    tprof.reset()
    assert tprof.snapshot() == ([], [])


# ------------------------------------------------------ the Z-free branch

def _zfree_problem():
    rng = np.random.default_rng(0)
    m, r = 48, 3
    a = ((rng.normal(size=(m, N)) + 1j * rng.normal(size=(m, N)))
         / np.sqrt(2)).astype(np.complex64)
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    x0 = (rng.normal(size=(r, N)) + 1j * rng.normal(size=(r, N))).astype(
        np.complex64)
    return a, np.abs(a @ x).astype(np.float32), x0


def _gauge(x, scale_by_row):
    """The Z-free iterate up to its gauge: sum_k x_k x_k^H of the row pass's
    (r, n) iterate; the per-column pass's vector with its phase fixed."""
    if scale_by_row:
        return x.T @ x.conj()
    return x * np.exp(-1j * np.angle(x[np.argmax(np.abs(x))]))


@pytest.mark.parametrize("scale_by_row", [True, False])
def test_zfree_infer_admm_pair_matches_jax(scale_by_row):
    """infer_admm_pair with no ladder (JAX's has_z false) from the same x0
    and the same (m, n) operator pinv(A)^H: the best iterate, up to its
    gauge (a magnitude-only fit fixes no phase), within 1e-4 of JAX's
    scale.  The row pass runs JAX's trip count exactly; the per-column
    pass stops within 10% of it (its stopping trip moves by several under
    a 1e-6 change of b in either package).  The port's own pinv_u_pair
    (u_mat=None) lands on the same iterate."""
    a, b, x0 = _zfree_problem()
    u = np.linalg.pinv(a).conj().T.astype(np.complex64)
    kw = dict(scale_by_row=scale_by_row, nt=NT, nr=NR, maxiter=200)
    x_j, _, _, it_j = jps.infer_admm_pair(jpair(a), jnp.asarray(b), jpair(x0),
                                          ladder=None, u_mat=jpair(u),
                                          use_pallas=False, **kw)
    args = (tpair(a[None]), torch.tensor(b)[None, None],
            tpair(x0[None, None]))
    x_t, _, conv, it_t = tps.infer_admm_pair(*args, u_mat=tpair(u[None]),
                                             **kw)
    x_p, _, _, _ = tps.infer_admm_pair(*args, **kw)
    xj = np_pair(x_j)
    want = _gauge((xj[0] + 1j * xj[1]).reshape(-1, N).squeeze(0)
                  if not scale_by_row else xj[0] + 1j * xj[1], scale_by_row)
    for got in (x_t, x_p):
        xt = np_pair(got)
        xt = (xt[0] + 1j * xt[1])[0, 0]
        np.testing.assert_allclose(
            _gauge(xt if scale_by_row else xt[0], scale_by_row), want,
            atol=1e-4 * np.abs(want).max())
    if scale_by_row:
        assert int(it_t[0, 0]) == int(it_j)
    else:
        assert abs(int(it_t[0, 0]) - int(it_j)) <= 0.1 * int(it_j)
    assert bool(conv[0, 0])
