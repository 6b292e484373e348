"""The port's testbed recovery campaign (``twoace_tpu_torch.pipeline.recovery``)
and what it is built from (``utils.units``, ``sensing.provider``,
``sensing.sensing_matrix.pick_beams``, ``ops.dispatch.recover_channel``
with its lifted entries, the ``interop`` converters) against the JAX
package's, on the CPU.

The campaign runs at 4x4 through a 64-row 2-bit codebook and a noiseless
two-path channel, both packages fed the same numpy codebook and RSS trace.
Their random streams differ (torch generators, not JAX keys), so they are
compared on each grid point's NMSE against the channel and on quality.
JAX compiles its A2 solver once per shape and configuration (about 12 s
with one restart on the CPU), so the campaign uses one restart and one
grid shape, m = 48, which the warm sweep's two points share.  The lifted
entries (PhaseLift, PLOMP, PLGAMP) draw nothing: given JAX's probe
subsets they agree with JAX to rounding at every grid point.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nmse_db, steer
from twoace_tpu import config as jcfg
from twoace_tpu.models import steering as jsteer
from twoace_tpu.ops import admm as jadmm
from twoace_tpu.ops import dispatch as jdisp
from twoace_tpu.pipeline import recovery as jrec
from twoace_tpu.sensing import provider as jprov
from twoace_tpu.utils import units as junits
from twoace_tpu_torch import interop
from twoace_tpu_torch import config as tcfg
from twoace_tpu_torch.models import steering as tsteer
from twoace_tpu_torch.ops import admm as tadmm
from twoace_tpu_torch.ops import dispatch as tdisp
from twoace_tpu_torch.pipeline import recovery as trec
from twoace_tpu_torch.sensing import provider as tprov
from twoace_tpu_torch.sensing.sensing_matrix import pick_beams
from twoace_tpu_torch.utils import units as tunits

NT = NR = 4
N = NT * NR


def _testbed(seed=0, total=64):
    """A 2-bit codebook, a two-path channel scaled to testbed power, and
    its noiseless RSS in dBm (numpy)."""
    rng = np.random.default_rng(seed)
    cb = np.exp(1j * rng.integers(0, 4, (total, N)) * (np.pi / 2)) / np.sqrt(N)
    x = 3e-4 * sum(gain * np.outer(steer(NR, ar), steer(NT, at).conj())
                   .T.reshape(-1)
                   for gain, ar, at in ((1.0, 0.3, -0.5), (0.5j, -0.7, 0.2)))
    return cb, x, 10 * np.log10(np.abs(cb @ x) ** 2)


def _estimate(out, i, j=0):
    return out.h_amp[i, j] * np.exp(1j * out.h_angle[i, j])


def test_units_match_jax():
    x = np.array([-74.3875, -50.0, -12.5, 3.0])
    for name in ("db2pow", "rssi_to_dbm", "dbm_to_amplitude"):
        np.testing.assert_allclose(getattr(tunits, name)(torch.tensor(x)),
                                   np.asarray(getattr(junits, name)(x)),
                                   rtol=1e-14)
    p = np.array([1e-6, 0.5, 7.0])
    for name in ("pow2db", "amplitude_to_dbm"):
        np.testing.assert_allclose(getattr(tunits, name)(torch.tensor(p)),
                                   np.asarray(getattr(junits, name)(p)),
                                   rtol=1e-14)
    np.testing.assert_allclose(
        tunits.amplitude_to_dbm(tunits.dbm_to_amplitude(torch.tensor(x))),
        x, atol=1e-12)
    assert (tunits.RSSI_SLOPE, tunits.RSSI_OFFSET) == \
        (junits.RSSI_SLOPE, junits.RSSI_OFFSET)


@pytest.mark.parametrize("quantize", [False, True])
def test_synthetic_provider_chain_matches_jax(quantize):
    """Without jitter the forward chain is deterministic: the same dBm as
    JAX's (and on the RSSI word grid when quantized)."""
    cb, x, _ = _testbed()
    kw = dict(noise_dbm_std=0.0, quantize_rssi=quantize, tx_power_dbm=2.0)
    want = jprov.SyntheticProvider(vec_h=jnp.asarray(x), **kw).measure(
        jnp.asarray(cb))
    got = tprov.SyntheticProvider(vec_h=torch.tensor(x), **kw).measure(
        torch.tensor(cb))
    assert isinstance(got, np.ndarray) and got.shape == (64,)
    np.testing.assert_allclose(got, want, atol=1e-9)
    if quantize:
        words = (got - tunits.RSSI_OFFSET) / tunits.RSSI_SLOPE
        np.testing.assert_allclose(words, np.round(words), atol=1e-6)


def test_synthetic_provider_jitter_and_faults():
    cb, x, clean = _testbed()
    prov = tprov.SyntheticProvider(vec_h=torch.tensor(x), quantize_rssi=False,
                                   generator=torch.Generator().manual_seed(4))
    first, second = prov.measure(cb), prov.measure(cb)
    assert not np.array_equal(first, second)      # call k draws fold_in(k)
    again = tprov.SyntheticProvider(
        vec_h=torch.tensor(x), quantize_rssi=False,
        generator=torch.Generator().manual_seed(4)).measure(cb)
    np.testing.assert_array_equal(first, again)
    # the median of 10 dumps of 0.5 dB jitter: about 0.2 dB off the truth
    assert 0.05 < np.std(first - clean) < 0.5
    # numpy's even-count median: the mean of the two middle dumps
    d = torch.tensor([[3.0, 1.0], [1.0, 5.0], [2.0, 2.0], [4.0, 3.0]])
    np.testing.assert_array_equal(tprov._median(d).numpy(), [2.5, 2.5])
    failing = tprov.SyntheticProvider(vec_h=torch.tensor(x), fail_rate=1.0)
    with pytest.raises(ConnectionError):
        failing.measure(cb)
    resets = []
    retry = tprov.RetryingProvider(failing, max_retries=3,
                                   reset_hook=lambda: resets.append(1))
    with pytest.raises(RuntimeError, match="after 3 retries"):
        retry.measure(cb)
    assert len(resets) == 3
    replay = tprov.ReplayProvider(np.arange(5.0))
    np.testing.assert_array_equal(replay.measure(np.zeros((3, 2))),
                                  [0.0, 1.0, 2.0])
    with pytest.raises(EOFError):
        replay.measure(np.zeros((3, 2)))
    temps = iter([(80.0, 50.0), (60.0, 70.0), (60.0, 50.0)])
    slept = []
    guard = tprov.ThermalGuard(read_temps=lambda: next(temps),
                               sleep_fn=slept.append)
    assert guard.wait_until_cool() == 2 and slept == [20.0, 20.0]


def test_pick_beams():
    """The Random_Phase_State pick takes the first rows; Bayes_Beam (which
    raised before bayes_opt was ported) picks M distinct rows of the
    codebook (held against JAX in test_torch_sensing.py)."""
    cb = torch.zeros(10, 3)
    assert torch.equal(pick_beams(None, "Random_Phase_State", 4, cb),
                       torch.arange(4))
    rows = torch.polar(torch.ones(10, 3), torch.linspace(0, 6, 30)
                       .reshape(10, 3) ** 2)
    idx = pick_beams(torch.Generator().manual_seed(0), "Bayes_Beam", 4, rows)
    assert idx.shape == (4,) and 0 <= int(idx.min()) \
        and int(idx.max()) < 10
    with pytest.raises(ValueError, match="unknown"):
        pick_beams(None, "Sweep", 4, cb)


def test_lifted_methods_raise_and_pass_through():
    """The lifted methods run in recover_channel (PLOMP and PLGAMP raise
    ValueError without the sparse dictionary, as in JAX); the
    beamforming-time dispatcher passes earlier estimates through."""
    cb, x, _ = _testbed()
    b = torch.tensor(np.abs(cb @ x))
    cfg = tcfg.ArrayConfig(nt=NT, nr=NR)
    pl = tcfg.PhaseLiftConfig(max_iters=20)
    out = tdisp.recover_channel(
        None, b, torch.tensor(cb),
        tcfg.MethodFlags(admm_lowrank_v4=False, phaselift=True), cfg, s=2,
        pl_cfg=pl)
    assert set(out) == {"phaselift"} and out["phaselift"].shape == (N,)
    for flag in ("plomp", "plgamp"):
        flags = tcfg.MethodFlags(admm_lowrank_v4=False, **{flag: True})
        with pytest.raises(ValueError, match="dictionary AD"):
            tdisp.recover_channel(None, b, torch.tensor(cb), flags, cfg, s=2)
    ok = tdisp.recover_channel_bf(
        None, b, torch.tensor(cb),
        tcfg.MethodFlags(admm_lowrank_v4=False, phaselift=True), cfg,
        recovered={"phaselift": torch.ones(N)})
    assert set(ok) == {"phaselift"}
    with pytest.raises(ValueError, match="absent"):
        tdisp.recover_channel_bf(
            None, b, torch.tensor(cb),
            tcfg.MethodFlags(admm_lowrank_v4=False, plomp=True), cfg, {})


def _loud_testbed(total):
    """_testbed's codebook and channel 40 dB louder: at -77 dBm the
    lifted methods' intensities ((b / 2e5)^2 * 1e10, about 5e-3) lie
    below PhaseLift's trace weight and every estimate is 0."""
    cb, x, _ = _testbed(total=total)
    x = 100.0 * x
    return cb, x, 10 * np.log10(np.abs(cb @ x) ** 2)


def test_recover_channel_lifted_entries_match_jax():
    """PhaseLift, PLOMP and PLGAMP through the testbed's scaling chain on
    the same amplitudes, probe rows and dictionary (95 degrees), at 60
    FISTA trips: the estimates agree to 1e-8 of the largest entry after
    phase alignment (the lifted eigenvector's phase is free; PLOMP and
    PLGAMP share theirs)."""
    cb, _, rss = _loud_testbed(48)
    b = np.asarray(junits.dbm_to_amplitude(jnp.asarray(rss), 1e5 / 3.0))
    names = ("phaselift", "plomp", "plgamp")
    kw_j = dict(pl_cfg=jcfg.PhaseLiftConfig(max_iters=60),
                ts_cfg=jcfg.TwoStageConfig(
                    phaselift=jcfg.PhaseLiftConfig(max_iters=60)))
    kw_t = dict(pl_cfg=tcfg.PhaseLiftConfig(max_iters=60),
                ts_cfg=tcfg.TwoStageConfig(
                    phaselift=tcfg.PhaseLiftConfig(max_iters=60)))
    cj, ct = jcfg.ArrayConfig(nt=NT, nr=NR), tcfg.ArrayConfig(nt=NT, nr=NR)
    ad_j = jsteer.angle_dictionary(cj, 95.0, dtype=jnp.complex128)
    ad_t = tsteer.angle_dictionary(ct, 95.0, dtype=torch.complex128,
                                   device="cpu")
    want = jdisp.recover_channel(
        None, jnp.asarray(b), jnp.asarray(cb),
        jcfg.MethodFlags(admm_lowrank_v4=False, **{k: True for k in names}),
        cj, s=2, ad=ad_j, **kw_j)
    got = tdisp.recover_channel(
        None, torch.tensor(b), torch.tensor(cb),
        tcfg.MethodFlags(admm_lowrank_v4=False, **{k: True for k in names}),
        ct, s=2, ad=ad_t, **kw_t)
    assert sorted(got) == sorted(want) == sorted(names)
    for name in names:
        g, w = got[name].numpy(), np.asarray(want[name])
        g = g * np.exp(1j * np.angle(np.vdot(g, w)))
        assert np.abs(w).max() > 0
        assert np.abs(g - w).max() <= 1e-8 * np.abs(w).max(), name


def _jax_probe_subsets(monkeypatch, jcc, total):
    """Hand the port's campaign JAX's probe subset at every grid point."""
    key = jax.random.PRNGKey(jcfg.SEED_TABLE[0])
    subsets = [torch.tensor(np.asarray(jrec._pick_m_indices(
        jax.random.fold_in(key, i), min(m, total), total, jcc)))
        for i, m in enumerate(tcfg.probe_budget_grid(NT, NR))]
    monkeypatch.setattr(trec, "_pick_m_indices",
                        lambda *args: subsets.pop(0))
    return subsets


@pytest.mark.parametrize("entry", ["recover_phaselift",
                                   "recover_directional"])
def test_lifted_campaign_entries_match_jax(monkeypatch, entry):
    """recover_phaselift (95 degrees) and recover_directional (2.9 mm,
    180 degrees) over the 4 x 4 probe-budget grid of a 9-row codebook
    (budgets capped at 9 rows), the port handed JAX's probe subsets: the
    default 4000 FISTA trips a point, every estimate within 1e-8 of JAX's
    after phase alignment (1e-10 measured)."""
    cb, _, rss = _loud_testbed(9)
    jcc = jrec.CampaignConfig(array=jcfg.ArrayConfig(nt=NT, nr=NR),
                              n_paths=2)
    if entry == "recover_directional":
        jcc = dataclasses.replace(
            jcc, array=jcfg.ArrayConfig(nt=NT, nr=NR, spacing=2.9e-3),
            searching_area_deg=180.0)
    tcc = interop.campaign_config_from_dict(dataclasses.asdict(jcc))
    subsets = _jax_probe_subsets(monkeypatch, jcc, 9)
    want = getattr(jrec, entry)(jnp.asarray(cb), jnp.asarray(rss), 1, jcc)
    got = getattr(trec, entry)(cb, rss, 1, tcc, device="cpu")
    assert not subsets
    assert got.methods == want.methods == (
        ("phaselift",) if entry == "recover_phaselift"
        else ("plomp", "plgamp"))
    assert got.m_grid == want.m_grid == tcfg.probe_budget_grid(NT, NR)
    for i in range(len(got.m_grid)):
        for j in range(len(got.methods)):
            g, w = _estimate(got, i, j), _estimate(want, i, j)
            g = g * np.exp(1j * np.angle(np.vdot(g, w)))
            assert np.abs(w).max() > 0
            assert np.abs(g - w).max() <= 1e-8 * np.abs(w).max(), (i, j)


def test_interop_carries_campaign_configs():
    jcc = jrec.CampaignConfig(array=jcfg.ArrayConfig(nt=NT, nr=NR),
                              n_paths=2, multires=True,
                              admm=jcfg.AdmmConfig(maxiter=77))
    tcc = interop.campaign_config_from_dict(dataclasses.asdict(jcc))
    assert isinstance(tcc, trec.CampaignConfig)
    assert dataclasses.asdict(tcc) == dataclasses.asdict(jcc)
    assert dataclasses.asdict(trec.CampaignConfig()) == \
        dataclasses.asdict(jrec.CampaignConfig())
    jf = jcfg.MethodFlags(admm=True, admm_nuclear=True)
    tf = interop.method_flags_from_dict(dataclasses.asdict(jf))
    assert tf.enabled() == jf.enabled() == ["admm", "admm_lowrank_v4",
                                            "admm_nuclear"]
    c = interop.complex_from_numpy(np.ones(3, np.complex64), device="cpu")
    assert c.dtype == torch.complex64
    assert interop.complex_from_numpy(np.ones(3), device="cpu").dtype == \
        torch.complex128
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            interop.complex_from_numpy(np.ones(3))


def test_recover_campaign_and_warm_sweep_match_jax():
    """recover_campaign and recover_warm_sweep at m = 48 on both packages:
    each grid point recovers the channel below -60 dB at quality > 0.999
    (JAX and the port alike), and the warm sweep's later points fall back
    to the full solve in both (the gate's broadcast, see
    ``recover_warm_sweep``)."""
    cb, x, rss = _testbed()
    admm = dict(maxiter=150, n_restarts=1)
    jcc = jrec.CampaignConfig(array=jcfg.ArrayConfig(nt=NT, nr=NR),
                              n_paths=2, admm=jcfg.AdmmConfig(**admm))
    tcc = interop.campaign_config_from_dict(dataclasses.asdict(jcc))
    jout = jrec.recover_campaign(jnp.asarray(cb), jnp.asarray(rss),
                                 jcfg.MethodFlags(), jcc, m_grid=(48,))
    tout = trec.recover_campaign(cb, rss, tcfg.MethodFlags(), tcc,
                                 m_grid=(48,), device="cpu")
    assert tout.methods == jout.methods == ("admm_lowrank_v4",)
    assert tout.h_amp.shape == jout.h_amp.shape == (1, 1, N)
    # the estimate comes back divided by rss_fct: |h| ~ |x| / sqrt(1000)
    scale = np.linalg.norm(_estimate(tout, 0)) * np.sqrt(1000.0)
    assert abs(scale / np.linalg.norm(x) - 1.0) < 1e-6
    for out in (jout, tout):
        assert nmse_db(_estimate(out, 0), x) < -60.0

    jw, jq = jrec.recover_warm_sweep(jnp.asarray(cb), jnp.asarray(rss), 1,
                                     jcc, m_grid=(48, 48))
    tw, tq = trec.recover_warm_sweep(cb, rss, 1, tcc, m_grid=(48, 48),
                                     device="cpu")
    assert tw.methods == jw.methods == ("admm_lowrank_v4_warm",)
    for out, qs in ((jw, jq), (tw, tq)):
        assert len(qs) == 2 and min(qs) > 0.999
        for i in range(2):
            assert nmse_db(_estimate(out, i), x) < -60.0
    # the warm gate's quality of even the exact channel, in both packages
    a, b = cb[:48], np.abs(cb[:48] @ x)
    qj = float(jadmm._quality(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(x)[:, None]))
    qt = float(tadmm._quality(torch.tensor(a), torch.tensor(b),
                              torch.tensor(x)[:, None]))
    assert qt == pytest.approx(qj, rel=1e-12) and qt < 0.6


def test_recover_a2nuclear_and_multires_run():
    cb, x, rss = _testbed(1)
    cc = trec.CampaignConfig(array=tcfg.ArrayConfig(nt=NT, nr=NR), n_paths=2,
                             admm=tcfg.AdmmConfig(maxiter=60))
    out = trec.recover_a2nuclear(torch.tensor(cb), torch.tensor(rss), cc=cc)
    assert out.methods == ("admm_nuclear",)
    assert out.m_grid == tcfg.probe_budget_grid(NT, NR)
    assert np.isfinite(out.h_amp).all() and out.h_amp.shape == (8, 1, N)
    # multires tiers: rows [0, 16) up to M 16, [16, 40) up to 32, then [40, 64)
    mcc = dataclasses.replace(cc, multires=True, multires_thresholds=(16, 32),
                              multires_separation=(16, 24, 24))
    for m_cur, lo, hi in ((9, 0, 16), (25, 16, 40), (36, 40, 64)):
        idx = trec._pick_m_indices(torch.Generator().manual_seed(0), m_cur,
                                   64, mcc)
        assert len(set(idx.tolist())) == min(m_cur, hi - lo)
        assert lo <= int(idx.min()) and int(idx.max()) < hi
