"""The port's channel and steering models, random codebooks and metrics
against the JAX package's, on the same numpy inputs.

Random draws differ between the packages (``jax.random`` keys against
``torch.Generator``), so the draws are handed over: the deterministic
cores take the same arrays, and the port's samplers are given JAX's
draws through their draw helpers.  Tolerances are float32 rounding of
values of order 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from twoace_tpu import config as jcfg
from twoace_tpu.models import channel as jch
from twoace_tpu.models import steering as jst
from twoace_tpu.sensing import codebooks as jcb
from twoace_tpu.utils import metrics as jm
from twoace_tpu_torch import config as tcfg
from twoace_tpu_torch.models import channel as tch
from twoace_tpu_torch.models import steering as tst
from twoace_tpu_torch.sensing import codebooks as tcb
from twoace_tpu_torch.utils import metrics as tm

ATOL = 2e-6
CFG_J, CFG_T = jcfg.ArrayConfig(nt=8, nr=4), tcfg.ArrayConfig(nt=8, nr=4)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.cpu().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got), np.asarray(want), atol=atol)


def test_steering_vector_and_dictionaries_match_jax():
    rng = np.random.default_rng(0)
    s = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    _close(tst.steering_vector(torch.tensor(s), 8, CFG_T.k_d),
           jst.steering_vector(jnp.asarray(s), 8, CFG_J.k_d))
    got = tst.steering_vector(torch.tensor(s, dtype=torch.float64), 8,
                              CFG_T.k_d, dtype=torch.complex128)
    assert got.dtype == torch.complex128
    _close(got, jst.steering_vector(jnp.asarray(s, jnp.float64), 8,
                                    CFG_J.k_d, dtype=jnp.complex128),
           atol=1e-12)
    _close(tst.dictionary(8, 32, CFG_T.k_d, device="cpu"),
           jst.dictionary(8, 32, CFG_J.k_d))
    np.testing.assert_array_equal(tst.virtual_grid(32), jst.virtual_grid(32))
    for t, j in zip(tst.fov_window(CFG_T, 95.0), jst.fov_window(CFG_J, 95.0)):
        np.testing.assert_array_equal(t, j)
    _close(tst.angle_dictionary(CFG_T, 95.0, device="cpu"),
           jst.angle_dictionary(CFG_J, 95.0))
    h = (rng.normal(size=(2, 4, 8)) + 1j * rng.normal(size=(2, 4, 8)))
    v = tst.vec_channel(torch.tensor(h))
    _close(v, jst.vec_channel(jnp.asarray(h)), atol=0)
    _close(tst.unvec_channel(v, 4, 8), h, atol=0)


def test_path_response_and_snap_to_grid_match_jax():
    rng = np.random.default_rng(1)
    aod = rng.uniform(-0.8, 0.8, (3, 2)).astype(np.float32)
    aoa = rng.uniform(-0.8, 0.8, (3, 2)).astype(np.float32)
    gains = (rng.normal(size=(3, 2)) + 1j * rng.normal(size=(3, 2))
             ).astype(np.complex64)
    _close(tch._path_response(torch.tensor(aod), torch.tensor(aoa),
                              torch.tensor(gains), CFG_T, torch.complex64),
           jch._path_response(jnp.asarray(aod), jnp.asarray(aoa),
                              jnp.asarray(gains), CFG_J, jnp.complex64),
           atol=1e-5)
    deg = rng.uniform(-47.5, 47.5, (3, 2)).astype(np.float32)
    _close(tch._snap_to_grid(torch.tensor(deg), 32),
           jch._snap_to_grid(jnp.asarray(deg), 32), atol=1e-4)


def _feed(monkeypatch, **draws):
    """Make the port's draw helpers return the given arrays in turn."""
    for name, arrays in draws.items():
        queue = list(arrays)

        def draw(*args, _queue=queue, **kw):
            device = args[-1] if args else kw["device"]
            return torch.tensor(_queue.pop(0)).to(device)

        monkeypatch.setattr(tch, name, draw)


@pytest.mark.parametrize("on_grid", [False, True])
def test_generate_channel_matches_jax_given_its_draws(monkeypatch, on_grid):
    ch_cfg = dict(n_paths=2, on_grid=on_grid)
    want = jch.generate_channel(jax.random.PRNGKey(3), CFG_J,
                                jcfg.ChannelConfig(**ch_cfg), batch=3)
    # JAX's unsnapped angles are lost when snapped: hand over the snapped
    # ones, which snap to themselves
    _feed(monkeypatch, _uniform=[np.asarray(want.aod_deg),
                                 np.asarray(want.aoa_deg)],
          _complex_normal=[np.asarray(want.gains)])
    got = tch.generate_channel(None, CFG_T, tcfg.ChannelConfig(**ch_cfg),
                               batch=3, device="cpu")
    for f in ("aod_deg", "aoa_deg", "gains"):
        _close(getattr(got, f), getattr(want, f), atol=1e-4)
    for f in ("h_matrix", "vec_h", "h_dominant", "h_undominant"):
        _close(getattr(got, f), getattr(want, f), atol=1e-5)


def test_perturb_channel_matches_jax_given_the_same_deltas(monkeypatch):
    ch_j = jch.generate_channel(jax.random.PRNGKey(4), CFG_J,
                                jcfg.ChannelConfig(n_paths=2), batch=2)
    ch_t = tch.Channel(*(torch.tensor(np.asarray(v)) for v in ch_j))
    want = jch.perturb_channel(jax.random.PRNGKey(5), ch_j, CFG_J, 1.0)
    _feed(monkeypatch, _uniform=[np.asarray(want.aod_deg - ch_j.aod_deg),
                                 np.asarray(want.aoa_deg - ch_j.aoa_deg)])
    got = tch.perturb_channel(None, ch_t, CFG_T, 1.0)
    for f in ("aod_deg", "aoa_deg", "gains", "h_matrix", "vec_h"):
        _close(getattr(got, f), getattr(want, f), atol=1e-5)
    assert not got.h_undominant.abs().any()


def test_channel_sampler_draws_from_its_generator():
    """Same seed, same channel; the draws keep the model's ranges and
    unit-norm gains; the Rician branch mixes in NLOS paths; from_matrix
    wraps and normalizes a measured H as JAX's does."""
    kw = dict(cfg=CFG_T, ch=tcfg.ChannelConfig(n_paths=1), batch=4,
              device="cpu")
    one = tch.generate_channel(torch.Generator().manual_seed(9), **kw)
    two = tch.generate_channel(torch.Generator().manual_seed(9), **kw)
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    assert float(one.aod_deg.abs().max()) <= 47.5
    _close(torch.linalg.vector_norm(one.gains, dim=-1), np.ones(4))
    assert one.h_undominant.abs().max() > 0
    jit = tch.perturb_channel(torch.Generator().manual_seed(1), one, CFG_T,
                              1.0)
    assert float((jit.aod_deg - one.aod_deg).abs().max()) <= 1.0
    h = np.random.default_rng(2).normal(size=(4, 8)) * (1 + 1j)
    got = tch.from_matrix(torch.tensor(h), normalize=True)
    want = jch.from_matrix(jnp.asarray(h), normalize=True)
    for f in ("h_matrix", "vec_h", "aod_deg", "gains"):
        _close(getattr(got, f), getattr(want, f), atol=1e-12)


def test_random_sensing_rows_match_jax_given_the_same_bits():
    key = jax.random.PRNGKey(6)
    bits = np.asarray(jcb.random_phase_bits(key, 12, 32, 2))
    want = jcb.random_sensing_rows(key, 12, 32, 2)
    _close(tcb.phase_rows(torch.tensor(bits), 2, normalize_by=32), want)
    amp = np.ones(32)
    amp[::5] = 0.0
    cb_j = jcb.Codebook(bits=jnp.asarray(bits), amp=jnp.asarray(amp))
    cb_t = tcb.Codebook(bits=torch.tensor(bits), amp=torch.tensor(amp))
    for normalize in (False, True):
        _close(cb_t.rows(normalize), cb_j.rows(normalize))
    tx = (np.random.default_rng(7).normal(size=(3, 4, 8))
          * (1 - 1j)).astype(np.complex64)
    rx = np.asarray(jcb.random_sensing_rows(key, 3, 4))
    for interleave in (False, True):
        _close(tcb.kron_probe_rows(torch.tensor(tx), torch.tensor(rx),
                                   interleave),
               jcb.kron_probe_rows(jnp.asarray(tx), jnp.asarray(rx),
                                   interleave), atol=1e-6)


def test_random_phase_bits_are_prefix_stable_in_range():
    """The first M rows do not depend on how many rows are drawn (ref:
    Generate_Sensing_Matrix.m:86-99), and the values cover 0..2^b - 1."""
    small = tcb.random_phase_bits(torch.Generator().manual_seed(3), 40, 16,
                                  device="cpu")
    big = tcb.random_phase_bits(torch.Generator().manual_seed(3), 400, 16,
                                device="cpu")
    assert torch.equal(small, big[:40])
    assert set(big.unique().tolist()) == {0, 1, 2, 3}
    cb = tcb.random_codebook(torch.Generator().manual_seed(3), 40, 16,
                             device="cpu")
    assert torch.equal(cb.bits, small) and cb.n_ant == 16
    rows = tcb.random_sensing_rows(torch.Generator().manual_seed(3), 40, 16,
                                   device="cpu")
    _close(rows.abs(), np.full((40, 16), 0.25))


def test_metrics_match_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 16)) + 1j * rng.normal(size=(3, 16))
    x_ref = x * np.exp(1j * 0.7) + 0.1 * rng.normal(size=(3, 16))
    xt, rt = torch.tensor(x), torch.tensor(x_ref)
    xj, rj = jnp.asarray(x), jnp.asarray(x_ref)
    _close(tm.phase_align(xt, rt), jm.phase_align(xj, rj), atol=1e-12)
    _close(tm.nmse_h(xt, rt), jm.nmse_h(xj, rj), atol=1e-12)
    _close(tm.nmse_h_projection(xt, rt), jm.nmse_h_projection(xj, rj),
           atol=1e-12)
    _close(tm.nmse_db(tm.nmse_h(xt, rt)), jm.nmse_db(jm.nmse_h(xj, rj)),
           atol=1e-9)
    cb = rng.normal(size=(10, 16)) + 1j * rng.normal(size=(10, 16))
    rss = np.abs(cb @ x_ref[0]) * 1.1
    _close(tm.rss_prediction_error(xt[0], torch.tensor(cb), torch.tensor(rss)),
           jm.rss_prediction_error(xj[0], jnp.asarray(cb), jnp.asarray(rss)),
           atol=1e-12)
    w = (rng.normal(size=(2, 8, 3)) + 1j * rng.normal(size=(2, 8, 3))
         ).astype(np.complex64)
    for bits in (1, 2, 3):
        _close(tm.quantize_ps(torch.tensor(w), bits),
               jm.quantize_ps(jnp.asarray(w), bits))
