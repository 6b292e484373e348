"""The port's config is a field-for-field copy of the JAX package's, and
``interop`` carries numpy state and JAX configs into the port."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from twoace_tpu import config as jcfg
from twoace_tpu_torch import config as tcfg
from twoace_tpu_torch import interop

CLASSES = ["AdmmConfig", "SpectralProfileConfig", "ArrayConfig",
           "ChannelConfig", "PhaseLiftConfig", "TwoStageConfig", "MethodFlags"]


@pytest.mark.parametrize("name", CLASSES)
def test_config_defaults_match_jax(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t()) == dataclasses.asdict(j())
    assert t.__dataclass_params__.frozen


def test_array_config_properties_match_jax():
    for kw in ({}, dict(nt=4, nr=8, nqt=7)):
        j, t = jcfg.ArrayConfig(**kw), tcfg.ArrayConfig(**kw)
        assert (t.n, t.grid_t, t.grid_r) == (j.n, j.grid_t, j.grid_r)
        assert t.k_d == pytest.approx(j.k_d, rel=1e-15)
    assert tcfg.DEFAULT_LAMBDA == jcfg.DEFAULT_LAMBDA
    assert tcfg.DEFAULT_SPACING == jcfg.DEFAULT_SPACING


def test_campaign_constants_match_jax():
    for name in ("DEFAULT_RSS_FCT", "SEED_TABLE", "MULTIRES_THRESHOLDS",
                 "MULTIRES_SEPARATION"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    for nt, nr, num in ((16, 16, 8), (4, 4, 8), (12, 8, 5), (32, 32, 8)):
        assert tcfg.probe_budget_grid(nt, nr, num) == \
            jcfg.probe_budget_grid(nt, nr, num)
    assert tcfg.probe_budget_grid(16, 16) == (4, 36, 121, 225, 361, 529, 784,
                                              1024)
    for kw in ({}, dict(admm=True, plomp=True, admm_lowrank_v4=False)):
        assert tcfg.MethodFlags(**kw).enabled() == \
            jcfg.MethodFlags(**kw).enabled()


def test_admm_config_from_jax_dict_round_trip():
    j = jcfg.AdmmConfig(maxiter=77, warm_iters=5, stage1_maxiter=30,
                        stage2_maxiter=None, quality_threshold=0.7,
                        profile=jcfg.SpectralProfileConfig(
                            ladder="v1", fractions=(0.7, 0.8, 0.9, 0.99)))
    t = interop.admm_config_from_dict(dataclasses.asdict(j))
    assert isinstance(t, tcfg.AdmmConfig)
    assert isinstance(t.profile, tcfg.SpectralProfileConfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    hash(t)                       # still frozen and hashable


def test_pair_and_ladder_from_numpy_round_trip():
    rng = np.random.default_rng(0)
    re, im = torch_parity.rand_pair_np(rng, 3, 5)
    p = interop.pair_from_numpy(re, im, device="cpu")
    assert p.re.dtype == torch.float32 and p.shape == (3, 5)
    np.testing.assert_array_equal(p.re.numpy(), re)
    np.testing.assert_array_equal(p.im.numpy(), im)
    pc = interop.pair_from_numpy(re + 1j * im, None, device="cpu")
    np.testing.assert_array_equal(pc.im.numpy(), im)
    lad = interop.ladder_from_numpy([3, 4, 8, 16], [0.9, 0.95, 0.995, 0.0],
                                    device="cpu")
    assert lad.ranks.dtype == torch.float32
    np.testing.assert_array_equal(lad.fracs.numpy(),
                                  np.float32([0.9, 0.95, 0.995, 0.0]))


def test_converters_default_to_the_card():
    """Without a device argument the converters build CUDA tensors, and
    raise where there is no card instead of quietly staying on the CPU."""
    re = np.zeros((2, 3), np.float32)
    if torch.cuda.is_available():
        assert interop.pair_from_numpy(re, re).re.device.type == "cuda"
        assert interop.ladder_from_numpy([1.0], [0.9]).ranks.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.pair_from_numpy(re, re)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.ladder_from_numpy([1.0], [0.9])


def test_port_imports_no_jax():
    """The port must run where jax is absent: importing it loads no jax
    module (checked in a fresh interpreter)."""
    code = ("import sys, twoace_tpu_torch, twoace_tpu_torch.interop, "
            "twoace_tpu_torch.ops.pair_solver, "
            "twoace_tpu_torch.pipeline, twoace_tpu_torch.sensing, "
            "twoace_tpu_torch.ops.dispatch, "
            "twoace_tpu_torch.utils.metrics, twoace_tpu_torch.cli, "
            "twoace_tpu_torch.__main__, "
            "twoace_tpu_torch.sensing.tcp_provider, "
            "twoace_tpu_torch.sensing.brd, "
            "twoace_tpu_torch.sensing.bayes_opt, "
            "twoace_tpu_torch.sensing.grouping, "
            "twoace_tpu_torch.pipeline.testbed, "
            "twoace_tpu_torch.utils.checkpoint, "
            "twoace_tpu_torch.utils.spectral_analysis, "
            "twoace_tpu_torch.utils.profiling; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('twoace_tpu.')]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   env=env, timeout=120)
