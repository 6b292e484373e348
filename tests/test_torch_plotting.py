"""The port's copy of ``utils/plotting``: ``beam_width_deg`` against the
JAX package's, and every plot renders its file (matplotlib)."""

import numpy as np
import pytest
import torch

from twoace_tpu.utils import plotting as jplot
from twoace_tpu_torch.ops.prox import profile_ladder
from twoace_tpu_torch.utils import plotting


@pytest.mark.parametrize("case", ["broadside8", "broadside16", "broadside32",
                                  "steered16", "random12"])
def test_beam_width_matches_jax(case):
    rng = np.random.default_rng(4)
    n = {"broadside8": 8, "broadside16": 16, "broadside32": 32,
         "steered16": 16, "random12": 12}[case]
    if case == "random12":
        w = rng.normal(size=n) + 1j * rng.normal(size=n)
    else:
        ang = 70.0 if case == "steered16" else 90.0
        w = np.exp(1j * 2 * np.pi * 0.5 * np.cos(np.deg2rad(ang))
                   * np.arange(n))
    got = plotting.beam_width_deg(w, 0.5)
    want = jplot.beam_width_deg(w, 0.5)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_beam_width_narrows_with_aperture():
    widths = [plotting.beam_width_deg(np.ones(n), 0.5)[0] for n in (8, 16, 32)]
    assert widths[0] > widths[1] > widths[2]


def _rendered(path):
    with open(path, "rb") as f:
        return len(f.read()) > 1000


def test_every_plot_renders(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(0)
    h = torch.tensor(rng.normal(size=(4, 8, 8))
                     + 1j * rng.normal(size=(4, 8, 8)))
    paths = [
        plotting.plot_error_vs_grid(
            [4, 16, 64], {"a2": np.array([0.5, 0.05, 0.01]),
                          "phaselift": np.array([0.9, 0.2, 0.05])},
            xlabel="measurements M", path=str(tmp_path / "err.png")),
        plotting.plot_nmse_cdf({"a2": rng.uniform(1e-3, 1e-1, 50)},
                               str(tmp_path / "cdf.png")),
        plotting.plot_beam_pattern(np.exp(1j * np.zeros((4, 8))), 3.87,
                                   str(tmp_path / "beam.png")),
        plotting.plot_spectral_profile(
            h, str(tmp_path / "profile.png"),
            ladders={"A2": profile_ladder(8, 8, 100, 64, False)}),
        plotting.plot_beamforming_rss({"a2": -50.0, "sweep": -55.0},
                                      str(tmp_path / "bf.png")),
        plotting.plot_measurements_vs_range(
            [20.0, 40.0, 80.0], {"admm_lowrank_v4": np.array(
                [[49, 64], [36, 49], [25, 36]]), "plgamp": np.array(
                [[64, 81], [49, 64], [36, 49]])}, (5, 10),
            str(tmp_path / "vssr.png")),
    ]
    assert all(_rendered(p) for p in paths)
    width = plotting.plot_beam_width(np.ones(16), 0.5,
                                     str(tmp_path / "bw.png"))
    assert width > 0 and _rendered(tmp_path / "bw.png")


def test_spectral_profile_takes_numpy_and_torch(tmp_path):
    pytest.importorskip("matplotlib")
    h = np.random.default_rng(1).normal(size=(2, 4, 4))
    for name, arg in (("np.png", h), ("torch.png", torch.tensor(h))):
        assert _rendered(plotting.plot_spectral_profile(
            arg, str(tmp_path / name)))
