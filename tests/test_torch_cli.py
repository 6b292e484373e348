"""The port's CLI (``python -m twoace_tpu_torch``) against the JAX
package's, on the CPU.

Each command's parser takes JAX's flags with JAX's defaults, except that
``--device`` (default ``cuda``) stands where JAX has ``--platform``.
``testbed`` and ``recover`` run in-process in both packages at 4x4 with
``--device cpu`` (no subprocess: each would pay a fresh ``torch``
import), at one probe budget (JAX's channel, campaign and solve
stubbed: no compile), and print the same JSON keys.  The simulation commands run in the port at
the smallest sizes and print JAX's keys.
"""

import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twoace_tpu import cli as jcli
from twoace_tpu import models as jmodels
from twoace_tpu.pipeline import recovery as jrec
from twoace_tpu.pipeline import testbed as jtb
from twoace_tpu_torch import cli as tcli
from twoace_tpu_torch.pipeline import recovery as trec

COMMANDS = ("vs-m", "vs-snr", "vs-sr", "mobility", "testbed", "recover")
TINY = ["--nt", "4", "--nr", "4", "--trials", "1", "--maxiter", "20",
        "--restarts", "1"]


def _options(parser):
    """{command: {option string: default}} of a CLI parser."""
    sub = parser._subparsers._group_actions[0].choices
    return {cmd: {opt: act.default for act in p._actions
                  for opt in act.option_strings if opt not in ("-h", "--help")}
            for cmd, p in sub.items()}


def _run(main, capsys, argv):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_parsers_match_jax():
    """The six commands with JAX's flags and defaults; --device for
    --platform."""
    got, want = _options(tcli.build_parser()), _options(jcli.build_parser())
    assert tuple(got) == tuple(want) == COMMANDS
    for cmd in COMMANDS:
        assert got[cmd].pop("--device") == "cuda"
        assert want[cmd].pop("--platform") == ""
        assert got[cmd] == want[cmd], cmd


@pytest.fixture
def one_budget(monkeypatch):
    """Both packages' recovery grids cut to the one budget M 16, and JAX's
    channel draw, random campaign and campaign solves stubbed by arrays
    of their shapes: JAX's CLI only has to print its keys, and its
    campaign and solver are held to the port's elsewhere
    (test_torch_testbed.py, test_torch_campaign.py) without their
    compiles here.  The port's commands run for real."""
    for mod in (jrec, trec):
        monkeypatch.setattr(mod, "probe_budget_grid", lambda nt, nr: (16,))

    def channel(key, cfg, ch_cfg, batch=1):
        return SimpleNamespace(vec_h=jnp.ones((batch, cfg.n), jnp.complex64))

    def campaign(self):
        rows = self.cfg.n_random_rounds * self.cfg.sectors_per_round
        self.results["random"] = {
            "rows": np.ones((rows, self.cfg.array.n), np.complex64),
            "rss_dbm": np.zeros(rows)}
        return self

    monkeypatch.setattr(jmodels, "generate_channel", channel)
    monkeypatch.setattr(jtb.TestbedRunner, "run_random_campaign", campaign)

    def stub(cb_rows, rss_dbm, methods, cc=jrec.CampaignConfig(), seed_id=1,
             m_grid=None, nuclear=False):
        shape = (1, 1, np.shape(cb_rows)[1])
        return jrec.RecoveryOutput(h_amp=np.ones(shape),
                                   h_angle=np.zeros(shape), m_grid=(16,),
                                   methods=("admm_lowrank_v4",))

    monkeypatch.setattr(jrec, "recover_campaign", stub)


def test_testbed_and_recover_print_jax_keys(capsys, tmp_path, one_budget):
    """``testbed`` (2 rounds x 8 sectors) and ``recover`` (its rows and
    RSS, from .npz and from .mat) in both packages: the same summary keys,
    the same grid; the .npz of --out holds the same arrays."""
    argv = ["testbed", *TINY, "--rounds", "2", "--sectors", "8"]
    got = _run(tcli.main, capsys, argv + ["--device", "cpu",
                                          "--out", str(tmp_path / "t.npz")])
    want = _run(jcli.main, capsys, argv + ["--platform", "cpu",
                                           "--out", str(tmp_path / "j.npz")])
    assert sorted(got) == sorted(want) and got["m_grid"] == want["m_grid"]
    assert np.isfinite(got["nmse_db_final"])
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)

    rng = np.random.default_rng(0)
    rows = np.exp(1j * rng.integers(0, 4, (16, 16)) * np.pi / 2)
    x = rng.normal(size=16) + 1j * rng.normal(size=16)
    rss = 10 * np.log10(np.abs(rows @ (3e-4 * x)) ** 2)
    np.savez(tmp_path / "p.npz", cb_rows=rows, rss_dbm=rss)
    import scipy.io as sio

    sio.savemat(tmp_path / "p.mat", {"cb_rows": rows, "rss_dbm": rss})
    argv = ["recover", *TINY, "--method", "multires"]
    want = _run(jcli.main, capsys, argv + ["--platform", "cpu", "--probes",
                                           str(tmp_path / "p.npz")])
    for probes in ("p.npz", "p.mat"):
        got = _run(tcli.main, capsys, argv + ["--device", "cpu", "--probes",
                                              str(tmp_path / probes)])
        assert got == want, probes
    with np.load(tmp_path / "t.npz") as t:
        assert np.isfinite(t["h_amp"]).all() and t["h_amp"].any()


def test_simulation_commands_print_jax_keys(capsys, tmp_path):
    """vs-m, vs-snr, vs-sr and mobility at their smallest on the CPU: each
    prints JAX's summary keys (cli.py:121-213) and saves its arrays."""
    keys = {"vs-m": ["aoda_err_deg", "cmd", "m_grid", "nmse_db"],
            "vs-snr": ["cmd", "nmse_db", "snr_grid"],
            "vs-sr": ["cmd", "g_grids", "m_grids", "m_needed", "maee_deg",
                      "maee_targets_deg", "ranges_deg"],
            "mobility": ["cmd", "mean_probe_budget", "mean_rss_error",
                         "probe_budget", "windows"]}
    runs = {"vs-m": ["--m-grid", "9", "--beam", "Random_Phase_State"],
            "vs-snr": ["--snr-grid", "10", "--m", "9", "--beam",
                       "Random_Phase_State"],
            "vs-sr": ["--ranges", "30", "--m-grid", "2", "--g-grid", "16"],
            "mobility": ["--windows", "2", "--window-probes", "12"]}
    for cmd, extra in runs.items():
        out = tmp_path / f"{cmd}.mat"
        res = _run(tcli.main, capsys, [cmd, *TINY, *extra, "--device", "cpu",
                                       "--out", str(out), "--mat"])
        assert sorted(res) == keys[cmd] and res["cmd"] == cmd
        assert out.exists()


def test_cli_runs_on_the_card_by_default():
    """Without --device the CLI runs on the card, and raises without one
    before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["testbed", *TINY])
    import twoace_tpu_torch.__main__ as entry

    assert entry.main is tcli.main
