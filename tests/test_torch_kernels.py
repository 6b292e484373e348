"""The port's per-op kernels K1 and K2 (``twoace_tpu_torch.ops.kernels``),
and the build of all of them; K3 has ``test_torch_infer_admm.py``.

On the CPU each wrapper runs its plain PyTorch version, which is held
against (a) the JAX Pallas kernel it replaces, in interpret mode as
``tests/test_pallas.py`` runs it, and (b) the JAX (XLA) op, over a batch
of lanes.  The CUDA kernels themselves are held against the plain
versions on the card by the ``gpu``-marked tests (and by chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_parity import (assert_pair_close, jpair, np_pair, rand_pair_np,
                          require_cuda, tpair)
from twoace_tpu.ops import cplx as jc
from twoace_tpu.ops import pair_solver as jps
from twoace_tpu.ops.pallas import fused_prox_dual_t as pallas_prox_dual_t
from twoace_tpu.ops.pallas import fused_zprox_t as pallas_zprox_t
from twoace_tpu.ops.prox import profile_ladder
from twoace_tpu_torch.ops import kernels
from twoace_tpu_torch.ops.cplx import LadderArrays, Pair
from twoace_tpu_torch.ops.kernels import _build
from twoace_tpu_torch.ops.kernels import prox_dual as k1
from twoace_tpu_torch.ops.kernels import zprox as k2
from twoace_tpu_torch.ops.prox import profile_ladder_arrays


def _k1_inputs(seed=0, lanes=3, r=6, m=40):
    rng = np.random.default_rng(seed)
    ax, md = rand_pair_np(rng, lanes, r, m), rand_pair_np(rng, lanes, r, m)
    b = rng.uniform(0.5, 2.0, (lanes, m)).astype(np.float32)
    b[:, :3] = 0.0                              # inactive padding columns
    for p in (ax, md):
        p[0][:, :, 4:6] = 0.0                   # zero columns
        p[1][:, :, 4:6] = 0.0
    mu = rng.uniform(0.05, 1.0, lanes).astype(np.float32)
    return ax, md, b, mu


@pytest.mark.parametrize("per_entry", [False, True])
def test_prox_dual_plain_matches_jax(per_entry):
    """K1's plain version against the Pallas kernel (interpret mode; row
    form only, the Pallas kernel has no per-entry form) and the XLA ops,
    lane by lane.  atol 1e-5 is test_pallas.py's envelope for the kernel."""
    ax, md, b, mu = _k1_inputs()
    y, m_new = kernels.fused_prox_dual_t(tpair(*ax), torch.tensor(b),
                                         tpair(*md), torch.tensor(mu),
                                         per_entry=per_entry)
    xla = jps.magnitude_prox_cols_elem if per_entry else \
        jc.magnitude_prox_cols
    for lane in range(len(mu)):
        ax_j = jpair(ax[0][lane], ax[1][lane])
        md_j = jpair(md[0][lane], md[1][lane])
        b_j, mu_j = jnp.asarray(b[lane]), jnp.float32(mu[lane])
        y_x = xla(ax_j, b_j, md_j, mu_j)
        m_x = jc.Pair(md_j.re + mu_j * (ax_j.re - y_x.re),
                      md_j.im + mu_j * (ax_j.im - y_x.im))
        wants = [(y_x, m_x)]
        if not per_entry:
            wants.append(pallas_prox_dual_t(ax_j, b_j, md_j, mu_j,
                                            block_cols=16, interpret=True))
        for y_w, m_w in wants:
            for got, want in ((y, y_w), (m_new, m_w)):
                for g, w in zip(np_pair(got), np_pair(want)):
                    np.testing.assert_allclose(g[lane], w, atol=1e-5)
    assert np.all(np_pair(y)[0][:, :, :3] == 0.0)


def _zprox_inputs(seed=0, lanes=3, nt=8, nr=8, r=12):
    rng = np.random.default_rng(seed)
    z = rand_pair_np(rng, lanes, r, nt * nr)
    # warm E-convention basis: cold basis of a perturbed panel (JAX's)
    zp = (z[0] + 0.05 * rng.normal(size=z[0].shape).astype(np.float32),
          z[1] + 0.05 * rng.normal(size=z[1].shape).astype(np.float32))
    v0 = [np_pair(jc.panel_gram_basis_pair(_to_panel(
        jpair(zp[0][i], zp[1][i]), nt, nr, r))[1]) for i in range(lanes)]
    v0 = (np.stack([v[0] for v in v0]), np.stack([v[1] for v in v0]))
    return z, v0


def _to_panel(p, nt, nr, r):
    f = lambda x: x.reshape(r, nt, nr).transpose(2, 0, 1).reshape(nr, r * nt)
    return jc.Pair(f(p.re), f(p.im))


def _from_panel(p, nt, nr, r):
    f = lambda e: e.reshape(nr, r, nt).transpose(1, 2, 0).reshape(r, nt * nr)
    return jc.Pair(f(p.re), f(p.im))


def test_zprox_plain_matches_pallas_interpret():
    """K2's plain version against ``fused_zprox_t`` (interpret mode, a
    static ladder) lane by lane; atol 2e-5 is test_pallas.py's envelope
    for that kernel against the XLA chain."""
    nt = nr = 8
    r, n = 12, 64
    z, v0 = _zprox_inputs()
    ladder = profile_ladder(nt, nr, 4 * n, n, False)
    lad = profile_ladder_arrays(nt, nr, 4 * n, n, False)
    lanes = z[0].shape[0]
    lad_t = LadderArrays(lad.ranks.expand(lanes, -1).contiguous(),
                         lad.fracs.expand(lanes, -1).contiguous())
    zn, vn = kernels.fused_zprox_t(tpair(*z), tpair(*v0), nt, nr, lad_t)
    for i in range(lanes):
        z_w, v_w = pallas_zprox_t(jpair(z[0][i], z[1][i]),
                                  jpair(v0[0][i], v0[1][i]), nt, nr, ladder,
                                  interpret=True)
        assert_pair_close(Pair(zn.re[i], zn.im[i]), z_w, atol=2e-5)
        assert_pair_close(Pair(vn.re[i], vn.im[i]), v_w, atol=2e-5)


def test_zprox_plain_matches_xla_with_per_lane_ladders():
    """K2's plain version against JAX's ``_panel_spectral_prox_c`` with
    traced LadderArrays; the lanes carry the normal, rank-1 and m >= 3n
    ladders, whose padded f = 0 levels must stay inert."""
    nt = nr = 8
    r, n = 12, 64
    z, v0 = _zprox_inputs(seed=1)
    ladders = [profile_ladder_arrays(nt, nr, 2 * n, n, False),
               profile_ladder_arrays(nt, nr, 2 * n, n, True),
               profile_ladder_arrays(nt, nr, 4 * n, n, False)]
    assert all(float(l.fracs[-1]) == 0.0 for l in ladders)
    lad_t = LadderArrays(torch.stack([l.ranks for l in ladders]),
                         torch.stack([l.fracs for l in ladders]))
    zn, vn = kernels.fused_zprox_t(tpair(*z), tpair(*v0), nt, nr, lad_t)
    moved = 0.0
    for i, lad in enumerate(ladders):
        lad_j = jc.LadderArrays(jnp.asarray(lad.ranks.numpy()),
                                jnp.asarray(lad.fracs.numpy()))
        e_w, v_w = jc._panel_spectral_prox_c(
            _to_panel(jpair(z[0][i], z[1][i]), nt, nr, r), nr, lad_j,
            jpair(v0[0][i], v0[1][i]))
        z_w = _from_panel(e_w, nt, nr, r)
        assert_pair_close(Pair(zn.re[i], zn.im[i]), z_w, atol=2e-5)
        assert_pair_close(Pair(vn.re[i], vn.im[i]), v_w, atol=2e-5)
        assert np.all(np.isfinite(np_pair(z_w)[0]))
        moved = max(moved, float(np.abs(np_pair(z_w)[0] - z[0][i]).max()))
    assert moved > 1e-2                      # the ladders act on these inputs


def test_cpu_calls_count_no_launches():
    kernels.reset_launch_counts()
    ax, md, b, mu = _k1_inputs()
    kernels.fused_prox_dual_t(tpair(*ax), torch.tensor(b), tpair(*md),
                              torch.tensor(mu))
    z, v0 = _zprox_inputs()
    lad = profile_ladder_arrays(8, 8, 256, 64, False)
    kernels.fused_zprox_t(tpair(*z), tpair(*v0), 8, 8, LadderArrays(
        lad.ranks.expand(3, -1).contiguous(),
        lad.fracs.expand(3, -1).contiguous()))
    zt = tpair(*z)
    kernels.pair_matmul(zt, Pair(zt.re.transpose(1, 2), zt.im.transpose(1, 2)))
    axc = torch.complex(*tpair(*ax)).transpose(1, 2).contiguous()
    kernels.fused_prox_dual(axc, torch.tensor(b), axc, torch.tensor(mu[0]))
    sq = Pair(zt.re[:, :8, :8].contiguous(), zt.im[:, :8, :8].contiguous())
    kernels.pair_chain_mm(sq, sq)
    assert kernels.launch_counts() == {"fused_prox_dual_t": 0,
                                       "fused_zprox_t": 0,
                                       "fused_infer_admm": 0,
                                       "pair_matmul": 0,
                                       "fused_prox_dual": 0,
                                       "pair_chain_mm": 0}


def test_other_devices_raise_instead_of_falling_back():
    """Only a CPU tensor takes the plain version; any other device runs
    the kernel or raises."""
    meta = lambda *s: torch.empty(s, device="meta")
    p = Pair(meta(2, 3, 4), meta(2, 3, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.fused_prox_dual_t(p, meta(2, 4), p, meta(2))
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.fused_zprox_t(Pair(meta(2, 3, 4), meta(2, 3, 4)),
                              Pair(meta(2, 2, 2), meta(2, 2, 2)), 2, 2,
                              LadderArrays(meta(2, 4), meta(2, 4)))
    c = torch.empty(2, 4, 3, dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kernels.fused_prox_dual(c, meta(2, 4), c, meta())


def test_wrapper_checks_reject_what_the_kernels_do_not_take():
    ax, md, b, mu = _k1_inputs()
    good = (tpair(*ax), torch.tensor(b), tpair(*md), torch.tensor(mu))
    k1._check(*good)
    with pytest.raises(ValueError, match="shape"):
        k1._check(good[0], good[1][:, :-1], good[2], good[3])
    with pytest.raises(ValueError, match="float32"):
        k1._check(good[0], good[1].double(), good[2], good[3])
    nc = Pair(good[0].re.transpose(1, 2).contiguous().transpose(1, 2),
              good[0].im)
    with pytest.raises(ValueError, match="contiguous"):
        k1._check(nc, good[1], good[2], good[3])
    z, v0 = _zprox_inputs()
    lad = LadderArrays(torch.ones(3, 4), torch.zeros(3, 4))
    k2._check(tpair(*z), tpair(*v0), 8, 8, lad)
    with pytest.raises(ValueError, match="nt\\*nr"):
        k2._check(tpair(*z), tpair(*v0), 4, 8, lad)
    with pytest.raises(ValueError, match="shape"):
        k2._check(tpair(*z), tpair(*v0), 8, 8,
                  LadderArrays(torch.ones(2, 4), torch.zeros(2, 4)))


def test_build_is_keyed_by_the_sources(tmp_path, monkeypatch):
    """nvcc gets the .cu files; the library's name hashes them and the
    headers they include, so a changed header cannot load a stale build."""
    names = sorted(p.name for p in _build.sources())
    assert names == ["chain_mm.cu", "infer_admm.cu", "pair_matmul.cu",
                     "prox_dual.cu", "prox_dual_rows.cu", "zprox.cu"]
    assert "zprox_core.cuh" in [p.name for p in _build.hashed_files()]
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libtwoace_kernels-")
    for src in _build.hashed_files():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.library_path() == path
    with open(tmp_path / "zprox_core.cuh", "a") as f:
        f.write("// changed\n")
    assert _build.library_path() != path


@pytest.mark.gpu
def test_cuda_call_without_library_raises(monkeypatch):
    require_cuda()

    def no_build():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", no_build)
    ax, md, b, mu = _k1_inputs()
    with pytest.raises(RuntimeError, match="unavailable"):
        kernels.fused_prox_dual_t(tpair(*ax, device="cuda"),
                                  torch.tensor(b, device="cuda"),
                                  tpair(*md, device="cuda"),
                                  torch.tensor(mu, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("per_entry", [False, True])
def test_prox_dual_kernel_matches_plain_on_card(per_entry):
    require_cuda()
    ax, md, b, mu = _k1_inputs(lanes=4, r=20, m=300)
    args = (tpair(*ax, device="cuda"), torch.tensor(b, device="cuda"),
            tpair(*md, device="cuda"), torch.tensor(mu, device="cuda"))
    before = kernels.fused_prox_dual_t.launches
    y, m_new = kernels.fused_prox_dual_t(*args, per_entry=per_entry)
    torch.cuda.synchronize()
    assert kernels.fused_prox_dual_t.launches == before + 1
    y0, m0 = kernels.prox_dual_t_plain(*args, per_entry)
    for g, w in ((y, y0), (m_new, m0)):
        torch.testing.assert_close(g.re, w.re, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(g.im, w.im, rtol=1e-5, atol=1e-6)


#: K2's shapes on the card: chip_smoke.py's K2_SHAPES (phase 2), then odd
#: ones: nr 6 (4-byte copies), nr 20 (six tiles, K unsplit), nr 3 at 15
#: rows, and 16x16 at r 200 (3200 rows: W streamed)
K2_CARD_SHAPES = [*chip_smoke.K2_SHAPES, (3, 5, 4, 6), (2, 6, 4, 20),
                  (3, 5, 3, 3), (2, 200, 16, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [None, *K2_CARD_SHAPES])
def test_zprox_kernel_matches_plain_on_card(shape):
    """K2 against its plain version at K2_ATOL: on the JAX-made inputs of
    the CPU tests (shape None), and at the phase-2 and odd shapes on
    chip_smoke.k2_case's inputs."""
    require_cuda()
    if shape is None:
        nt = nr = 8
        z, v0 = _zprox_inputs()
        lad = profile_ladder_arrays(8, 8, 128, 64, False, device="cuda")
        lad = LadderArrays(lad.ranks.expand(3, -1).contiguous(),
                           lad.fracs.expand(3, -1).contiguous())
        zt, vt = tpair(*z, device="cuda"), tpair(*v0, device="cuda")
    else:
        lanes, r, nt, nr = shape
        zt, vt, lad = chip_smoke.k2_case(lanes, r, nt, nr)
    zn, vn = kernels.fused_zprox_t(zt, vt, nt, nr, lad)
    torch.cuda.synchronize()
    zn0, vn0 = kernels.zprox_t_plain(zt, vt, nt, nr, lad)
    for g, w in ((zn, zn0), (vn, vn0)):
        torch.testing.assert_close(g.re, w.re, rtol=0, atol=chip_smoke.K2_ATOL)
        torch.testing.assert_close(g.im, w.im, rtol=0, atol=chip_smoke.K2_ATOL)
