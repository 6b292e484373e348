"""Kernel K5 (``fused_prox_dual``) and the complex prox operators of the
port (``twoace_tpu_torch.ops.prox``, ``ops.spectral_init``) against the
JAX package and the MATLAB-transcript goldens.

- K5's plain version against the Pallas kernel ``fused_prox_dual``
  (interpret mode, float32): zero rows, b = 0 rows, a ragged m, to 2e-6
  of the largest entry (the Pallas kernel multiplies by 1/mu where the
  port divides by mu: one rounding apart);
- K5's plain version against JAX's ``magnitude_prox`` plus the dual
  update at complex128 (1e-12 of the largest entry), in both forms, and
  against the goldens ``y_row_out`` / ``y_elem_out``;
- the spectral-profile and nuclear prox, the row projection and the panel
  layout against JAX at complex128 (1e-12), and the goldens ``z_*`` at
  1e-8 (as ``test_golden_matlab.py`` holds JAX);
- the spectral initialization's projector X X^H against the golden
  ``si_proj`` (1e-7, the oracle's tolerance), and its subspace iteration
  against JAX's;
- K5's launch geometry (``prox_dual_rows.plan``) against what the kernel
  needs of it, over r 1 ... 64, ragged rows and both dtypes;
- K5 itself against its plain version, and ``plan`` against the kernel's
  own, on the card only.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jpair, require_cuda
from twoace_tpu.ops import prox as jp
from twoace_tpu.ops.pallas.kernels import fused_prox_dual as pallas_prox_dual
from twoace_tpu_torch.ops import prox as tp
from twoace_tpu_torch.ops import spectral_init as tsi
from twoace_tpu_torch.ops.kernels import (fused_prox_dual, launch_counts,
                                          prox_dual_rows_plain)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_v1.npz")
Z_CASES = ["sz8_under", "sz16_under", "sz16_over", "sz25_under", "rank_one"]


@pytest.fixture(scope="module")
def g():
    return dict(np.load(GOLDEN))


def _state(rng, m, r, dtype=np.complex128):
    """ax, M (m, r), b (m,) with two all-zero rows (ax = M = 0), three
    inactive rows (b = 0) and one zero entry."""
    ax = rng.normal(size=(m, r)) + 1j * rng.normal(size=(m, r))
    md = rng.normal(size=(m, r)) + 1j * rng.normal(size=(m, r))
    b = rng.uniform(0.5, 1.5, m)
    ax[[1, m - 1]] = 0.0
    md[[1, m - 1]] = 0.0
    b[[2, 5, m - 2]] = 0.0
    ax[3, 0] = md[3, 0] = 0.0
    return ax.astype(dtype), md.astype(dtype), b


def _dual(ax, md, y, mu):
    return md + mu * (ax - y)


@pytest.mark.parametrize("m,r", [(40, 6), (300, 20), (37, 1)],
                         ids=["block", "ragged_r20", "ragged_r1"])
def test_k5_plain_matches_pallas_kernel(m, r):
    rng = np.random.default_rng(m)
    ax, md, b = _state(rng, m, r, np.complex64)
    b = b.astype(np.float32)
    mu = np.float32(0.37)
    yj, mj = pallas_prox_dual(jpair(ax), jnp.asarray(b), jpair(md), mu,
                              interpret=True)
    yt, mt = prox_dual_rows_plain(torch.tensor(ax), torch.tensor(b),
                                  torch.tensor(md), torch.tensor(mu))
    for got, want in ((yt, yj), (mt, mj)):
        want = np.asarray(want.re) + 1j * np.asarray(want.im)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=2e-6 * np.abs(want).max())
    assert float(yt[2].abs().max()) == 0.0           # inactive row
    np.testing.assert_allclose(np.abs(yt[1].numpy()),   # zero row: 1/sqrt(r)
                               np.full(r, (b[1] / 1.0 + mu) / (1 + mu)
                                       / np.sqrt(r)), rtol=1e-6)


@pytest.mark.parametrize("per_entry", [False, True], ids=["row", "entry"])
def test_k5_plain_matches_jax_complex128(per_entry):
    rng = np.random.default_rng(1)
    ax, md, b = _state(rng, 53, 7)
    mu = 0.0123
    yj = np.asarray(jp.magnitude_prox(jnp.asarray(ax), jnp.asarray(b),
                                      jnp.asarray(md), mu, not per_entry))
    yt, mt = prox_dual_rows_plain(torch.tensor(ax), torch.tensor(b),
                                  torch.tensor(md),
                                  torch.tensor(mu, dtype=torch.float64),
                                  per_entry)
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-12 * np.abs(yj).max())
    mj = _dual(ax, md, yj, mu)
    np.testing.assert_allclose(mt.numpy(), mj, atol=1e-12 * np.abs(mj).max())
    # the wrapper takes the plain version on a CPU tensor and counts nothing
    before = launch_counts()["fused_prox_dual"]
    yw, mw = fused_prox_dual(torch.tensor(ax), torch.tensor(b),
                             torch.tensor(md),
                             torch.tensor(mu, dtype=torch.float64), per_entry)
    assert torch.equal(yw, yt) and torch.equal(mw, mt)
    assert launch_counts()["fused_prox_dual"] == before


def test_k5_plain_matches_goldens(g):
    mu = float(g["y_mu"])
    ax, md, b = (torch.tensor(g[k]) for k in ("y_ax", "y_md", "y_b"))
    for per_entry, key in ((False, "y_row_out"), (True, "y_elem_out")):
        y, m_new = prox_dual_rows_plain(ax, b, md,
                                        torch.tensor(mu, dtype=torch.float64),
                                        per_entry)
        np.testing.assert_allclose(y.numpy(), g[key], atol=1e-12)
        np.testing.assert_allclose(
            m_new.numpy(), _dual(g["y_ax"], g["y_md"], g[key], mu),
            atol=1e-12)
    for by_row, key in ((True, "yn_row_out"), (False, "yn_elem_out")):
        yn = tp.project_rows_to_magnitude(ax, b, by_row)
        np.testing.assert_allclose(yn.numpy(), g[key], atol=1e-12)


def _rand_z(rng, n, r):
    return rng.normal(size=(n, r)) + 1j * rng.normal(size=(n, r))


@pytest.mark.parametrize("nt,nr,m,rank_one", [(4, 4, 40, False),
                                              (8, 4, 64, True)])
def test_complex_prox_matches_jax(nt, nr, m, rank_one):
    rng = np.random.default_rng(nt * nr + m)
    n, r = nt * nr, 6
    # a low-rank panel plus noise, so the ladder rescales
    z = _rand_z(rng, n, 2) @ _rand_z(rng, 2, r) + 0.3 * _rand_z(rng, n, r)
    lad = tp.profile_ladder(nt, nr, m, n, rank_one)
    assert lad == jp.profile_ladder(nt, nr, m, n, rank_one)
    # JAX's LAPACK eigh ("xla") in place of its Jacobi solver: the same
    # decomposition to rounding, without a Jacobi compile per shape
    zj = np.asarray(jp.spectral_profile_prox(jnp.asarray(z), nt, nr, lad,
                                             eig_backend="xla"))
    zt = tp.spectral_profile_prox(torch.tensor(z), nt, nr, lad).numpy()
    np.testing.assert_allclose(zt, zj, atol=1e-12 * np.abs(zj).max())
    assert np.abs(zt - z).max() > 1e-3                 # the ladder moved z
    nj = np.asarray(jp.nuclear_prox(jnp.asarray(z), 0.8, eig_backend="xla"))
    nt_ = tp.nuclear_prox(torch.tensor(z), torch.tensor(0.8,
                                                        dtype=torch.float64))
    np.testing.assert_allclose(nt_.numpy(), nj, atol=1e-12 * np.abs(nj).max())
    e = tp._columns_to_panel(torch.tensor(z), nt, nr)
    np.testing.assert_array_equal(
        e.numpy(), np.asarray(jp._columns_to_panel(jnp.asarray(z), nt, nr)))
    np.testing.assert_array_equal(tp._panel_to_columns(e, nt, nr, r).numpy(),
                                  z)
    b = rng.uniform(0.5, 1.5, n)
    for by_row in (True, False):
        pj = np.asarray(jp.project_rows_to_magnitude(jnp.asarray(z),
                                                     jnp.asarray(b), by_row))
        pt = tp.project_rows_to_magnitude(torch.tensor(z), torch.tensor(b),
                                          by_row)
        np.testing.assert_allclose(pt.numpy(), pj, atol=1e-13)


def test_spectral_profile_prox_matches_goldens(g):
    for name in Z_CASES:
        nt, nr, m, n, r1 = (int(v) for v in g[f"z_{name}_shape"])
        lad = tp.profile_ladder(nt, nr, m, n, bool(r1))
        z_in = g[f"z_{name}_x"] + g[f"z_{name}_nd"] / float(g[f"z_{name}_mu"])
        z = tp.spectral_profile_prox(torch.tensor(z_in), nt, nr, lad)
        np.testing.assert_allclose(z.numpy(), g[f"z_{name}_out"], atol=1e-8,
                                   err_msg=name)
    for name in ("rect8x4", "rect4x8"):                # the rx-panel goldens
        nt, nr, m, n, r1 = (int(v) for v in g[f"z_{name}_shape"])
        lad = tp.profile_ladder(nt, nr, m, n, bool(r1))
        z_in = g[f"z_{name}_x"] + g[f"z_{name}_nd"] / float(g[f"z_{name}_mu"])
        z = tp.spectral_profile_prox(torch.tensor(z_in), nt, nr, lad)
        np.testing.assert_allclose(z.numpy(), g[f"z_{name}_out_rxpanel"],
                                   atol=1e-8, err_msg=name)


def test_spectral_initialize_matches_golden_and_jax(g):
    a, b, r = torch.tensor(g["si_a"]), torch.tensor(g["si_b"]), int(g["si_r"])
    xs = tsi.spectral_initialize(a, b, r, method="eigh").numpy()
    assert xs.shape == (64, r)
    np.testing.assert_allclose(xs @ xs.conj().T, g["si_proj"], atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(xs, axis=0), g["si_colnorm"],
                               atol=1e-9)
    # the subspace method (n 64 > 4r) runs the JAX package's 24 trips, too
    # few to converge on this Gram's small eigengaps: it stops near the
    # projector (JAX's own stops 3e-4 of its largest entry away)
    xsub = tsi.spectral_initialize(a, b, r, method="subspace",
                                   generator=torch.Generator().manual_seed(3))
    gap = np.abs(xsub.numpy() @ xsub.numpy().conj().T - g["si_proj"]).max()
    assert gap < 1e-3 * np.abs(g["si_proj"]).max()


def test_subspace_eigh_matches_jax_and_eigh():
    """With a clear eigengap, 24 trips of orthogonal iteration reach the
    top-k eigenpairs, from any start block."""
    rng = np.random.default_rng(9)
    n, k = 48, 6
    q = np.linalg.qr(_rand_z(rng, n, n))[0]
    w = np.concatenate([np.linspace(10.0, 5.0, k),
                        np.linspace(0.5, 0.01, n - k)])
    gm = (q * w) @ q.conj().T
    gm = 0.5 * (gm + gm.conj().T)
    wt, vt = tsi.subspace_eigh(torch.tensor(gm), k,
                               generator=torch.Generator().manual_seed(1))
    from twoace_tpu.ops.eigh_jacobi import subspace_eigh as jsub
    wj, vj = (np.asarray(v) for v in jsub(jnp.asarray(gm), k))
    np.testing.assert_allclose(wt.numpy(), w[:k], rtol=1e-12)
    np.testing.assert_allclose(wj, w[:k], rtol=1e-9)
    pt = vt.numpy() @ vt.numpy().conj().T
    np.testing.assert_allclose(pt, vj @ vj.conj().T, atol=1e-9)
    np.testing.assert_allclose(pt, q[:, :k] @ q[:, :k].conj().T, atol=1e-12)


def test_random_initialize_scales_by_the_largest_entry():
    like = torch.tensor([[1.0 + 2.0j, -3.0j], [0.5, 0.0]],
                        dtype=torch.complex128)
    gen = torch.Generator().manual_seed(0)
    x = tsi.random_initialize(gen, (5, 3), like)
    assert x.dtype == like.dtype and x.shape == (5, 3)
    assert float(x.imag.abs().max()) == 0.0
    assert 0.0 <= float(x.real.min()) and float(x.real.max()) <= 3.0
    x2 = tsi.random_initialize(torch.Generator().manual_seed(0), (5, 3), like)
    assert torch.equal(x, x2)


def test_k5_wrapper_checks_what_the_kernel_takes():
    """What a CUDA tensor must be for K5 (the checks are device-agnostic):
    complex64/complex128 contiguous (..., m, r) state, b of the matching
    real type and shape, mu a 0-d tensor of that type."""
    from twoace_tpu_torch.ops.kernels.prox_dual_rows import _check

    ax = torch.zeros(2, 5, 3, dtype=torch.complex64)
    b = torch.ones(2, 5)
    mu = torch.tensor(0.5)
    _check(ax, b, ax.clone(), mu)
    bad = [(ax.real.contiguous(), b, ax.real.contiguous(), mu),   # real
           (ax, b, ax.to(torch.complex128), mu),                  # mixed
           (ax, b.double(), ax, mu),                              # b type
           (ax, b[:, :4], ax, mu),                                # b shape
           (ax, b, ax, 0.5),                                      # host mu
           (ax, b, ax, torch.ones(1)),                            # mu shape
           (ax.transpose(0, 1), b.T, ax.transpose(0, 1), mu)]     # layout
    for args in bad:
        with pytest.raises(ValueError):
            _check(*args)


#: rows of the plan tests: none, one, ragged, the main path's, many
PLAN_ROWS = (0, 1, 7, 80, 97, 972, 1024, 5000)


@pytest.mark.parametrize("per_entry", [False, True])
def test_k5_plan_covers_every_entry_once(per_entry):
    """Over r 1 ... 64 and ragged rows: in the row form a row's lanes hold
    all its entries, each lane at most ``chunks`` of them (in registers up
    to 4, ``held``), and a warp's rows fit its 32 lanes; the blocks (1-8
    warps) cover every row (every entry, in the elementwise form) with
    less than one block to spare, and leave no SM idle that a warp could
    fill."""
    from twoace_tpu_torch.ops.kernels.prox_dual_rows import (
        MAX_HELD, MAX_WARPS, NUM_SMS, plan)

    for r in range(1, 65):
        for rows in PLAN_ROWS:
            p = plan(rows, r, per_entry)
            where = f"rows {rows} r {r}: {p}"
            warps_block = p["threads"] // 32
            assert p["threads"] % 32 == 0, where
            assert 1 <= warps_block <= MAX_WARPS, where
            assert p["elementwise"] == int(per_entry or r == 1), where
            if p["elementwise"]:
                per_block = p["threads"]
                work, warps = rows * r, -(-rows * r // 32)
            else:
                assert p["lanes"] * p["rows_per_warp"] <= 32, where
                assert p["lanes"] == min(r, 32), where
                assert p["lanes"] * p["chunks"] >= r, where
                assert p["lanes"] * (p["chunks"] - 1) < r, where
                if p["chunks"] <= MAX_HELD:
                    assert p["chunks"] <= p["held"] <= MAX_HELD, where
                else:
                    assert p["held"] == 0, where
                per_block = warps_block * p["rows_per_warp"]
                work, warps = rows, -(-rows // p["rows_per_warp"])
            assert p["blocks"] * per_block >= work, where
            assert (p["blocks"] - 1) * per_block < max(work, 1), where
            assert p["blocks"] >= min(NUM_SMS, warps), where


def test_k5_plan_at_the_main_path_shapes():
    """The campaign's (972, 20): a row of 20 lanes a warp, 139 blocks of 7
    warps; its per-entry pass 152 blocks of 4; the refine's (1024, 1) runs
    the elementwise form; r 3 packs 10 rows a warp; r 33 and 64 hold 2
    entries a lane, r 300 runs the two-pass form."""
    from twoace_tpu_torch.ops.kernels.prox_dual_rows import plan

    main = plan(972, 20)
    assert (main["lanes"], main["rows_per_warp"]) == (20, 1)
    assert (main["threads"], main["blocks"]) == (224, 139)
    entries = plan(972, 20, per_entry=True)
    assert (entries["threads"], entries["blocks"]) == (128, 152)
    assert plan(1024, 1)["elementwise"]
    assert plan(97, 3)["rows_per_warp"] == 10
    assert plan(10, 33)["chunks"] == plan(10, 64)["chunks"] == 2
    assert plan(10, 300)["held"] == 0


@pytest.mark.gpu
def test_k5_plan_matches_the_kernel():
    """The Python plan is the kernel's own (C
    ``twoace_prox_dual_rows_plan``)."""
    import ctypes

    require_cuda()
    from twoace_tpu_torch.ops.kernels import _build
    from twoace_tpu_torch.ops.kernels.prox_dual_rows import plan

    fn = _build.library().twoace_prox_dual_rows_plan
    out = (ctypes.c_int * 7)()
    keys = ("elementwise", "lanes", "rows_per_warp", "chunks", "held",
            "threads", "blocks")
    for per_entry in (False, True):
        for r in (1, 2, 3, 20, 33, 64, 300):
            for rows in PLAN_ROWS:
                assert fn(rows, r, int(per_entry), out) == 0
                assert dict(zip(keys, out)) == plan(rows, r, per_entry)


@pytest.mark.gpu
def test_k5_kernel_matches_plain_on_card():
    """K5 on the card against its plain version at the slice's shapes
    (campaign pass 1 and 2, the refine's r = 1, a tracker window with
    padded rows, a ragged m) in complex64, and once in complex128; then
    rows longer than a warp (r 33, 64: two entries a lane; r 300: read
    twice) in both dtypes and forms."""
    require_cuda()
    rng = np.random.default_rng(0)
    cases = [(972, 20, np.complex64, False), (972, 20, np.complex64, True),
             (1024, 1, np.complex64, False), (80, 20, np.complex64, False),
             (97, 3, np.complex64, True), (972, 20, np.complex128, False),
             *((m, r, dt, pe) for m, r in ((97, 33), (80, 64), (9, 300))
               for dt in (np.complex64, np.complex128)
               for pe in (False, True))]
    for m, r, dtype, per_entry in cases:
        ax, md, b = _state(rng, m, r, dtype)
        rdt = torch.float32 if dtype == np.complex64 else torch.float64
        args = (torch.tensor(ax, device="cuda"),
                torch.tensor(b, dtype=rdt, device="cuda"),
                torch.tensor(md, device="cuda"),
                torch.tensor(0.41, dtype=rdt, device="cuda"))
        before = fused_prox_dual.launches
        got = fused_prox_dual(*args, per_entry=per_entry)
        want = prox_dual_rows_plain(*args, per_entry=per_entry)
        torch.cuda.synchronize()
        assert fused_prox_dual.launches == before + 1
        tol = 2e-6 if dtype == np.complex64 else 1e-14
        for gt, wt in zip(got, want):
            assert float((gt - wt).abs().max()) <= tol * float(wt.abs().max())
