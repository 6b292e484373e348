"""The port's pair ops (``twoace_tpu_torch.ops.{cplx,prox,pair_solver}``)
against their JAX counterparts on shared numpy inputs.

Tolerances are float32's: ~1e-6 absolute on unit-scale elementwise ops,
~1e-5 where products or reductions of a few dozen terms are summed in
another order, and looser only where stated.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_pair_close, codebook, jpair, np_pair,
                          rand_pair_np, steer, tpair)
from twoace_tpu.ops import cplx as jc
from twoace_tpu.ops import pair_solver as jps
from twoace_tpu.ops import prox as jprox
from twoace_tpu.utils import metrics as jmetrics
from twoace_tpu_torch.ops import cplx as tc
from twoace_tpu_torch.ops import pair_solver as tps
from twoace_tpu_torch.ops import prox as tprox
from twoace_tpu_torch.utils import metrics as tmetrics


def test_matmul_and_herm_t_match_jax():
    rng = np.random.default_rng(0)
    a, b = rand_pair_np(rng, 2, 5, 7), rand_pair_np(rng, 2, 7, 3)
    assert_pair_close(tc.matmul(tpair(*a), tpair(*b)),
                      jc.matmul(jpair(*a), jpair(*b)), atol=1e-5)
    c = rand_pair_np(rng, 2, 7, 4)
    assert_pair_close(tc.matmul_herm_t(tpair(*b[::-1]), tpair(*c)),
                      jc.matmul_herm_t(jpair(*b[::-1]), jpair(*c)),
                      atol=1e-5)


def _prox_inputs(seed, lanes=3, r=5, m=24):
    rng = np.random.default_rng(seed)
    ax, md = rand_pair_np(rng, lanes, r, m), rand_pair_np(rng, lanes, r, m)
    b = rng.uniform(0.5, 2.0, (lanes, m)).astype(np.float32)
    b[:, :2] = 0.0                           # inactive padding columns
    for p in (ax, md):                       # zero columns and entries
        p[0][:, :, 3:5] = 0.0
        p[1][:, :, 3:5] = 0.0
        p[0][:, 1, 6] = 0.0
        p[1][:, 1, 6] = 0.0
    mu = rng.uniform(0.1, 1.0, lanes).astype(np.float32)
    return ax, md, b, mu


@pytest.mark.parametrize("per_entry", [False, True])
def test_magnitude_prox_matches_jax_per_lane(per_entry):
    ax, md, b, mu = _prox_inputs(1)
    tf = tc.magnitude_prox_cols_elem if per_entry else tc.magnitude_prox_cols
    jf = jps.magnitude_prox_cols_elem if per_entry else \
        jc.magnitude_prox_cols
    got = tf(tpair(*ax), torch.tensor(b), tpair(*md),
             torch.tensor(mu)[:, None, None])
    for lane in range(len(mu)):
        want = jf(jpair(ax[0][lane], ax[1][lane]), jnp.asarray(b[lane]),
                  jpair(md[0][lane], md[1][lane]), jnp.float32(mu[lane]))
        for g, w in zip(np_pair(got), np_pair(want)):
            np.testing.assert_allclose(g[lane], w, atol=1e-6, rtol=1e-6)
    # the zero-column branch and b == 0 masking are exercised
    y = np_pair(got)
    assert np.all(y[0][:, :, :2] == 0.0)


@pytest.mark.parametrize("scale_by_row", [True, False])
def test_project_cols_to_magnitude_matches_jax(scale_by_row):
    ax, _, b, _ = _prox_inputs(2, lanes=1)
    got = tps.project_cols_to_magnitude(tpair(ax[0][0], ax[1][0]),
                                        torch.tensor(b[0]), scale_by_row)
    want = jps.project_cols_to_magnitude(jpair(ax[0][0], ax[1][0]),
                                         jnp.asarray(b[0]), scale_by_row)
    assert_pair_close(got, want, atol=1e-6, rtol=1e-6)


LADDERS = [
    ((2, 0.8), (3, 0.9), (4, 0.95), (8, 0.995)),
    ((8, 0.995),),                     # the m >= 3n branch
    ((1, 0.95),),                      # the rank-1 ladder
]


def _lad_arrays_np(ladder, length=4, nr=8):
    ranks = [float(r) for r, _ in ladder] + [float(nr)] * (length - len(ladder))
    fracs = [float(f) for _, f in ladder] + [0.0] * (length - len(ladder))
    return np.float32(ranks), np.float32(fracs)


def test_ladder_scales_static_padded_and_per_lane():
    """Static ladders, their f = 0-padded LadderArrays form, and one
    ladder per lane all give JAX's scales; ties rank by index."""
    rng = np.random.default_rng(3)
    w = rng.uniform(0.5, 1.5, (len(LADDERS), 12)).astype(np.float32)
    w[:, 5] = w[:, 2]                        # exact ties
    w[1, 6] = 0.0
    ranks = np.stack([_lad_arrays_np(l, nr=12)[0] for l in LADDERS])
    fracs = np.stack([_lad_arrays_np(l, nr=12)[1] for l in LADDERS])
    per_lane = tc.ladder_scales(
        torch.tensor(w), tc.LadderArrays(torch.tensor(ranks),
                                         torch.tensor(fracs))).numpy()
    for i, lad in enumerate(LADDERS):
        want = np.asarray(jc.ladder_scales(jnp.asarray(w[i]), lad))
        want_arr = np.asarray(jc.ladder_scales(
            jnp.asarray(w[i]), jc.LadderArrays(jnp.asarray(ranks[i]),
                                               jnp.asarray(fracs[i]))))
        got = tc.ladder_scales(torch.tensor(w[i]), lad).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        # the batched variance sums reduce in another order: 1e-5
        np.testing.assert_allclose(per_lane[i], want_arr, rtol=1e-5, atol=0)
        assert np.all(np.isfinite(per_lane[i]))
        assert np.any(want < 1.0)            # every ladder acts here


def _hermitian_and_basis(rng, lanes, n, pert=0.05):
    """A Hermitian PSD Gram and a warm unitary basis: the exact
    eigenbasis of a nearby matrix."""
    x = rng.normal(size=(lanes, 3 * n, n)) + 1j * rng.normal(
        size=(lanes, 3 * n, n))
    g = np.conj(np.swapaxes(x, -1, -2)) @ x
    e = pert * (rng.normal(size=g.shape) + 1j * rng.normal(size=g.shape))
    _, v = np.linalg.eigh(g + e + np.conj(np.swapaxes(e, -1, -2)))
    return g.astype(np.complex64), v[..., ::-1].astype(np.complex64)


def test_eigh_update_perturbative_pair_matches_jax():
    rng = np.random.default_rng(4)
    g, v0 = _hermitian_and_basis(rng, 3, 6)
    lam_t, v_t = tc.eigh_update_perturbative_pair(tpair(g), tpair(v0))
    lam_j, v_j = jc.eigh_update_perturbative_pair(jpair(g), jpair(v0))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-5)
    assert_pair_close(v_t, v_j, atol=1e-5)


def _panel(rng, nr=6, cols=15):
    return rand_pair_np(rng, nr, cols)


@pytest.mark.parametrize("ladder", LADDERS[:2])
def test_panel_spectral_prox_c_warm_matches_jax(ladder):
    rng = np.random.default_rng(5)
    e = _panel(rng)
    ec = e[0] + 1j * e[1]
    # warm basis: eigenbasis of the Gram of a perturbed panel
    ep = ec + 0.05 * (rng.normal(size=ec.shape) + 1j * rng.normal(
        size=ec.shape))
    _, v0 = np.linalg.eigh(ep @ ep.conj().T)
    v0 = v0[:, ::-1].astype(np.complex64)
    nr = e[0].shape[0]
    lad_np = _lad_arrays_np(ladder, nr=nr)
    for lad_t, lad_j in (
            (ladder, ladder),
            (tc.LadderArrays(torch.tensor(lad_np[0]), torch.tensor(lad_np[1])),
             jc.LadderArrays(jnp.asarray(lad_np[0]), jnp.asarray(lad_np[1])))):
        e_t, v_t = tc._panel_spectral_prox_c(tpair(*e), nr, lad_t, tpair(v0))
        e_j, v_j = jc._panel_spectral_prox_c(jpair(*e), nr, lad_j, jpair(v0))
        assert_pair_close(e_t, e_j, atol=2e-5)
        assert_pair_close(v_t, v_j, atol=2e-5)


def test_panel_spectral_prox_c_cold_matches_jax():
    """Cold start: torch eigh against JAX's Jacobi.  The bases differ by
    column phases, so compare the basis-invariant output panel."""
    rng = np.random.default_rng(6)
    e = _panel(rng)
    e_t, _ = tc._panel_spectral_prox_c(tpair(*e), 6, LADDERS[0], None)
    e_j, _ = jc._panel_spectral_prox_c(jpair(*e), 6, LADDERS[0], None)
    assert_pair_close(e_t, e_j, atol=2e-5)


PROFILE_CASES = [
    # (nt, nr, m, n, rank_one, mode)
    (16, 16, 972, 256, False, "v4"),     # bench train split: 3-level tail
    (16, 16, 1024, 256, False, "v4"),    # m >= 3n
    (16, 16, 972, 256, True, "v4"),      # rank-1 retry
    (8, 8, 243, 64, False, "v4"),
    (4, 4, 30, 16, False, "v4"),         # small-size fallback
    (8, 8, 243, 64, False, "v1"),
    (8, 8, 243, 64, False, "v2"),
]


@pytest.mark.parametrize("case", PROFILE_CASES)
def test_profile_ladder_and_arrays_match_jax(case):
    *shape, rank_one, mode = case
    assert tprox.profile_ladder(*shape, rank_one, mode=mode) == \
        jprox.profile_ladder(*shape, rank_one, mode=mode)
    t = tprox.profile_ladder_arrays(*shape, rank_one, mode=mode)
    j = jprox.profile_ladder_arrays(*shape, rank_one, mode=mode)
    assert t.ranks.dtype == torch.float32
    np.testing.assert_array_equal(t.ranks.numpy(), np.asarray(j.ranks))
    np.testing.assert_array_equal(t.fracs.numpy(), np.asarray(j.fracs))


def test_precompute_u_pair_matches_jax():
    rng = np.random.default_rng(7)
    a = codebook(rng, 48, 16)
    a2 = codebook(rng, 48, 16)
    got = tps.precompute_u_pair(tpair(np.stack([a, a2])))
    for i, ai in enumerate((a, a2)):
        want = jps.precompute_u_pair(jpair(ai))
        for g, w in zip(np_pair(got), np_pair(want)):
            np.testing.assert_allclose(g[i], w, atol=2e-5)


def test_spectral_initialize_pair_matches_jax_gauge_invariant():
    """At a converged orthogonal-iteration depth the init is unique up to
    a unitary gauge of its r columns, so compare X0^T-products that do not
    see the gauge: X0 X0^H (n x n) of the port and of JAX."""
    rng = np.random.default_rng(8)
    n, m, r = 16, 64, 3
    a = codebook(rng, m, n)
    x = rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2))
    b = np.abs(a @ x).max(axis=1).astype(np.float32)
    got = tps.spectral_initialize_pair(
        tpair(a[None]), torch.tensor(b)[None, None], r,
        torch.Generator().manual_seed(0), iters=300)
    want = jps.spectral_initialize_pair(jpair(a), jnp.asarray(b), r,
                                        key=jax.random.PRNGKey(1), iters=300)
    gt = got.re[0, 0].numpy() + 1j * got.im[0, 0].numpy()     # (r, n)
    wj = np.asarray(want.re) + 1j * np.asarray(want.im)
    pt, pj = gt.T @ gt.conj(), wj.T @ wj.conj()
    np.testing.assert_allclose(pt, pj, atol=1e-4 * np.abs(pj).max())


#: (G, P, n, r) of the Cholesky-QR cases: a toy block, the 16x16 batch
#: scaffold's restarts and lanes, the 32x32 width
CHOLQR_SHAPES = [(1, 1, 16, 3), (3, 4, 256, 20), (1, 2, 1024, 20)]


@functools.lru_cache(maxsize=None)
def _two_path_gram(g_, p_, n):
    """The spectral init's scaled Gram (G, P, n, n), made Hermitian and
    scaled to unit mean eigenvalue, of P two-path channels a group (a ULA
    of sqrt(n) elements at each end, angles uniform in +-1.2 rad, complex
    Gaussian gains) measured through G codebooks of m = 2n probes; and a
    complex Gaussian start block (G, P, n, 20)."""
    rng = np.random.default_rng(n + 16 * p_ + g_)
    k, m = math.isqrt(n), 2 * n
    a = np.stack([codebook(rng, m, n) for _ in range(g_)])
    h = np.zeros((g_, p_, n), np.complex128)
    for _ in range(2):                       # two paths
        ang = rng.uniform(-1.2, 1.2, (g_, p_, 2))
        gain = rng.normal(size=(g_, p_)) + 1j * rng.normal(size=(g_, p_))
        for i, j in np.ndindex(g_, p_):
            h[i, j] += gain[i, j] * np.kron(steer(k, ang[i, j, 1]).conj(),
                                            steer(k, ang[i, j, 0]))
    b = np.abs(np.einsum("gmn,gpn->gpm", a, h)).astype(np.float32)
    gram = tps.scaled_gram_pair(tpair(a.real, a.imag), torch.tensor(b))
    gram = 0.5 * (gram + gram.mH)
    tr = torch.diagonal(gram, dim1=-2, dim2=-1).real.sum(-1)
    q = torch.complex(*(torch.tensor(rng.normal(size=(g_, p_, n, 20)),
                                     dtype=torch.float32) for _ in range(2)))
    return gram / (tr / n)[..., None, None], q


def _cholqr_block(shape, start):
    """A (G, P, n, r) complex64 block for _cholqr2: the random start
    block; the block trip k of the spectral init's orthogonal iteration
    hands it, gram @ Q_{k-1} with Q_{k-1} an orthonormal basis of
    gram^{k-1} q (condition numbers 1.3-3.2 here); or the start block
    with its singular values set to span 1 to 1e-3."""
    g_, p_, n, r = shape
    gram, q = _two_path_gram(g_, p_, n)
    z = q[..., :r].to(torch.complex128)
    if start == "cond1e3":
        u, _, vh = torch.linalg.svd(z, full_matrices=False)
        s = torch.logspace(0, -3, r, dtype=torch.float64)
        return ((u * s.to(u.dtype)) @ vh).to(torch.complex64)
    for _ in range(0 if start == "random" else int(start[4:])):
        z = gram.to(torch.complex128) @ torch.linalg.qr(z).Q
    return z.to(torch.complex64)


@pytest.mark.parametrize("start", ["random", "trip1", "trip12", "cond1e3"])
@pytest.mark.parametrize("shape", CHOLQR_SHAPES)
def test_cholqr2_orthonormal_basis_of_householder_subspace(shape, start):
    """_cholqr2 gives orthonormal columns spanning the subspace a
    Householder QR finds, on the blocks the spectral init orthonormalises
    and on a block of condition number 1e3.  The reference is taken in
    complex128.  Two float32 rounds with the reference's shift hold to
    condition numbers of a few thousand; at ~1e4 and beyond (an
    unnormalised gram^12 q) the first Cholesky breaks down, which the
    iteration, orthonormalising every trip, never meets."""
    z = _cholqr_block(shape, start)
    got = tps._cholqr2(z)
    assert got.dtype == torch.complex64 and got.shape == z.shape
    eye = torch.eye(z.shape[-1], dtype=got.dtype)
    assert float((got.mH @ got - eye).abs().max()) <= 1e-5
    ref = torch.linalg.qr(z.to(torch.complex128)).Q
    want = ref @ ref.mH
    err = (got.to(torch.complex128) @ got.mH.to(torch.complex128) - want)
    assert float(err.abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("shape", CHOLQR_SHAPES[:2])
def test_top_r_init_matches_householder_iteration(shape):
    """top_r_init at 12 trips against the same iteration orthonormalised
    by Householder QR, on X0 X0^H (blind to the basis of each step)."""
    g_, p_, n, r = shape
    gram, q = _two_path_gram(g_, p_, n)
    q = q[..., :r]
    got = tps.top_r_init(gram, q, iters=12)
    qh = torch.linalg.qr(q).Q
    for _ in range(12):
        qh = torch.linalg.qr(gram @ qh).Q
    rr = qh.mH @ (gram @ qh)
    w, v = torch.linalg.eigh(0.5 * (rr + rr.mH))
    want = (qh @ v) * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]
    xt = torch.complex(got.re, got.im).transpose(-1, -2)       # (.., n, r)
    pt, pw = xt @ xt.mH, want @ want.mH
    torch.testing.assert_close(pt, pw, rtol=0,
                               atol=1e-4 * float(pw.abs().max()))


def test_nmse_h_projection_matches_jax():
    """Same formula on complex64 data, summed in another order.  The
    residual of a near-exact estimate is a difference of near-equal
    float32 values, so its relative rounding grows as eps / sqrt(nmse):
    about 1e-4 at the -63 dB case, the tolerance here."""
    rng = np.random.default_rng(10)
    x_true = rand_pair_np(rng, 3, 16)
    x_true = x_true[0] + 1j * x_true[1]
    noise = rand_pair_np(rng, 3, 16)
    # a complex rescaling the metric must ignore, plus noise of rising size
    x_est = ((0.3 - 1.7j) * x_true
             + np.float32([1e-3, 1e-2, 1e-1])[:, None]
             * (noise[0] + 1j * noise[1])).astype(np.complex64)
    got = tmetrics.nmse_h_projection(torch.tensor(x_est),
                                     torch.tensor(x_true.astype(np.complex64)))
    want = jmetrics.nmse_h_projection(jnp.asarray(x_est),
                                      jnp.asarray(x_true, jnp.complex64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert np.all(np.diff(got.numpy()) > 0)


def test_orthonormalize_and_quality_match_jax():
    rng = np.random.default_rng(9)
    x = rand_pair_np(rng, 4, 12)
    xt = tps._orthonormalize_cols_t(tpair(*x))
    xj = jps._orthonormalize_cols_t(jpair(*x))
    # rows are X's eigen-directions, descending; phases are the solver's
    nt_, nj = (np.linalg.norm(p[0] + 1j * p[1], axis=1)
               for p in (np_pair(xt), np_pair(xj)))
    np.testing.assert_allclose(nt_, nj, rtol=1e-5)
    assert np.all(np.diff(nt_) <= 0)
    a = codebook(rng, 20, 12)
    b = np.abs(a @ (x[0][0] + 1j * x[1][0])).astype(np.float32) * 1.1
    q_t = tps._quality_pair(tpair(a[None]), torch.tensor(b)[None, None],
                            tpair(x[0][None, None, :1], x[1][None, None, :1]))
    q_j = jps._quality_pair(jpair(a), jnp.asarray(b),
                            jpair(x[0][0], x[1][0]))
    np.testing.assert_allclose(float(q_t[0, 0]), float(q_j), rtol=1e-5)
    assert math.isclose(float(q_j), 1 - 0.1 / 1.1, rel_tol=1e-4)
