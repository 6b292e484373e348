"""Shared helpers of the ``test_torch_*`` files: the same numpy inputs go
to the JAX package and to its PyTorch port.

Both packages see float32 data made from a fixed seed with numpy; JAX
arrays and torch tensors are built from those arrays and compared back in
numpy.
"""

import fcntl
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from twoace_tpu.ops.cplx import Pair as JPair
from twoace_tpu_torch.ops.cplx import Pair as TPair

# tier-1 runs several pytest workers: one torch thread each
torch.set_num_threads(1)


def shared_once(tmp_path_factory, name, fn):
    """``fn()``'s value, computed once for the whole session and shared
    by every xdist worker: pickled under the session's common temporary
    root, behind a file lock (a module fixture alone would run once per
    worker that draws one of the module's tests)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = fn()
        with open(path, "wb") as f:
            pickle.dump(value, f)
        return value


def spawn_one_thread(fn, world, args=(), timeout=300.0):
    """``spawn_ranks`` with one thread a rank: the session's workers
    share the host's cores, and spinning thread pools slow each other
    several times over."""
    from twoace_tpu_torch.parallel import spawn_ranks

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return spawn_ranks(fn, world, args, timeout=timeout)


def require_cuda():
    """Skip unless a CUDA device is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def rand_pair_np(rng, *shape):
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def jpair(re, im=None) -> JPair:
    if im is None:
        re, im = np.real(re), np.imag(re)
    return JPair(jnp.asarray(re, jnp.float32), jnp.asarray(im, jnp.float32))


def tpair(re, im=None, device=None) -> TPair:
    if im is None:
        re, im = np.real(re), np.imag(re)
    return TPair(torch.tensor(np.asarray(re, np.float32), device=device),
                 torch.tensor(np.asarray(im, np.float32), device=device))


def np_pair(p):
    """numpy (re, im) of a JAX or torch pair."""
    to = (lambda t: t.detach().cpu().numpy()) if isinstance(
        p.re, torch.Tensor) else np.asarray
    return to(p.re), to(p.im)


def assert_pair_close(got, want, atol, rtol=0.0, err_msg=""):
    for g, w in zip(np_pair(got), np_pair(want)):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol,
                                   err_msg=err_msg)


def steer(nn, ang):
    return np.exp(1j * np.pi * np.arange(nn) * np.sin(ang)) / np.sqrt(nn)


def codebook(rng, m, n):
    bits = rng.integers(0, 4, (m, n))
    return (np.exp(1j * bits * (np.pi / 2)) / np.sqrt(n)).astype(np.complex64)


def nmse_db(x_est, x_gt):
    c = np.vdot(x_est, x_gt) / max(np.vdot(x_est, x_est).real, 1e-30)
    err = np.linalg.norm(x_gt - c * x_est) ** 2 / np.linalg.norm(x_gt) ** 2
    return 10 * np.log10(max(err, 1e-30))


def jax_first_pass(key, a, b_batch, nt, nr, cfg,
                   prox_kind="spectral_profile"):
    """The JAX batch solver's first stage with its own key derivation
    (``solve_lowrank_multi_pair_batch``): returns numpy
    ``(splits, xs (B, R, r, n) pair, q (B, R))``."""
    from twoace_tpu.ops import pair_solver as jps
    from twoace_tpu.ops.prox import profile_ladder_arrays

    batch, m = b_batch.shape
    n = a.shape[1]
    n_restarts = cfg.n_restarts
    keys = jax.random.split(jax.random.fold_in(key, 7), batch)
    k_inits = jax.vmap(lambda ki: jnp.stack(
        [jax.random.split(jax.random.fold_in(ki, i))[1]
         for i in range(n_restarts)]))(keys)
    splits = [jps._split(jax.random.split(jax.random.fold_in(key, i))[0], m,
                         cfg.cc_frac) for i in range(n_restarts)]
    trains = jnp.stack([t for t, _ in splits])
    tests = jnp.stack([t for _, t in splits])
    m_act = int(np.sum(b_batch[0] > 0))
    pl = cfg.profile
    lad = profile_ladder_arrays(nt, nr, int(np.floor(m_act * cfg.cc_frac)),
                                n, False, pl.rank_mults, pl.fractions,
                                mode=pl.ladder)
    with jax.default_matmul_precision(cfg.matmul_precision):
        _, q, _, xs, *_ = jps._batch_first_pass(
            k_inits, jpair(a), jnp.asarray(b_batch, jnp.float32), trains,
            tests, lad, nt=nt, nr=nr, cfg=cfg, prox_kind=prox_kind,
            eig_mode="perturb", m_eff=m_act)
    return ((np.asarray(trains), np.asarray(tests)), np_pair(xs),
            np.asarray(q))


def jax_single_draws(key, a, b, cfg, n_restarts=None):
    """The JAX single solver's draws with its own key derivation
    (``_solve_lowrank_core``): per-restart splits and the spectral init of
    the normalized problem.  Returns numpy ``(splits, xs (R, r, n) pair)``
    with splits = (trains (R, k), tests (R, m - k))."""
    from twoace_tpu.ops import pair_solver as jps

    m, n = a.shape
    n_restarts = cfg.n_restarts if n_restarts is None else n_restarts
    r = min(cfg.rank, m, n)
    with jax.default_matmul_precision(cfg.matmul_precision):
        a_n, b_n, _, _ = jps._normalize_problem_pair(
            jpair(a), jnp.asarray(b, jnp.float32), cfg.tol_abs)
        keys_r = [jax.random.fold_in(key, i) for i in range(n_restarts)]
        splits = [jps._split(jax.random.split(k)[0], m, cfg.cc_frac)
                  for k in keys_r]
        xs = [jps.spectral_initialize_pair(jps._take_rows(a_n, tr), b_n[tr],
                                           r, key=jax.random.split(k)[1])
              for k, (tr, _) in zip(keys_r, splits)]
    trains = np.stack([np.asarray(t) for t, _ in splits])
    tests = np.stack([np.asarray(t) for _, t in splits])
    xs = (np.stack([np_pair(x)[0] for x in xs]),
          np.stack([np_pair(x)[1] for x in xs]))
    return (trains, tests), xs
