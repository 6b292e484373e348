"""K2: warm spectral-profile Z-prox, one CUDA block per lane
(``csrc/zprox.cu``).

Port of ``twoace_tpu.ops.pallas.kernels.fused_zprox_t`` and its batched
form ``fused_zprox_batch``, with the ladder as per-lane runtime tensors.
A CPU tensor takes the plain version :func:`zprox_t_plain`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..cplx import (Pair, LadderArrays, add, conj, eigh_desc,
                    eigh_update_perturbative_pair, hermitian_part,
                    ladder_scales, matmul, matmul_herm_t, scale, transpose)
from . import _build

#: the kernel keeps one thread's ladder state in 32-entry registers
MAX_NR = 32


def zprox_t_plain(z: Pair, v0, nt: int, nr: int, ladder: LadderArrays):
    """Batched ``_panel_spectral_prox_c`` on the W form.

    W = z.reshape(lanes, r*nt, nr) is a free view of the transposed state;
    its Gram W^H W is the conjugate of the panel Gram E E^H, so the basis
    is conjugated between the E- and W-conventions at entry and exit.
    ``v0`` (lanes, nr, nr) E-convention, or None for the cold start from
    ``eigh``.  Returns ``(z_new, v_new)`` with v_new in the E-convention.
    """
    lanes = z.re.shape[0]
    w = Pair(z.re.reshape(lanes, -1, nr), z.im.reshape(lanes, -1, nr))
    g = hermitian_part(matmul_herm_t(w, w))
    if v0 is None:
        lam, v = eigh_desc(g)
    else:
        lam, v = eigh_update_perturbative_pair(g, conj(v0))
    coeff = torch.sqrt(ladder_scales(torch.clamp(lam, min=0.0), ladder)) - 1.0
    delta = matmul(scale(v, coeff[..., None, :]), conj(transpose(v)))
    w_new = add(w, matmul(w, delta))
    return (Pair(w_new.re.reshape(z.re.shape), w_new.im.reshape(z.im.shape)),
            conj(v))


def _check(z: Pair, v0: Pair, nt: int, nr: int, ladder: LadderArrays):
    lanes, r, n = z.re.shape
    if n != nt * nr:
        raise ValueError(f"z has {n} columns, need nt*nr = {nt * nr}")
    if not 1 <= nr <= MAX_NR:
        raise ValueError(f"the kernel takes 1 <= nr <= {MAX_NR}, got {nr}")
    levels = ladder.ranks.shape[-1]
    _build.check_inputs({"z.re": (z.re, (lanes, r, n)),
                         "z.im": (z.im, (lanes, r, n)),
                         "v0.re": (v0.re, (lanes, nr, nr)),
                         "v0.im": (v0.im, (lanes, nr, nr)),
                         "ladder.ranks": (ladder.ranks, (lanes, levels)),
                         "ladder.fracs": (ladder.fracs, (lanes, levels))},
                        z.re.device)


def fused_zprox_t(z: Pair, v0: Pair, nt: int, nr: int,
                  ladder: LadderArrays):
    """Warm spectral-profile Z-prox of every lane.

    ``z``: (lanes, r, nt*nr) pair; ``v0``: (lanes, nr, nr) unitary pair in
    the E-convention of ``cplx.panel_gram_basis_pair``; ``ladder``: ranks
    and fracs (lanes, L), padded levels with f = 0.  Returns
    ``(z_new, v_new)``, v_new in the E-convention, so the kernel and the
    plain version are interchangeable inside the solver loop.
    """
    if z.re.device.type == "cpu":
        return zprox_t_plain(z, v0, nt, nr, ladder)
    if z.re.device.type != "cuda":
        raise ValueError(f"unsupported device {z.re.device}")
    _check(z, v0, nt, nr, ladder)
    lanes, r, _ = z.re.shape
    lib = _build.library()
    zn = [torch.empty_like(z.re) for _ in range(2)]
    vn = [torch.empty_like(v0.re) for _ in range(2)]
    stream = torch.cuda.current_stream(z.re.device).cuda_stream
    rc = lib.twoace_zprox_t(
        z.re.data_ptr(), z.im.data_ptr(), v0.re.data_ptr(), v0.im.data_ptr(),
        ladder.ranks.data_ptr(), ladder.fracs.data_ptr(),
        zn[0].data_ptr(), zn[1].data_ptr(), vn[0].data_ptr(),
        vn[1].data_ptr(), lanes, r * nt, nr, ladder.ranks.shape[-1], stream)
    _build.check(rc, "fused_zprox_t")
    fused_zprox_t.launches += 1
    return Pair(*zn), Pair(*vn)


fused_zprox_t.launches = 0
