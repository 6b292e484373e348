"""Codebook generation (port of ``twoace_tpu.sensing.codebooks``).

A codebook is data: integer phase *bits* (2-bit by default) plus an
amplitude mask, and functions that compile them into complex beamforming
rows and kron probe matrices.  The bits are drawn from an explicit
``torch.Generator`` on the CPU; the map from bits to rows is a function of
its own (:func:`phase_rows`), so tests can hand both packages the same
bits.  Families (ref file for each):

- random per-round codebooks (generate_rx_codebook_16ant_random.py:44-92);
- directional beams: angle-uniform (Directional_Beam_Angular.m),
  spatial-uniform (Directional_Beam.m), random-gain
  (Directional_Random_Beam.m) and region (Region_Random_Beam.m).  Their
  beam-space design (a pinv through the steering dictionary) is a small
  host computation in float64; the quantized beams go to the device;
- azimuth and azimuth x elevation sweeps, the three-tier multi-resolution
  codebook (generate_rx_codebook_multires_16ant.py:47-144) and the ACO
  phase-sweep masks with their 4-point DFT CSI recovery
  (generate_rx_codebook_16ant_ACO.py, codebook_library.py:518-591);
- the SVD beamformer and the on-air evaluation codebook
  (codebook_library.py:57-451);
- kron probe assembly (processsing_codebook_random.m:54-62,
  processsing_codebook_multires.m:60-61).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ArrayConfig
from ..interop import resolve_device
from ..models.steering import dictionary, steering_vector, virtual_grid
from ..utils.metrics import quantize_ps
from ..utils.rng import fold_in


def phase_rows(bits, phase_bit: int = 2, amp=None, normalize_by=None):
    """Complex rows ``amp * exp(1j * bits * 2pi/2^b)`` (complex64) of an
    integer bits tensor, divided by ``sqrt(normalize_by)`` when given.
    ref: processsing_codebook_random.m:48-51, Generate_Sensing_Matrix.m:110-118.
    """
    nps = 2 ** phase_bit
    ang = bits.to(torch.float32) * (2.0 * math.pi / nps)
    w = torch.polar(torch.ones_like(ang), ang)
    if amp is not None:
        w = w * amp
    if normalize_by is not None:
        w = w / math.sqrt(normalize_by)
    return w


class Codebook(NamedTuple):
    """A phase-bit codebook: the replacement of the reference's ``.brd``
    images."""

    bits: torch.Tensor           #: (entries, n_ant) integer phase bits
    amp: torch.Tensor            #: (n_ant,) 0/1 amplitude mask
    phase_bit: int = 2
    #: optional per-antenna calibration bits already folded into ``bits``
    #: (the "actual" table); None means the bits are the ideal table
    calibration: Optional[np.ndarray] = None

    @property
    def n_ant(self) -> int:
        return self.bits.shape[-1]

    def rows(self, normalize: bool = False) -> torch.Tensor:
        """Complex beamforming rows ``amp * exp(1j * bits * 2pi/2^b)``.

        ref: processsing_codebook_random.m:48-51.  ``normalize`` divides by
        sqrt(n_active) (sensing-matrix convention).
        """
        n_act = max(float(torch.sum(self.amp)), 1.0) if normalize else None
        return phase_rows(self.bits, self.phase_bit, self.amp, n_act)


def random_phase_bits(generator: Optional[torch.Generator], m: int, n: int,
                      phase_bit: int = 2, device="cuda") -> torch.Tensor:
    """Uniform random phase bits ``(m, n)`` (int64) on ``device``.

    The bits are drawn row after row from the generator on the CPU, so the
    first M rows are the same for any larger m: the nesting property the
    reference gets by drawing measurements incrementally
    (ref: Generate_Sensing_Matrix.m:86-99).
    """
    bits = torch.randint(0, 2 ** phase_bit, (m, n), generator=generator)
    return bits.to(resolve_device(device))


def random_codebook(generator: Optional[torch.Generator], entries: int,
                    n_ant: int, phase_bit: int = 2,
                    device="cuda") -> Codebook:
    """Per-round random 2-bit codebook (ref: generate_rx_codebook_16ant_random.py)."""
    bits = random_phase_bits(generator, entries, n_ant, phase_bit, device)
    return Codebook(bits=bits, amp=torch.ones(n_ant, device=bits.device),
                    phase_bit=phase_bit)


def random_sensing_rows(generator: Optional[torch.Generator], m: int, n: int,
                        phase_bit: int = 2, device="cuda") -> torch.Tensor:
    """Random phase-state sensing rows ``exp(1j b 2pi/Np)/sqrt(n)``.

    The ``Random_Phase_State`` mode draws the full (Nt*Nr)-length row
    directly (ref: Generate_Sensing_Matrix.m:110-118), not a Tx x Rx kron.
    """
    bits = random_phase_bits(generator, m, n, phase_bit, device)
    return phase_rows(bits, phase_bit, normalize_by=n)


def kron_probe_rows(tx_rows, rx_rows, interleave: bool = False):
    """Assemble full probe rows from per-round Tx sectors and one Rx row.

    ``tx_rows``: (rounds, sectors, nt) complex; ``rx_rows``: (rounds, nr).
    Row (i, j) is ``kron(tx_rows[i, j], rx_rows[i])``: Rx index fastest,
    matching vec(H).  ``interleave=False``: round-major, sector index
    fastest (the MULTIRES ordering, ref: processsing_codebook_multires.m:60-61);
    ``interleave=True``: sector-major, round index fastest (the RANDOM
    ordering, ref: processsing_codebook_random.m:54-62).
    """
    rounds, sectors, nt_ = tx_rows.shape
    nr_ = rx_rows.shape[-1]
    cb = torch.einsum("ijt,ir->ijtr", tx_rows, rx_rows)
    cb = cb.reshape(rounds, sectors, nt_ * nr_)
    if interleave:
        cb = cb.transpose(0, 1)
    return cb.reshape(rounds * sectors, nt_ * nr_)


def directional_beams_angular(mt: int, mr: int, cfg: ArrayConfig,
                              aod_range: Tuple[float, float],
                              aoa_range: Tuple[float, float], device="cuda"):
    """Directional beams uniform in angle: Mt / Mr sector centres, 2-bit
    quantized.  Returns ``(F (nt, mt), W (nr, mr))`` complex64 on
    ``device``.  ref: Directional_Beam_Angular.m:65-86.
    """
    dev = resolve_device(device)

    def centers(rng, m):
        edges = np.linspace(rng[0], rng[1], m + 1)
        return torch.as_tensor((edges[:-1] + edges[1:]) / 2.0, device=dev)

    f = steering_vector(torch.sin(torch.deg2rad(centers(aod_range, mt))),
                        cfg.nt, cfg.k_d).T
    w = steering_vector(torch.sin(torch.deg2rad(centers(aoa_range, mr))),
                        cfg.nr, cfg.k_d).T
    return quantize_ps(f, cfg.phase_bit), quantize_ps(w, cfg.phase_bit)


def _quantized(fmat: np.ndarray, phase_bit: int, device) -> torch.Tensor:
    """2^b-PSK quantization of host float64 beams, moved to ``device`` as
    complex64 (the quantization is made in complex128, as JAX makes it
    with 64-bit types on)."""
    q = quantize_ps(torch.as_tensor(fmat, dtype=torch.complex128), phase_bit)
    return q.to(torch.complex64).to(resolve_device(device))


def _pinv_beams(beam_space: np.ndarray, n_ant: int, nq: int,
                cfg: ArrayConfig) -> np.ndarray:
    """Least-squares antenna weights of an (nq, m) beam-space gain target,
    ``pinv(A^H) @ beam_space`` through the steering dictionary, at unit
    Frobenius norm (ref: Directional_Beam.m:139-145)."""
    a = dictionary(n_ant, nq, cfg.k_d, torch.complex128, device="cpu").numpy()
    fmat = np.linalg.pinv(a.conj().T) @ beam_space
    return fmat / np.linalg.norm(fmat)


def _fov_positions(nq: int, searching_area_deg: float) -> np.ndarray:
    """Grid indices of the virtual grid inside +-searching_area/2."""
    half = math.radians(searching_area_deg / 2.0)
    grid = virtual_grid(nq)
    return np.arange(int(np.argmin(np.abs(grid + math.sin(half)))),
                     int(np.argmin(np.abs(grid - math.sin(half)))) + 1)


def _overlap_slots(npos: int, m: int):
    """Sub-grid width and the beams whose sub-grid overlaps the next one
    (ref: Directional_Beam.m:100-118)."""
    sub = math.ceil(npos / m)
    n_overlap = sub * m - npos
    overlap = (set(range(1, math.ceil(n_overlap / 2) + 1))
               | set(range(m - n_overlap // 2, m)))
    return sub, overlap


def _subgrid_gains(npos: int, m: int, small_gain: float, fill) -> np.ndarray:
    """(npos, m) gains: beam i carries ``fill(sub)`` on its sub-grid and
    ``small_gain`` elsewhere."""
    sub, overlap = _overlap_slots(npos, m)
    gain = np.full((npos, m), small_gain)
    start = 0
    for i in range(m):
        gain[start:start + sub, i] = fill(sub)
        start += sub - 1 if (i + 1) in overlap else sub
    return gain


def directional_beams_spatial(mt: int, mr: int, cfg: ArrayConfig,
                              searching_area_deg: float,
                              oversample: int = 20,
                              small_gain: float = 0.05,
                              rank_eliminated: int = 0,
                              generator: Optional[torch.Generator] = None,
                              device="cuda"):
    """Directional beams with uniform gain in the spatial (sin) domain:
    boxcar beam-space targets with overlap, least-squares mapped to antenna
    weights, then 2-bit quantized.  ref: Directional_Beam.m:69-167.

    ``rank_eliminated`` (ref :56-57, 84-88, 169-178) lowers the rank of F/W
    for the two-stage pipeline: ``mt - rank_eliminated`` independent beams
    are designed, then ``rank_eliminated`` correlated ones, pairwise sums
    of columns drawn without replacement (``torch.randperm`` from
    ``fold_in(generator, 0)`` for F and ``fold_in(generator, 1)`` for W),
    are appended.  It is clamped as JAX clamps it (the reference errors
    when RE > (Mt-1)/2).  Returns ``(F (nt, mt), W (nr, mr))`` complex64 on
    ``device``.
    """
    rank_eliminated = max(0, min(int(rank_eliminated), mt - 3))
    rank_eliminated = min(rank_eliminated, (mt - 1) // 2, (mr - 1) // 2)
    if rank_eliminated > 0 and generator is None:
        raise ValueError("rank_eliminated > 0 requires a generator")

    def side(n_ant, nq_base, m):
        nq = oversample * nq_base
        pos = _fov_positions(nq, searching_area_deg)
        beam_space = np.zeros((nq, m))
        beam_space[pos, :] = _subgrid_gains(len(pos), m, small_gain,
                                            lambda sub: 1.0)
        return _quantized(_pinv_beams(beam_space, n_ant, nq, cfg),
                          cfg.phase_bit, device)

    f = side(cfg.nt, cfg.grid_t, mt - rank_eliminated)
    w = side(cfg.nr, cfg.grid_r, mr - rank_eliminated)
    if rank_eliminated > 0:
        def append_correlated(mat, m, gen):
            # datasample(1:M, min(2*RE, M), 'Replace', false), then
            # column i + RE' = col(ind[i]) + col(ind[i+1]) (ref :170-177)
            ind = torch.randperm(m, generator=gen)[:min(2 * rank_eliminated,
                                                         m)].tolist()
            cols = [mat[:, ind[i]] + mat[:, ind[i + 1]]
                    for i in range(rank_eliminated)]
            return torch.cat([mat, torch.stack(cols, dim=1)], dim=1)

        f = append_correlated(f, mt - rank_eliminated, fold_in(generator, 0))
        w = append_correlated(w, mr - rank_eliminated, fold_in(generator, 1))
    return f, w


def _beam_seed(generator: Optional[torch.Generator],
               seed: Optional[int]) -> int:
    """The seed of the numpy stream the random-gain beams draw: ``seed``
    where given (tests hand over JAX's), else one draw from
    ``generator``."""
    if seed is not None:
        return int(seed)
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=generator))


def directional_random_beams(generator: Optional[torch.Generator], mt: int,
                             mr: int, cfg: ArrayConfig,
                             searching_area_deg: float,
                             oversample: int = 20, small_gain: float = 0.05,
                             seed: Optional[int] = None, device="cuda"):
    """Directional beams with random per-position gains in each beam's FoV
    sub-grid (ref: Directional_Random_Beam.m:67-160): the FoV positions
    are partitioned into Mt overlapping sub-grids; beam i carries
    ``|N(0,1)|*20+5`` gains on its sub-grid and ``small_gain`` elsewhere.
    The gains come from ``np.random.default_rng`` seeded by one draw of
    ``generator`` (or ``seed``), the Tx side first.
    """
    rng = np.random.default_rng(_beam_seed(generator, seed))

    def side(n_ant, nq_base, m):
        nq = oversample * nq_base
        pos = _fov_positions(nq, searching_area_deg)
        beam_space = np.zeros((nq, m))
        beam_space[pos, :] = _subgrid_gains(
            len(pos), m, small_gain,
            lambda sub: np.abs(rng.normal(size=sub)) * 20 + 5)
        return _quantized(_pinv_beams(beam_space, n_ant, nq, cfg),
                          cfg.phase_bit, device)

    return side(cfg.nt, cfg.grid_t, mt), side(cfg.nr, cfg.grid_r, mr)


def region_random_beams(generator: Optional[torch.Generator], mt: int,
                        mr: int, cfg: ArrayConfig, searching_area_deg: float,
                        small_gain: float = 0.01, seed: Optional[int] = None,
                        device="cuda"):
    """Random-gain beams over the whole FoV with one normalized dominant
    peak per beam, peaks spread uniformly by circular shift
    (ref: Region_Random_Beam.m:66-135).  Draws as
    :func:`directional_random_beams` does.
    """
    rng = np.random.default_rng(_beam_seed(generator, seed))

    def side(n_ant, m):
        nq = n_ant                       # ref :77-78: NQ = N
        pos = _fov_positions(nq, searching_area_deg)
        npos = len(pos)
        g = np.abs(rng.normal(size=(npos, m))) * 20 + 5
        mean_max = g.max(axis=0).mean()
        mean_rest = (g.sum() - mean_max * m) / m
        r = g.argmax(axis=0)
        for i in range(m):
            g[r[i], i] = mean_max
            rest = np.delete(g[:, i], r[i])
            g[np.arange(npos) != r[i], i] = rest * mean_rest / rest.sum()
            g[:, i] = np.roll(g[:, i], i * round(npos / m) - r[i])
        beam_space = np.full((nq, m), small_gain)
        beam_space[pos, :] = g
        return _quantized(_pinv_beams(beam_space, n_ant, nq, cfg),
                          cfg.phase_bit, device)

    return side(cfg.nt, mt), side(cfg.nr, mr)


# ------------------------------------------------------------ sweep family

def sweep_codebook_2d(cfg: ArrayConfig, n_az: int, n_el: int,
                      az_range: Tuple[float, float] = (-60.0, 60.0),
                      el_range: Tuple[float, float] = (-30.0, 30.0),
                      cols: Optional[int] = None, device="cuda") -> Codebook:
    """Azimuth x elevation sweep codebook over the URA geometry
    (ref: codebook/generate_rx_codebook_16ant_sweeping_thetaNphi.py;
    36 = 6 az x 6 el combos on the testbed URA).  Beam (a, e) steers to
    azimuth[a], elevation[e] using the per-antenna URA positions."""
    from .grouping import location_phase, ura_coordinates

    coords = ura_coordinates(cfg.nr, cols)
    az = np.deg2rad(np.linspace(az_range[0], az_range[1], n_az))
    el = np.deg2rad(np.linspace(el_range[0], el_range[1], n_el))
    nps = 2 ** cfg.phase_bit
    bits = np.zeros((n_az * n_el, cfg.nr), np.int64)
    for i, a in enumerate(az):
        for j, e in enumerate(el):
            ph = -location_phase(coords, a, e)
            bits[i * n_el + j] = np.round(ph / (2 * np.pi / nps)) % nps
    dev = resolve_device(device)
    return Codebook(bits=torch.as_tensor(bits, device=dev),
                    amp=torch.ones(cfg.nr, device=dev),
                    phase_bit=cfg.phase_bit)


def sweep_codebook(cfg: ArrayConfig, n_az: int,
                   az_range: Tuple[float, float] = (-90.0, 90.0),
                   device="cuda") -> Codebook:
    """Azimuth sweep codebook: one quantized steering beam per azimuth
    (ref: codebook/generate_rx_codebook_16ant_sweeping_phi.py; 32
    azimuths).  The steering phase is formed in float64 and rounded
    through complex64, as JAX forms it."""
    az = np.linspace(az_range[0], az_range[1], n_az, endpoint=False)
    sin = torch.sin(torch.deg2rad(torch.as_tensor(az, dtype=torch.float64)))
    phase = (-cfg.k_d * sin[:, None]
             * torch.arange(cfg.nr, dtype=torch.float64)).float()
    ang = torch.angle(torch.polar(torch.ones_like(phase), phase))
    nps = 2 ** cfg.phase_bit
    bits = torch.round(ang / (2 * math.pi / nps)).to(torch.int64) % nps
    dev = resolve_device(device)
    return Codebook(bits=bits.to(dev), amp=torch.ones(cfg.nr, device=dev),
                    phase_bit=cfg.phase_bit)


# ---------------------------------------------------------- multires family

#: per-antenna calibration bits of the reference's 16-of-32 testbed panel
#: (ref: generate_rx_codebook_multires_16ant.py:49-50, active-antenna order)
REFERENCE_CALIBRATION_16 = np.array(
    [0, 2, 3, 0, 0, 3, 0, 3, 1, 0, 0, 3, 0, 3, 0, 0], np.int32)


def default_groupings(n_ant: int) -> Tuple[Sequence[Sequence[int]], ...]:
    """Tier groupings: groups of 4, groups of 2, singletons.

    Generalizes the hand-derived hardware grouping of the reference
    (ref: generate_rx_codebook_multires_16ant.py:48 and
    codebook/group_antenna/group_ant_kernel.m:9-69) to contiguous groups
    for an arbitrary array.
    """
    g4 = [list(range(i, min(i + 4, n_ant))) for i in range(0, n_ant, 4)]
    g2 = [list(range(i, min(i + 2, n_ant))) for i in range(0, n_ant, 2)]
    g1 = [[i] for i in range(n_ant)]
    return (g4, g2, g1)


def multires_codebook(generator: Optional[torch.Generator], n_ant: int,
                      rounds: Tuple[int, int, int] = (32, 64, 64),
                      phase_bit: int = 2,
                      calibration: Optional[np.ndarray] = None,
                      groupings=None, group_bits=None,
                      device="cuda") -> Tuple[Codebook, Codebook]:
    """Three-tier multi-resolution codebook.

    Tier t draws one random phase bit per antenna group (group sizes
    4 / 2 / 1) from ``fold_in(generator, t)``, so coarse tiers have fewer
    independent phase degrees of freedom
    (ref: generate_rx_codebook_multires_16ant.py:47-144).  ``group_bits``:
    the tiers' (rounds_t, groups_t) bits, drawn here when None (tests hand
    over JAX's).

    Returns ``(inferred, actual)``: the ideal table and the
    calibration-compensated table flashed to hardware
    (``actual_bit = (ideal - calibration) mod 2^b``, ref :84-87).
    """
    if groupings is None:
        groupings = default_groupings(n_ant)
    if calibration is None:
        calibration = np.zeros(n_ant, np.int32)
    dev = resolve_device(device)
    nps = 2 ** phase_bit
    tiers = []
    for tier, (n_rounds, groups) in enumerate(zip(rounds, groupings)):
        if group_bits is None:
            gbits = torch.randint(0, nps, (n_rounds, len(groups)),
                                  generator=fold_in(generator, tier))
        else:
            gbits = torch.tensor(np.asarray(group_bits[tier]),
                                 dtype=torch.int64)
        ant_of_group = np.zeros(n_ant, np.int64)
        for gi, g in enumerate(groups):
            ant_of_group[g] = gi
        tiers.append(gbits[:, torch.as_tensor(ant_of_group)])
    inferred = torch.cat(tiers, dim=0).to(dev)
    calib = torch.as_tensor(np.asarray(calibration), dtype=torch.int64,
                            device=dev)
    actual = (inferred - calib[None, :]) % nps
    amp = torch.ones(n_ant, device=dev)
    return (Codebook(bits=inferred, amp=amp, phase_bit=phase_bit),
            Codebook(bits=actual, amp=amp, phase_bit=phase_bit,
                     calibration=np.asarray(calibration)))


# --------------------------------------------------------------- ACO family

def aco_sweep_codebook(n_ant: int, ref_bit: int = 0, phase_bit: int = 2,
                       device="cuda") -> Codebook:
    """Per-antenna phase-sweep masks for Agile-Link-style ACO calibration.

    Entry (i*2^b + p) keeps all antennas at ``ref_bit`` except antenna i at
    phase bit p.  ref: codebook/generate_rx_codebook_16ant_ACO.py:44-165.
    """
    nps = 2 ** phase_bit
    bits = np.full((n_ant * nps, n_ant), ref_bit, np.int64)
    for i in range(n_ant):
        bits[i * nps:(i + 1) * nps, i] = np.arange(nps)
    dev = resolve_device(device)
    return Codebook(bits=torch.as_tensor(bits, device=dev),
                    amp=torch.ones(n_ant, device=dev), phase_bit=phase_bit)


def rss_to_csi(rss_linear, n_ant: int, phase_bit: int = 2):
    """Per-antenna complex CSI from a phase-sweep RSS trace: a 2^b-point DFT
    over the phase positions; the first harmonic's angle is the antenna's
    relative phase, the amplitude follows from the DC and first-harmonic
    magnitudes.  ref: main/codebook_library.py:518-526."""
    rss = torch.as_tensor(rss_linear).reshape(n_ant, 2 ** phase_bit)
    spec = torch.fft.fft(rss, dim=-1)
    gamma = spec[:, 0].real
    first = spec[:, 1]
    delta = torch.abs(first)
    amp = 0.5 * (torch.sqrt(torch.clamp(gamma + 2 * delta, min=0.0))
                 - torch.sqrt(torch.clamp(gamma - 2 * delta, min=0.0)))
    return torch.polar(torch.abs(amp), torch.angle(first))


def conj_phase_bits(h, phase_bit: int = 2):
    """The conjugate phase of a CSI vector rounded to phase bits (the ACO
    beam).  ref: main/codebook_library.py:584-591 (get_ACO_codebook_bit)."""
    nps = 2 ** phase_bit
    w = torch.round(torch.angle(torch.conj(h)) / (2 * math.pi / nps))
    return w.to(torch.int64) % nps


# ------------------------------------------------------------ beamforming

def svd_beamformer_bits(h, phase_bit: int = 2, compensation=None):
    """Best 2-bit Tx/Rx beam pair from an (estimated) channel matrix.

    Quantize the conjugated phases of all right singular vectors of H and
    of H^T, then pick the (tx, rx) pair maximizing the predicted RSS
    ``|w_t^T H w_r|^2`` (first on ties).  Returns integer bit vectors
    ``(wt, wr)`` on h's device.  ref: main/codebook_library.py:57-95.
    The SVD's per-vector phase is arbitrary, so two SVDs of one H may give
    other bits of the same gain.

    ``compensation``: per-antenna hardware phase offsets (radians)
    subtracted from the winning beam before the final bit rounding
    (ref: svd_beamformer_compensation, codebook_library.py:97-135).
    """
    nps = 2 ** phase_bit
    step = 2.0 * math.pi / nps
    _, _, vh_r = torch.linalg.svd(h)
    _, _, vh_t = torch.linalg.svd(h.T)
    wr = torch.polar(torch.ones_like(vh_r.real),
                     -torch.round(torch.angle(vh_r) / step) * step).T
    wt = torch.polar(torch.ones_like(vh_t.real),
                     -torch.round(torch.angle(vh_t) / step) * step).T
    gain = torch.abs(torch.einsum("ti,tr,rj->ij", wt, h, wr)) ** 2
    idx = int(torch.argmax(gain))
    i, j = divmod(idx, gain.shape[1])
    wt_win, wr_win = wt[:, i], wr[:, j]
    if compensation is not None:
        comp = torch.as_tensor(np.asarray(compensation),
                               dtype=torch.float64).to(h.device)
        comp = torch.polar(torch.ones_like(comp), -comp).to(h.dtype)
        wt_win = wt_win * comp[:wt_win.shape[0]]
        wr_win = wr_win * comp[:wr_win.shape[0]]
    wt_bits = torch.round(torch.angle(wt_win) / step).to(torch.int64) % nps
    wr_bits = torch.round(torch.angle(wr_win) / step).to(torch.int64) % nps
    return wt_bits, wr_bits


def evaluation_codebook(generator: Optional[torch.Generator], h_estimates,
                        h_directional=None, wt_aco_bits=None,
                        wr_aco_bits=None, nt: int = 16, nr: int = 16,
                        phase_bit: int = 2, compensation=None,
                        n_probe: int = 50):
    """Assemble the on-air evaluation codebook from recovered channels.

    ref: main/codebook_library.py:192-451 (codebook_generator): one SVD
    beam pair per estimated H (the first with hardware-offset
    compensation, ref :197-200), one per directional-H estimate
    (ref :205-209), the ACO codeword pair (ref :211-212), and a block of
    ``n_probe`` random 2-bit probe sectors (ref :215-300 hard-codes
    chip-calibrated tables), drawn from ``fold_in(generator, 0)`` (Tx) and
    ``fold_in(generator, 1)`` (Rx).

    Returns ``(tx_bits, rx_bits)`` int64 tensors of shape (K, nt) / (K, nr)
    on the estimates' device.
    """
    h_estimates = torch.as_tensor(h_estimates)
    if h_estimates.dim() == 1:
        h_estimates = h_estimates[None]
    dev = h_estimates.device
    tx, rx = [], []
    for i in range(h_estimates.shape[0]):
        wt_b, wr_b = svd_beamformer_bits(
            h_estimates[i].reshape(nt, nr), phase_bit,
            compensation=compensation if i == 0 else None)
        tx.append(wt_b)
        rx.append(wr_b)
    if h_directional is not None:
        h_directional = torch.as_tensor(h_directional, device=dev)
        if h_directional.dim() == 1:
            h_directional = h_directional[None]
        for i in range(h_directional.shape[0]):
            wt_b, wr_b = svd_beamformer_bits(
                h_directional[i].reshape(nt, nr), phase_bit)
            tx.append(wt_b)
            rx.append(wr_b)
    if wt_aco_bits is not None:
        tx.append(torch.as_tensor(wt_aco_bits, device=dev).to(torch.int64))
        rx.append(torch.as_tensor(wr_aco_bits, device=dev).to(torch.int64))
    if n_probe > 0:
        nps = 2 ** phase_bit
        tx.append(torch.randint(0, nps, (n_probe, nt),
                                generator=fold_in(generator, 0)).to(dev))
        rx.append(torch.randint(0, nps, (n_probe, nr),
                                generator=fold_in(generator, 1)).to(dev))
    tx_bits = torch.cat([torch.atleast_2d(t) for t in tx], dim=0)
    rx_bits = torch.cat([torch.atleast_2d(r) for r in rx], dim=0)
    return tx_bits, rx_bits
