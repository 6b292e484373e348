"""Configuration dataclasses of the PyTorch port.

A field-for-field copy of ``twoace_tpu.config``: the dataclasses
``AdmmConfig``, ``SpectralProfileConfig``, ``ArrayConfig``,
``ChannelConfig`` and ``MethodFlags``, the campaign constants and
:func:`probe_budget_grid`.  It is a copy and not an import because
importing ``twoace_tpu`` pulls in jax; ``tests/test_torch_config.py``
holds every default to the JAX package's.  The lifted baselines'
configs (``PhaseLiftConfig``, ``TwoStageConfig``) wait for the
baselines.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

SPEED_OF_LIGHT = 3.0e8
#: 60.48 GHz carrier (ref: A2only.m:40)
DEFAULT_CARRIER_HZ = 60.48e9
#: wavelength of the 60.48 GHz carrier
DEFAULT_LAMBDA = SPEED_OF_LIGHT / DEFAULT_CARRIER_HZ
#: antenna spacing of the QCA6310 URA (ref: A2only.m:41)
DEFAULT_SPACING = 3.055e-3
#: RSS multiplicative factor moving amplitudes near 1 (ref: A2only.m:132)
DEFAULT_RSS_FCT = 1e5 / 3.0

#: Fixed seed table of the MATLAB entry points (ref: A2only.m:103): a
#: ``seed_id`` names the same experiment in every stack, though the random
#: streams drawn from a seed differ between them.
SEED_TABLE: Tuple[int, ...] = (
    58659179, 42737934, 36326041, 89830260, 90710947, 96474890, 33424536,
    67991541, 42149446, 38961924, 54659060, 32629256, 33087755, 27433950,
    9404442, 20146383, 84040563, 75325961, 47726929, 13999319, 5597853,
    74801351, 37024073, 75534492, 99245881, 19650488, 5314224, 98859252,
    60803022, 76056701, 14112116, 64027813, 73073690, 6288587, 42217659,
    45632040, 7495955, 31960297, 92863244, 93081516,
)


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """Uniform rectangular array geometry (the reference's ``ULA`` struct)."""

    nt: int = 16                      #: number of Tx antennas
    nr: int = 16                      #: number of Rx antennas
    wavelength: float = DEFAULT_LAMBDA
    spacing: float = DEFAULT_SPACING  #: element spacing d
    phase_bit: int = 2                #: phase-shifter resolution in bits
    nqt: Optional[int] = None         #: AoD grid size (default 4*nt)
    nqr: Optional[int] = None         #: AoA grid size (default 4*nr)

    @property
    def n(self) -> int:
        return self.nt * self.nr

    @property
    def grid_t(self) -> int:
        return 4 * self.nt if self.nqt is None else self.nqt

    @property
    def grid_r(self) -> int:
        return 4 * self.nr if self.nqr is None else self.nqr

    @property
    def k_d(self) -> float:
        """2*pi*d/lambda, the spatial frequency scale."""
        return 2.0 * math.pi * self.spacing / self.wavelength


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Synthetic sparse-multipath channel parameters (Eq. 23 model)."""

    n_paths: int = 3                 #: L, number of dominant paths
    searching_area_deg: float = 95.0 #: AoD/AoA range
    rician_k: int = 5                #: number of NLOS paths when L == 1
    k_factor_db: float = 7.0         #: Rician K-factor
    on_grid: bool = False            #: snap AoD/AoA to the virtual grid
    fix_angles: bool = False         #: debug mode with fixed angles


@dataclasses.dataclass(frozen=True)
class SpectralProfileConfig:
    """The 2ACE spectral-profile constraint ladder
    (ref: inferLowRankV4_multi.m:437-464); ``ladder`` is "v1" or "v4"."""

    ladder: str = "v4"
    #: rank multipliers of the ladder r_k = ceil(sqrt(sz) * mult)
    rank_mults: Tuple[float, ...] = (0.5, 0.7, 1.0, 2.0)
    #: variance fractions f_k of the ladder
    fractions: Tuple[float, ...] = (0.8, 0.9, 0.95, 0.995)


@dataclasses.dataclass(frozen=True)
class AdmmConfig:
    """2ACE ADMM solver hyper-parameters (defaults mirror
    inferLowRankV4_multi.m:6-15).

    ``matmul_precision`` and ``kernel_precision`` are carried for interop
    with the JAX package's config.  The port computes every product in
    float32 with TF32 off, which is JAX's "float32"; ``warm_iters`` keeps
    its phase switch (the reset of ``converged`` and the best-so-far
    objective), but its trips are float32 too, not JAX's single-pass
    "default".
    """

    lam: float = 0.0          #: ridge weight lambda
    rank: int = 20            #: over-parameterization width r
    mu0: float = 1e-3         #: initial augmented-Lagrangian weight
    rho: float = 1.03         #: mu adaptation multiplier
    cc_frac: float = 0.95     #: train fraction of the internal split
    tol_rel: float = 1e-4
    tol_abs: float = 1e-8
    maxiter: int = 500
    n_restarts: int = 3       #: restarts (ref :42)
    quality_threshold: float = 0.6   #: rank-1 retry / rollback gate
    similarity_threshold: float = 0.6  #: refinement rollback gate
    spectral_init: bool = True
    prox: str = "spectral_profile"   #: "spectral_profile" | "nuclear" | "none"
    profile: SpectralProfileConfig = SpectralProfileConfig()
    matmul_precision: str = "float32"
    #: first-pass trips before the warm-phase reset
    warm_iters: int = 0
    kernel_precision: str = "default"
    #: iteration cap of the first (scale_by_row) pass; None = maxiter
    stage1_maxiter: Optional[int] = None
    #: iteration cap of the second (per-column) pass; None = maxiter
    stage2_maxiter: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class MethodFlags:
    """Which recovery algorithms to run (the reference's ``Method`` struct,
    ref: A2only.m:66-101, Recover_Channel.m:3-45)."""

    phaselift: bool = False
    cprl: bool = False
    prgamp: bool = False
    sparse_pl: bool = False
    plomp: bool = False
    plgamp: bool = False
    admm: bool = False            #: version 0 (inferMinL2)
    admm_lowrank_v1: bool = False
    admm_lowrank_v2: bool = False
    admm_lowrank_v3: bool = False
    admm_lowrank_v4: bool = True  #: the 2ACE "A2" solver
    admm_nuclear: bool = False

    def enabled(self):
        return [f.name for f in dataclasses.fields(self) if getattr(self, f.name)]


def probe_budget_grid(nt: int, nr: int, num: int = 8) -> Tuple[int, ...]:
    """The M grid ``round(linspace(2, sqrt(4*Nt*Nr), num)).^2`` (ref:
    A2only.m:106-118); (4, 36, 121, 225, 361, 529, 784, 1024) for 16x16.
    MATLAB's round() takes halves away from zero."""
    lin = np.linspace(2.0, np.sqrt(4.0 * nt * nr), num)
    return tuple(int(np.floor(x + 0.5)) ** 2 for x in lin)


#: multi-resolution tier thresholds and row offsets of the 16-antenna
#: codebook (ref: channel_recovery_ADMM_v2_simulation_multiresolution.m:111-112)
MULTIRES_THRESHOLDS: Tuple[int, int] = (96, 256)
MULTIRES_SEPARATION: Tuple[int, int, int] = (1984, 3968, 3968)
