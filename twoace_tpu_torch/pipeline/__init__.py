"""End-to-end entry points (port of ``twoace_tpu.pipeline``): the
mobility tracker, the recovery campaigns, the simulation sweeps and the
testbed driver (``TestbedRunner``), all of ``twoace_tpu.pipeline``.
"""

from .mobility import (  # noqa: F401
    MobilityConfig,
    MobilityTrace,
    SimulatedMobilityConfig,
    brownian_trace,
    make_complex_solver,
    track,
    track_simulated,
)
from .recovery import (  # noqa: F401
    CampaignConfig,
    RecoveryOutput,
    recover_a2nuclear,
    recover_a2only,
    recover_campaign,
    recover_directional,
    recover_multiresolution,
    recover_phaselift,
    recover_warm_sweep,
)
from .simulation import (  # noqa: F401
    VS_SR_GRIDS,
    SimulationConfig,
    SweepResult,
    VsSrResult,
    infer_channel_windows,
    measurements_needed_vs_range,
    sweep_measurements,
    sweep_measurements_trace,
    sweep_snr,
)
from .testbed import TestbedConfig, TestbedRunner  # noqa: F401
