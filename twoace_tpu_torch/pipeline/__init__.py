"""End-to-end entry points (port of ``twoace_tpu.pipeline``).

Ported so far: ``mobility``, ``recovery`` and ``simulation``.  The
testbed pipeline is still to port.
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
