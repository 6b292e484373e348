"""End-to-end entry points (port of ``twoace_tpu.pipeline``).

Ported so far: ``mobility``, ``recovery`` and the Vs_M / Vs_SNR parts of
``simulation``.  The testbed pipeline is still to port.
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
    recover_multiresolution,
    recover_warm_sweep,
)
from .simulation import (  # noqa: F401
    SimulationConfig,
    SweepResult,
    sweep_measurements,
    sweep_snr,
)
