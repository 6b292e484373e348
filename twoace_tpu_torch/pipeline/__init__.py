"""End-to-end entry points (port of ``twoace_tpu.pipeline``).

Ported so far: ``mobility``.  The recovery, simulation and testbed
pipelines are still to port.
"""

from .mobility import (  # noqa: F401
    MobilityConfig,
    MobilityTrace,
    SimulatedMobilityConfig,
    brownian_trace,
    track,
    track_simulated,
)
