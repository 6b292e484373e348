"""Codebooks, sensing and measurement (port of ``twoace_tpu.sensing``).

Ported so far: the random family of ``codebooks`` and ``kron_probe_rows``,
``sensing_matrix.pick_beams`` (the ``Random_Phase_State`` pick) and
``provider``.
"""

from .codebooks import (  # noqa: F401
    Codebook,
    kron_probe_rows,
    phase_rows,
    random_codebook,
    random_phase_bits,
    random_sensing_rows,
)
from .provider import (  # noqa: F401
    ReplayProvider,
    RetryingProvider,
    SyntheticProvider,
    ThermalGuard,
)
from .sensing_matrix import pick_beams  # noqa: F401
