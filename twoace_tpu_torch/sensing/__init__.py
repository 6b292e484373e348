"""Codebooks, sensing and measurement (port of ``twoace_tpu.sensing``).

Ported so far: the random family of ``codebooks``, its angle-uniform
directional beams and ``kron_probe_rows``; ``sensing_matrix``'s
``generate_sensing_matrix`` (``Random_Phase_State`` and
``Directional_Beam_Angular``) and ``pick_beams`` (the
``Random_Phase_State`` pick); and ``provider``.
"""

from .codebooks import (  # noqa: F401
    Codebook,
    directional_beams_angular,
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
from .sensing_matrix import (  # noqa: F401
    SensingMatrix,
    generate_sensing_matrix,
    pick_beams,
)
