"""Codebooks and sensing (port of ``twoace_tpu.sensing``).

Ported so far: the random family of ``codebooks`` and ``kron_probe_rows``.
"""

from .codebooks import (  # noqa: F401
    Codebook,
    kron_probe_rows,
    phase_rows,
    random_codebook,
    random_phase_bits,
    random_sensing_rows,
)
