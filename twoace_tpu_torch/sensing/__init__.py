"""Codebooks, sensing and measurement (port of ``twoace_tpu.sensing``):
every codebook family, antenna grouping, Bayes A-optimal beam selection,
the sensing-matrix modes and beam picks, the codebook image files
(``brd``, over ``native/libtbrd.so``) and the measurement providers,
synthetic and over TCP (``native/rss_server``).
"""

from .bayes_opt import (  # noqa: F401
    a_criterion,
    bayes_a_opt_select,
    noise_prior_from_vech,
    prior_from_channel,
)
from .brd import (  # noqa: F401
    CodebookImage,
    export_codebook_set,
    read_phase_table,
)
from .codebooks import (  # noqa: F401
    Codebook,
    aco_sweep_codebook,
    conj_phase_bits,
    default_groupings,
    directional_beams_angular,
    directional_beams_spatial,
    directional_random_beams,
    evaluation_codebook,
    kron_probe_rows,
    multires_codebook,
    phase_rows,
    random_codebook,
    random_phase_bits,
    random_sensing_rows,
    region_random_beams,
    rss_to_csi,
    svd_beamformer_bits,
    sweep_codebook,
    sweep_codebook_2d,
)
from .provider import (  # noqa: F401
    ReplayProvider,
    RetryingProvider,
    SyntheticProvider,
    ThermalGuard,
)
from .sensing_matrix import (  # noqa: F401
    SensingMatrix,
    directional_beam_bayes,
    directional_beam_bayes_v2,
    generate_sensing_matrix,
    pick_beams,
)
from .tcp_provider import ServerProcess, TcpProvider, build_server  # noqa: F401
