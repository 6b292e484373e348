"""Channel and dictionary models (port of ``twoace_tpu.models``).

All four are ported: ``steering``, ``channel``, ``sparse`` and
``measurement``.
"""

from .channel import Channel, from_matrix, generate_channel, perturb_channel  # noqa: F401
from .measurement import Measurements, generate_measurement  # noqa: F401
from .sparse import SparseRepresentation, sparse_formulation  # noqa: F401
from .steering import (  # noqa: F401
    angle_dictionary,
    dictionary,
    fov_window,
    steering_vector,
    unvec_channel,
    vec_channel,
    virtual_grid,
)
