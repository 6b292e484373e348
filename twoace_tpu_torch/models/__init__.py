"""Channel and dictionary models (port of ``twoace_tpu.models``).

Ported so far: ``steering`` and ``channel``; ``sparse`` and
``measurement`` are still to port.
"""

from .channel import Channel, from_matrix, generate_channel, perturb_channel  # noqa: F401
from .steering import (  # noqa: F401
    angle_dictionary,
    dictionary,
    fov_window,
    steering_vector,
    unvec_channel,
    vec_channel,
    virtual_grid,
)
