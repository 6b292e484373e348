"""Random streams of the port: ``torch.Generator``s derived the way the
JAX package derives PRNG keys."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def fold_in(generator: Optional[torch.Generator], data: int
            ) -> torch.Generator:
    """A CPU generator derived from ``generator``'s seed and ``data``, as
    ``jax.random.fold_in`` derives a key: what one derived stream draws
    does not depend on what another drew."""
    seed = 0 if generator is None else generator.initial_seed()
    state = np.random.SeedSequence([seed, data]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))
