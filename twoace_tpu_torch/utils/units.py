"""dB / power / amplitude conversion chains (port of
``twoace_tpu.utils.units``).

The exact scaling chains of the reference, so that RSS traces mean the
same thing in every stack:

- ``db2pow`` / ``pow2db`` (MATLAB built-ins used throughout);
- the testbed RSSI -> dBm calibration ``0.0652*rssi - 74.3875``
  (ref: main/main.py:113);
- the dBm -> amplitude chain ``sqrt(db2pow(rss)/1000) * rss_fct``
  (ref: main/channel_recovery_ADMM_v2_simulation_A2only.m:139).

Each function takes a tensor (kept on its device and dtype) or anything
``torch.as_tensor`` takes, and returns a tensor.
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_RSS_FCT

#: QCA6320 chip-specific RSSI calibration (ref: main/main.py:113)
RSSI_SLOPE = 0.0652
RSSI_OFFSET = -74.3875


def db2pow(x):
    """10^(x/10)."""
    return torch.pow(10.0, torch.as_tensor(x) / 10.0)


def pow2db(x):
    """10*log10(x)."""
    return 10.0 * torch.log10(torch.as_tensor(x))


def rssi_to_dbm(rssi):
    """Raw firmware RSSI word -> dBm (ref: main/main.py:110-113).  The
    reference clips words above 1000 to 0 before this; the caller does."""
    return torch.as_tensor(rssi) * RSSI_SLOPE + RSSI_OFFSET


def dbm_to_amplitude(rss_dbm, rss_fct: float = DEFAULT_RSS_FCT):
    """dBm RSS -> the linear field amplitude the ADMM solvers take as b:
    ``sqrt(db2pow(rss)/1000) * rss_fct`` (ref: A2only.m:139)."""
    return torch.sqrt(db2pow(rss_dbm) / 1000.0) * rss_fct


def amplitude_to_dbm(amp, rss_fct: float = DEFAULT_RSS_FCT):
    """Inverse of :func:`dbm_to_amplitude`."""
    power_w = torch.square(torch.as_tensor(amp) / rss_fct) * 1000.0
    return pow2db(power_w)
