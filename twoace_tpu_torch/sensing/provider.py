"""Measurement providers (port of ``twoace_tpu.sensing.provider``): the
framework's hardware abstraction ``provider.measure(rows) -> RSS dBm``.

- :class:`SyntheticProvider`: RSS of a ground-truth channel through the
  testbed's forward chain, drawing its jitter from ``torch.Generator``s,
  on the channel's device;
- :class:`ReplayProvider`: replays a recorded RSS trace;
- :class:`RetryingProvider` and :class:`ThermalGuard`: the reference's
  retry ladder (ref: codebook_library.py:500-511) and thermal guard
  (ref: main.py:120-132), host-side.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Protocol

import numpy as np
import torch

from ..utils.rng import fold_in
from ..utils.units import RSSI_OFFSET, RSSI_SLOPE


class MeasurementProvider(Protocol):
    def measure(self, rows) -> np.ndarray:
        """Probe rows (m, n) -> RSS in dBm (m,)."""
        ...


def _median(x):
    """The median over dim 0, the mean of the two middle values for an
    even count (numpy's and JAX's convention; ``torch.median`` takes the
    lower one)."""
    s = torch.sort(x, dim=0).values
    k = x.shape[0]
    return s[k // 2] if k % 2 else 0.5 * (s[k // 2 - 1] + s[k // 2])


@dataclasses.dataclass
class SyntheticProvider:
    """Synthetic RSS from a ground-truth channel ``vec_h`` (n,) complex.

    The forward chain mirrors the testbed (ref: main.py:110-113): complex
    gain -> power in dBm -> ``n_dumps`` dumps with Gaussian jitter of
    ``noise_dbm_std`` -> their median -> the firmware RSSI word (the chip's
    calibration inverted, rounded, clipped to [0, 1000]) -> dBm.  Call k
    draws from ``fold_in(generator, k)`` on the CPU; the chain runs on
    vec_h's device.  Returns numpy dBm.
    """

    vec_h: torch.Tensor                 #: (n,) ground truth vec(H)
    noise_dbm_std: float = 0.5          #: per-dump RSS jitter
    n_dumps: int = 10                   #: dumps medianed per probe (ref :474)
    quantize_rssi: bool = True
    tx_power_dbm: float = 0.0
    generator: Optional[torch.Generator] = None   #: None: seed 0
    fail_rate: float = 0.0              #: fault injection probability

    _calls: int = dataclasses.field(default=0, init=False)

    def measure(self, rows) -> np.ndarray:
        self._calls += 1
        dev = self.vec_h.device
        rows = torch.as_tensor(rows, device=dev)
        gain = rows @ self.vec_h.to(rows.dtype)
        power_dbm = self.tx_power_dbm + 10.0 * torch.log10(
            torch.clamp(torch.abs(gain) ** 2, min=1e-30))
        k = fold_in(self.generator, self._calls)
        if self.fail_rate > 0.0:
            if float(torch.rand((), generator=fold_in(k, 99))) < self.fail_rate:
                raise ConnectionError("synthetic RSS dump failure (injected)")
        jitter = torch.randn((self.n_dumps, power_dbm.shape[0]), generator=k,
                             dtype=power_dbm.dtype).to(dev)
        med = _median(power_dbm[None, :] + self.noise_dbm_std * jitter)
        if self.quantize_rssi:
            # invert the chip calibration to integer RSSI words and back
            # (ref: main.py:113 dBm = 0.0652*rssi - 74.3875)
            rssi = torch.round((med - RSSI_OFFSET) / RSSI_SLOPE)
            rssi = torch.clamp(rssi, 0, 1000)        # clip>1000 -> 0 upstream
            med = rssi * RSSI_SLOPE + RSSI_OFFSET
        return med.cpu().numpy()


@dataclasses.dataclass
class ReplayProvider:
    """Replay a recorded RSS trace row-aligned with a codebook."""

    rss_dbm: np.ndarray
    _cursor: int = dataclasses.field(default=0, init=False)

    def measure(self, rows) -> np.ndarray:
        m = rows.shape[0]
        out = self.rss_dbm[self._cursor:self._cursor + m]
        self._cursor += m
        if len(out) < m:
            raise EOFError("replay trace exhausted")
        return np.asarray(out)


@dataclasses.dataclass
class RetryingProvider:
    """Retry ladder around any provider (ref: codebook_library.py:500-511):
    up to ``max_retries`` attempts with a reset hook between failures, then
    escalate."""

    inner: MeasurementProvider
    max_retries: int = 10
    reset_hook: Optional[Callable[[], None]] = None
    backoff_s: float = 0.0

    def measure(self, rows) -> np.ndarray:
        last: Optional[Exception] = None
        for _ in range(self.max_retries):
            try:
                return self.inner.measure(rows)
            except Exception as exc:   # noqa: BLE001 — the ladder catches all
                last = exc
                if self.reset_hook is not None:
                    self.reset_hook()
                if self.backoff_s:
                    time.sleep(self.backoff_s)
        raise RuntimeError(
            f"measurement failed after {self.max_retries} retries") from last


@dataclasses.dataclass
class ThermalGuard:
    """Thermal throttle (ref: main.py:120-132): sleep while a temperature
    readout exceeds its limit.  ``read_temps`` returns (mac_C, radio_C)."""

    read_temps: Callable[[], tuple]
    mac_limit: float = 70.0
    radio_limit: float = 62.5
    sleep_s: float = 20.0
    max_waits: int = 30
    sleep_fn: Callable[[float], None] = time.sleep

    def wait_until_cool(self) -> int:
        waits = 0
        while waits < self.max_waits:
            mac, radio = self.read_temps()
            if mac <= self.mac_limit and radio <= self.radio_limit:
                break
            self.sleep_fn(self.sleep_s)
            waits += 1
        return waits
