"""TCP measurement provider: client for the native ``rss_server`` (port
of ``twoace_tpu.sensing.tcp_provider``; both packages build and run the
same ``native/rss_server``).

The framework's equivalent of ``fetch_rss``
(ref: main/codebook_library.py:453-516): newline-delimited JSON over TCP,
``per_beam_snr`` command, multiple dumps per probe with median/outlier
handling, and the RSSI -> dBm calibration.  The server side
(``native/rss_server.cc``) replaces the closed-source
``wil6210_server-2.2.0`` binary.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from ..utils.units import RSSI_OFFSET, RSSI_SLOPE

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")


def _host(x) -> np.ndarray:
    """A numpy copy of ``x``, which may be a tensor on the card: the probe
    rows travel to the server as JSON."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def build_server(native_dir: Optional[str] = None) -> str:
    """Compile the native server if needed; returns the binary path."""
    d = os.path.abspath(native_dir or _NATIVE_DIR)
    binary = os.path.join(d, "rss_server")
    src = os.path.join(d, "rss_server.cc")
    if (not os.path.exists(binary)
            or os.path.getmtime(binary) < os.path.getmtime(src)):
        subprocess.run(["make", "-C", d, "rss_server"], check=True,
                       capture_output=True)
    return binary


class TcpProvider:
    """MeasurementProvider over the native RSS server.

    Mirrors fetch_rss semantics: ``n_dumps`` RSS dumps per probe, median
    across dumps, values > 1000 zeroed as outliers (ref: main.py:110-112),
    then the chip calibration to dBm.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 10002,
                 timeout_s: float = 10.0):
        self.addr = (host, port)
        self.timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None

    # ------------------------------------------------------------- transport
    def _connect(self):
        if self._sock is None:
            s = socket.create_connection(self.addr, timeout=self.timeout_s)
            self._file = s.makefile("rwb")
            self._sock = s

    def _rpc(self, obj: dict) -> dict:
        self._connect()
        self._file.write((json.dumps(obj) + "\n").encode())
        self._file.flush()
        line = self._file.readline()
        if not line:
            self.close()
            raise ConnectionError("rss_server closed the connection")
        return json.loads(line)

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    # -------------------------------------------------------------- protocol
    def set_channel(self, vec_h) -> None:
        h = _host(vec_h)
        r = self._rpc({"cmd": "set_channel",
                       "re": h.real.tolist(), "im": h.imag.tolist()})
        if not r.get("ok"):
            raise RuntimeError(f"set_channel failed: {r}")

    def set_noise(self, std_db: float, seed: int = 12345) -> None:
        r = self._rpc({"cmd": "set_noise", "std_db": std_db, "seed": seed})
        if not r.get("ok"):
            raise RuntimeError(f"set_noise failed: {r}")

    def measure(self, rows) -> np.ndarray:
        rows = _host(rows)
        r = self._rpc({"cmd": "set_beams",
                       "re": rows.real.tolist(), "im": rows.imag.tolist()})
        if not r.get("ok"):
            raise RuntimeError(f"set_beams failed: {r}")
        resp = self._rpc({"cmd": "per_beam_snr"})
        dumps = np.asarray(resp["snr"], float)          # (n_dumps, m)
        med = np.median(dumps, axis=0)
        med[med > 1000] = 0.0                            # outliers (ref :112)
        return med * RSSI_SLOPE + RSSI_OFFSET


class ServerProcess:
    """Context manager launching the native server on a free port."""

    def __init__(self, port: int = 0, n_dumps: int = 10):
        if port == 0:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
        self.port = port
        self.n_dumps = n_dumps
        self.proc: Optional[subprocess.Popen] = None

    def __enter__(self) -> "ServerProcess":
        binary = build_server()
        self.proc = subprocess.Popen(
            [binary, str(self.port), str(self.n_dumps)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        # wait for the listening banner
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                socket.create_connection(("127.0.0.1", self.port),
                                         timeout=0.2).close()
                return self
            except OSError:
                if self.proc.poll() is not None:
                    err = self.proc.stderr.read().decode()
                    raise RuntimeError(f"rss_server died: {err}")
                time.sleep(0.05)
        raise TimeoutError("rss_server did not start")

    def __exit__(self, *exc):
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        return False
