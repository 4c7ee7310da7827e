"""MPEG-TS byte-stream sources.

The reference system feeds the chain from an external gr-ule TS source
(apps/vv009-4kshort.grc); for the framework we provide synthetic and
file-backed sources producing raw 188-byte-packet streams.
"""
import numpy as np


def synthetic_ts(n_bytes: int, seed: int = 0, pid: int = 0x100) -> np.ndarray:
    """A valid TS byte stream: 0x47 sync every 188 bytes, PRBS payload."""
    rng = np.random.default_rng(seed)
    n_packets = -(-n_bytes // 188)
    pkts = rng.integers(0, 256, size=(n_packets, 188), dtype=np.uint8)
    pkts[:, 0] = 0x47
    pkts[:, 1] = (pid >> 8) & 0x1F
    pkts[:, 2] = pid & 0xFF
    return pkts.reshape(-1)[:n_bytes]


class TSFileSource:
    """Cyclic reader over a .ts file."""

    def __init__(self, path: str):
        self._data = np.fromfile(path, dtype=np.uint8)
        if self._data.size < 188:
            raise ValueError("TS file too small")
        # align to the first sync byte
        start = int(np.argmax(self._data[:188] == 0x47))
        self._data = self._data[start:]
        self._pos = 0

    def read(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint8)
        got = 0
        while got < n:
            take = min(n - got, self._data.size - self._pos)
            out[got : got + take] = self._data[self._pos : self._pos + take]
            self._pos = (self._pos + take) % self._data.size
            got += take
        return out
