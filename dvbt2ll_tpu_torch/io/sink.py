"""IQ sample sinks.

The reference flowgraph ends in ``blocks_multiply_const_xx`` (gain) and a
``uhd_usrp_sink`` (apps/vv009-4kshort.grc).  The framework's sinks cover
the software side of that contract: scalar gain plus interleaved-float
cf32 output (the format SDR toolchains consume), to a file or any
writable object.
"""
from __future__ import annotations

import numpy as np


class IQFileSink:
    """Writes complex64 samples as interleaved float32 ('cf32' format)."""

    def __init__(self, path: str, gain: float = 1.0):
        self._f = open(path, "wb")
        self.gain = np.float32(gain)
        self.samples_written = 0

    def write(self, iq: np.ndarray) -> None:
        data = np.ascontiguousarray(iq.reshape(-1), dtype=np.complex64)
        if self.gain != 1.0:
            data = data * self.gain
        data.view(np.float32).tofile(self._f)
        self.samples_written += data.size

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
