"""Seeded MPEG-TS pools.

A rewritten copy of the port's ``io.ts.synthetic_ts`` and of
``bench.staged_windows`` that takes the run's ``--seed``: the same seed
gives the same bytes, and any whole number is a seed.  A pool holds K
distinct steps of TS for every mux; a run cycles through them (the
chain's time does not depend on the payload), so mux c's stream is
``pool[0, c], pool[1, c], ..., pool[K - 1, c], pool[0, c], ...``.  Every
step is a whole number of 188-byte packets starting at a 0x47 sync byte,
so the cycled stream is one valid TS.
"""
from __future__ import annotations

import numpy as np

PACKET = 188
SYNC = 0x47
PID = 0x100


def rng(seed: int, *tags: int) -> np.random.Generator:
    """The generator of one use of ``seed``: each use passes its own tags,
    so the TS, the sample of frames checked and anything else drawn from
    the seed are independent streams.  Negative and large seeds work."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % 2**64, *tags]))


def ts_packets(n_bytes: int, gen: np.random.Generator,
               pid: int = PID) -> np.ndarray:
    """``n_bytes`` (a multiple of 188) of TS: 0x47 sync, the PID's two
    header bytes, uniform random payload."""
    if n_bytes % PACKET:
        raise ValueError(f"{n_bytes} bytes are not whole TS packets")
    pkts = gen.integers(0, 256, size=(n_bytes // PACKET, PACKET),
                        dtype=np.uint8)
    pkts[:, 0] = SYNC
    pkts[:, 1] = (pid >> 8) & 0x1F
    pkts[:, 2] = pid & 0xFF
    return pkts.reshape(-1)


def ts_pool(seed: int, k_steps: int, n_mux: int,
            bytes_per_step: int) -> np.ndarray:
    """(k_steps, n_mux, bytes_per_step) uint8: K distinct steps of TS for
    every mux, drawn from ``seed``."""
    g = rng(seed, 1)
    return ts_packets(k_steps * n_mux * bytes_per_step, g).reshape(
        k_steps, n_mux, bytes_per_step)


def stream_bytes(pool: np.ndarray, mux: int, start: int,
                 stop: int) -> np.ndarray:
    """Bytes [start, stop) of mux ``mux``'s cycled stream."""
    k, _, n = pool.shape
    if stop <= start:
        return pool[0, mux, :0]
    steps = range(start // n, -(-stop // n))
    flat = np.concatenate([pool[s % k, mux] for s in steps])
    off = steps[0] * n
    return flat[start - off:stop - off]


def carried_windows(pool: np.ndarray, mux: int = 0) -> list:
    """The pre-carried (187 + fresh) windows of mux ``mux``, as
    ``Transmitter.step_window`` takes them: entry 0 for the stream's first
    step (187 zero bytes before it), entry 1 + k for every later step s
    with s % K == k (the carry is the last 187 bytes of the step
    before)."""
    k = pool.shape[0]
    first = np.concatenate([np.zeros(187, np.uint8), pool[0, mux]])
    return [first] + [np.concatenate([pool[(s - 1) % k, mux][-187:],
                                      pool[s, mux]]) for s in range(k)]
