"""The seeded TS pools and the paced writer process."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from txbench.tests.conftest import REPO
from txbench.traffic.ts import (carried_windows, stream_bytes, ts_packets,
                                ts_pool)

SEEDS = [0, 7, 2**31 + 11, 2**40 + 3, -5]


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_bytes_and_valid_packets(seed):
    a = ts_pool(seed, 3, 2, 188 * 40)
    b = ts_pool(seed, 3, 2, 188 * 40)
    assert a.shape == (3, 2, 188 * 40) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    pk = a.reshape(-1, 188)
    assert (pk[:, 0] == 0x47).all()
    assert (pk[:, 1] == 0x01).all() and (pk[:, 2] == 0x00).all()
    # the steps of the pool, and the muxes, are distinct
    assert not np.array_equal(a[0, 0], a[1, 0])
    assert not np.array_equal(a[0, 0], a[0, 1])


def test_other_seeds_other_bytes():
    assert not np.array_equal(ts_pool(1, 2, 1, 188 * 10),
                              ts_pool(2, 2, 1, 188 * 10))


def test_ts_packets_matches_the_ports_synthetic_ts():
    """The rewritten generator gives the bytes of ``io.synthetic_ts`` for
    the same integer seed."""
    from dvbt2ll_tpu_torch.io import synthetic_ts
    got = ts_packets(188 * 30, np.random.default_rng(42))
    np.testing.assert_array_equal(got, synthetic_ts(188 * 30, seed=42))
    with pytest.raises(ValueError):
        ts_packets(100, np.random.default_rng(0))


def test_stream_and_windows_cycle_the_pool():
    pool = ts_pool(3, 3, 2, 188 * 4)
    n = pool.shape[2]
    flat = np.concatenate([pool[s % 3, 1] for s in range(7)])
    for a, b in [(0, 5), (n - 10, n + 10), (2 * n, 5 * n + 3), (7, 7)]:
        np.testing.assert_array_equal(stream_bytes(pool, 1, a, b),
                                      flat[a:b])
    w = carried_windows(pool, 1)
    assert len(w) == 4 and all(x.shape == (187 + n,) for x in w)
    assert not w[0][:187].any()
    for s in range(1, 6):
        np.testing.assert_array_equal(w[1 + s % 3],
                                      flat[s * n - 187:(s + 1) * n])


def test_paced_writer_keeps_its_schedule():
    """The writer, as its own process, writes the pool's stream: the burst
    at once, then each step's last byte at its due time, and reports the
    due times and how late it ran."""
    n, k, step = 188 * 200, 3, 0.05
    rfd, wfd = os.pipe()
    p = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "txbench", "traffic",
                                      "paced_writer.py"),
         "--fd", str(wfd), "--seed", "99", "--k", str(k),
         "--bytes-per-step", str(n), "--step-seconds", str(step),
         "--burst", "2", "--steps", "4", "--chunks", "4"],
        pass_fds=(wfd,), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True)
    os.close(wfd)
    try:
        got = b""
        while len(got) < 2 * n:
            got += os.read(rfd, 1 << 16)
        t0 = time.monotonic() + 0.02
        p.stdin.write(f"{t0!r}\n")
        p.stdin.close()
        p.stdin = None
        while True:
            chunk = os.read(rfd, 1 << 16)
            if not chunk:
                break
            got += chunk
        out, _ = p.communicate(timeout=30)
    finally:
        os.close(rfd)
        if p.poll() is None:
            p.kill()
            p.wait()
    pool = ts_pool(99, k, 1, n)
    np.testing.assert_array_equal(np.frombuffer(got, np.uint8),
                                  stream_bytes(pool, 0, 0, 6 * n))
    rep = json.loads(out.strip().splitlines()[-1])
    assert rep["steps"] == 4
    np.testing.assert_allclose(rep["due"], [t0 + (i + 1) * step
                                            for i in range(4)])
    assert all(w >= d for w, d in zip(rep["written"], rep["due"]))
    assert rep["late_max_ms"] >= 0
