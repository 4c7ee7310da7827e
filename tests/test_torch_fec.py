"""The BB/BCH kernel's host side (``ops/fec.py``) on the CPU.

The kernel (``csrc/bb_bch.cu``) runs only on a GPU
(tests/test_torch_cuda.py).  Here its tables and its arithmetic are held
to the planner's oracles by a NumPy emulation of the kernel's walks: the
BCH byte tables against ``tables/bch.parity_matrix`` and the bit-serial
``encode_ref`` for the three generator polynomials the configs use (short
t = 12, normal t = 10 and t = 12) at every kbch; the CRC-8 tables, four
bytes a step, against ``packet_crc_matrix``; and the kernel's whole index
map (frame spans, sync slots, HIEFF, in-band, scrambling) against the
plain twin in every BB mode.  Then the wrapper's CPU contract.
"""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from dvbt2ll_tpu_torch import Transmitter, build_plan, named_config
from dvbt2ll_tpu_torch.config import _FEC_NORMAL, _FEC_SHORT
from dvbt2ll_tpu_torch.ops import kernel_wrappers
from dvbt2ll_tpu_torch.ops.fec import (bb_bch, bb_bch_plain, bb_bch_tables,
                                       bch_step_tables, crc8_tables)
from dvbt2ll_tpu_torch.pipeline import bb_and_fec
from dvbt2ll_tpu_torch.tables.bbframe import (_crc8_byte_table,
                                              packet_crc_matrix)
from dvbt2ll_tpu_torch.tables.bch import encode_ref, parity_matrix

# (short, kbch, nbch, t) of every code rate
_CODES = ([(True, k, n, t) for k, n, _, t in _FEC_SHORT.values()]
          + [(False, k, n, t) for k, n, _, t in _FEC_NORMAL.values()])


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def walk_bch(msg: np.ndarray, tab: np.ndarray, npar: int) -> np.ndarray:
    """The kernel's BCH walk in NumPy: (N, kbch / 8) u8 message bytes ->
    (N, npar) u8 parity bits in transmit order.  Leading zero bytes make
    whole 32-bit words; each word shifts the six-word register up one
    word and XORs four byte-table entries."""
    n, kb = msg.shape
    m = np.concatenate([np.zeros((n, -kb % 4), np.uint8), msg], axis=1)
    w = m.reshape(n, -1, 4).astype(np.uint32)
    words = w[..., 0] << 24 | w[..., 1] << 16 | w[..., 2] << 8 | w[..., 3]
    entries = tab.transpose(0, 2, 1, 3).reshape(4, 256, 6)  # [q, b, word]
    r = np.zeros((n, 6), np.uint32)
    for j in range(words.shape[1]):
        v = r[:, 5] ^ words[:, j]
        r = np.concatenate([np.zeros((n, 1), np.uint32), r[:, :5]], axis=1)
        for q in range(4):
            r ^= entries[q, (v >> np.uint32(8 * q)) & np.uint32(255)]
    out = np.stack([(r[:, 5 - i // 4] >> np.uint32(24 - 8 * (i % 4)))
                    & np.uint32(0xFF) for i in range(npar // 8)], axis=1)
    return np.unpackbits(out.astype(np.uint8), axis=1)


def walk_crc(packets: np.ndarray) -> np.ndarray:
    """The kernel's CRC-8 walk, four bytes a step, then the last three
    one at a time: (N, 187) u8 -> (N,) u8."""
    t = crc8_tables()
    crc = np.zeros(packets.shape[0], np.uint8)
    k = 0
    for k in range(0, packets.shape[1] - 3, 4):
        b = packets[:, k:k + 4]
        crc = (t[3][crc ^ b[:, 0]] ^ t[2][b[:, 1]] ^ t[1][b[:, 2]]
               ^ t[0][b[:, 3]])
        k += 4
    for k in range(k, packets.shape[1]):
        crc = t[0][crc ^ packets[:, k]]
    return crc


@pytest.mark.parametrize("short,kbch,nbch,t", _CODES,
                         ids=[f"{'short' if c[0] else 'normal'}-{c[1]}"
                              for c in _CODES])
def test_bch_walk_matches_parity_matrix_and_encoder(short, kbch, nbch, t):
    npar = nbch - kbch
    assert npar == (14 if short else 16) * t
    rng = np.random.default_rng(kbch)
    msg = rng.integers(0, 256, (3, kbch // 8), dtype=np.uint8)
    msg[2] = 0
    msg[2, -1] = 1                      # a single bit: the last row
    got = walk_bch(msg, bch_step_tables(short, t), npar)
    bits = np.unpackbits(msg, axis=1)
    want = (bits.astype(np.int64) @ parity_matrix(kbch, short, t)) % 2
    np.testing.assert_array_equal(got, want.astype(np.uint8))
    np.testing.assert_array_equal(got[0], encode_ref(bits[0], short, t))


def test_bch_tables_are_left_aligned():
    """Every entry's low 192 - npar bits are zero, so the register's
    shifts never carry a stray bit into the parity."""
    for short, t, npar in ((True, 12, 168), (False, 10, 160),
                           (False, 12, 192)):
        tab = bch_step_tables(short, t)
        assert tab.shape == (4, 3, 256, 2) and tab.dtype == np.uint32
        low = tab.transpose(0, 2, 1, 3).reshape(4, 256, 6)[..., 0]
        assert not (low & np.uint32((1 << (192 - npar)) - 1)).any()
        assert not tab[:, :, 0].any()   # byte 0 adds nothing


def test_crc_walk_matches_packet_crc_matrix():
    """The four-byte walk against the GF(2) matrix and against the
    byte-serial reference walk (``crc' = tab[crc ^ b]``)."""
    pk = np.random.default_rng(5).integers(0, 256, (64, 187),
                                           dtype=np.uint8)
    pk[0] = 0
    pk[1, 100] = 0x47
    want = np.packbits((np.unpackbits(pk, axis=1).astype(np.int64)
                        @ packet_crc_matrix()) % 2, axis=1)[:, 0]
    np.testing.assert_array_equal(walk_crc(pk), want)
    tab = _crc8_byte_table()
    serial = np.zeros(64, np.uint8)
    for k in range(187):
        serial = tab[serial ^ pk[:, k]]
    np.testing.assert_array_equal(serial, want)


def emulate_kernel(t, ts: np.ndarray, addr: int = 0) -> np.ndarray:
    """The kernel's index map and walks in NumPy, step for step of
    ``csrc/bb_bch.cu``: (blocks, window) u8 -> (blocks * F, nbch) u8.
    ``addr`` is the windows' device address mod 16, which sets where the
    16-byte lines of a frame's data field start."""
    kb = t.kbch // 8
    d = kb - 10
    group = t.fec_blocks if t.inband else 0
    headers = t.headers_b.numpy()
    scramble = t.scramble_b.numpy()
    inband = None if t.inband_b is None else t.inband_b.numpy()
    blocks, window = ts.shape
    flat = np.concatenate([np.zeros(addr, np.uint8), ts.reshape(-1),
                           np.zeros(32, np.uint8)])   # device memory

    def span(loc):
        if group == 0:
            return loc * d, d
        g, m = divmod(loc, group)
        return loc * d - 13 * g - (13 if m else 0), (d if m else d - 13)

    def window_index(j):
        return 187 + (j // 187 * 188 + 1 + j % 187 if t.hieff else j)

    msg = np.zeros((blocks * t.frames, kb), np.uint8)
    for fi in range(blocks * t.frames):
        blk, loc = divmod(fi, t.frames)
        s, ln = span(loc)
        row = addr + blk * window
        lo = (row + window_index(s)) & ~15
        hi = (row + window_index(s + ln - 1) + 16) & ~15
        for line in range(lo, hi, 16):      # phase 1: scatter each line
            for i in range(16):
                j = line + i - row - 187
                if t.hieff:
                    j = -1 if j < 0 or j % 188 == 0 else (
                        j // 188 * 187 + j % 188 - 1)
                if s <= j < s + ln:
                    msg[fi, 10 + j - s] = flat[line + i] ^ scramble[10 + j - s]
        msg[fi, :10] = headers[loc] ^ scramble[:10]
        if ln < d:
            msg[fi, 10 + ln:] = inband ^ scramble[10 + ln:]
        if not t.hieff and t.packets > 0:   # phase 2: the sync slots
            o = t.sync_offset
            i0 = 0 if s <= o else (s - o + 187) // 188
            for i in range(i0, i0 + (d + 187) // 188):
                j = o + 188 * i
                if i >= t.packets or j >= s + ln:
                    continue
                crc = walk_crc(ts[blk, None, j:j + 187])[0]
                msg[fi, 10 + j - s] = crc ^ scramble[10 + j - s]
    steps = t.bch_steps.numpy().view(np.uint32).reshape(4, 3, 256, 2)
    par = walk_bch(msg, steps, t.nbch - t.kbch)
    return np.concatenate([np.unpackbits(msg, axis=1), par], axis=1)


def _case_plan(case_id, steps_in=0):
    """A MATRIX case's plan at its test batch, at the TS phase its
    streaming run reaches after ``steps_in`` steps."""
    case = {c["id"]: c for c in chip_smoke.MATRIX}[case_id]
    cfg = chip_smoke.matrix_config(case)
    phase = 0
    for _ in range(steps_in):
        phase = build_plan(cfg, case["batch"], strict=False,
                           start_phases=phase).plps[0].bb.next_phase
    return build_plan(cfg, case["batch"], strict=False, start_phases=phase)


# id: (plan, (HIEFF, in-band)), each case a branch of the BB map
_MODES = {
    "normal_offset0": (lambda: build_plan(named_config("vv009_4kshort"), 1,
                                          strict=False), (False, False)),
    "normal_nonzero_offset": (lambda: _case_plan("normal_drift", 1),
                              (False, False)),
    "hieff": (lambda: _case_plan("hieff"), (True, False)),
    "inband": (lambda: _case_plan("inband"), (False, True)),
    "inband_nonzero_offset": (lambda: _case_plan("inband_stream", 1),
                              (False, True)),
    "inband_hieff": (lambda: _case_plan("inband_hieff"), (True, True)),
    "normal_frames": (lambda: build_plan(named_config("8k_normal"), 1,
                                         strict=False), (False, False)),
}


def _windows(t, blocks, seed, corrupt):
    """``blocks`` random windows with valid sync bytes at every packet
    start (or, with ``corrupt``, random ones)."""
    rng = np.random.default_rng(seed)
    ts = rng.integers(0, 256, (blocks, 187 + t.fresh), dtype=np.uint8)
    if not corrupt:
        if t.hieff:
            ts[:, 187::188] = 0x47
        else:
            ts[:, 187 + t.sync_offset::188] = 0x47
    return ts


@pytest.mark.parametrize("mode", list(_MODES))
def test_kernel_emulation_matches_twin(mode):
    """Every BB mode, 2 blocks, valid and corrupted sync bytes; and the
    window with no sync slot (``packets`` 0), built by hand; the windows
    at three alignments."""
    make, flags = _MODES[mode]
    t = bb_bch_tables(make().plps[0], "cpu")
    assert (t.hieff, t.inband) == flags
    assert (t.sync_offset != 0) == mode.endswith("nonzero_offset")
    cases = [(t, False), (t, True)]
    if not t.hieff:
        cases.append((dataclasses.replace(t, packets=0), False))
    for k, (tt, corrupt) in enumerate(cases):
        ts = _windows(tt, 2, seed=k, corrupt=corrupt)
        want = bb_bch_plain(tt, torch.from_numpy(ts)).numpy()
        np.testing.assert_array_equal(emulate_kernel(tt, ts, 5 * k), want)


def test_wrapper_on_cpu_takes_the_twin_and_checks_input():
    tx = Transmitter(named_config("vv009_4kshort"), 2, strict=False,
                     device="cpu")
    t = tx.tensors.plps[0].fec
    assert kernel_wrappers()["bb_bch"] is bb_bch
    ts = torch.from_numpy(_windows(t, 3, seed=9, corrupt=False))
    before = bb_bch.launches
    got = bb_bch(t, ts)
    assert bb_bch.launches == before            # the twin, no kernel
    assert got.shape == (3 * t.frames, t.nbch) and got.dtype == torch.uint8
    assert torch.equal(got, bb_bch_plain(t, ts))
    full = bb_and_fec(tx.tensors.plps[0], ts)
    assert torch.equal(full[:, :t.nbch], got)
    for bad in (ts.to(torch.int16), ts[0], ts[:, 1:],
                torch.cat([ts, ts[:, :1]], dim=1), ts[None]):
        with pytest.raises(ValueError):
            bb_bch(t, bad)
    assert bb_bch.launches == before


def test_twin_matrices_only_on_the_cpu():
    """The GF(2) matrices are the twin's: a plan's tables hold them on a
    CPU device only; every device holds the kernel's few-KB tables, the
    uploaded BCH steps equal to ``bch_step_tables``."""
    pp = build_plan(named_config("vv009_4kshort"), 1, strict=False).plps[0]
    t = bb_bch_tables(pp, "cpu")
    assert t.crc_matrix.shape == (187 * 8, 8)
    assert t.bch_matrix.shape == (t.kbch, t.nbch - t.kbch)
    np.testing.assert_array_equal(
        t.bch_steps.numpy().view(np.uint32).reshape(4, 3, 256, 2),
        bch_step_tables(True, 12))
    np.testing.assert_array_equal(t.crc_tables.numpy().reshape(4, 256),
                                  crc8_tables())
    off = bb_bch_tables(pp, "meta")
    assert off.crc_matrix is None and off.bch_matrix is None
    assert off.crc_tables.shape == (1024,)
    assert off.bch_steps.shape == (6144,)
    with pytest.raises(ValueError, match="CPU device"):
        bb_bch_plain(off, torch.zeros((1, 187 + t.fresh), dtype=torch.uint8))
