"""The port's QC-LDPC parity against the JAX package and the numpy oracle.

``qc_ldpc_parity_plain`` (the parity of the CUDA kernel's torch twin) must
equal the JAX package's Pallas kernel, run in interpret mode as its own
tests run it on the CPU, bit for bit: on the vv009 table (single-block
kernel) and on a normal-frame table at a frame count that takes the
row-grouped kernel.  The codeword twin ``ldpc_codeword_plain`` must equal
the JAX step's info bits with the Pallas parity after them
(``dvbt2ll_tpu/pipeline.py:233``).  On every Annex-A table both must
equal the scatter oracle ``tables/ldpc.encode_ref``.  The kernel itself
runs only on a GPU (tests/test_torch_cuda.py); here the wrapper's CPU
contract and the build plumbing are checked.
"""
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt2ll_tpu.config import CodeRate, FrameSize, T2Config, vv009_config
from dvbt2ll_tpu.ops.ldpc_pallas import _tile_for, qc_ldpc_parity_pallas
from dvbt2ll_tpu.tables import ldpc
from dvbt2ll_tpu_torch.ops import _build
from dvbt2ll_tpu_torch.ops.ldpc import (ldpc_codeword, ldpc_codeword_plain,
                                        ldpc_schedule, qc_ldpc_parity_plain)

_TABLES = [(fs, r) for fs in (FrameSize.SHORT, FrameSize.NORMAL)
           for r in (CodeRate.C1_3, CodeRate.C2_5, CodeRate.C1_2,
                     CodeRate.C3_5, CodeRate.C2_3, CodeRate.C3_4,
                     CodeRate.C4_5, CodeRate.C5_6)
           if not (fs == FrameSize.NORMAL
                   and r in (CodeRate.C1_3, CodeRate.C2_5))]


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _table(frame_size, rate):
    cfg = T2Config(frame_size=frame_size, code_rate=rate, fec_blocks=1,
                   ti_blocks=1)
    cols = ldpc.qc_entries(frame_size, rate, cfg.q_ldpc)
    return cfg.nbch, cfg.ldpc_parity_bits, cfg.q_ldpc, cols


def test_plain_matches_pallas_vv009():
    cfg = vv009_config()
    cols = ldpc.qc_entries(cfg.frame_size, cfg.code_rate, cfg.q_ldpc)
    nb = np.random.default_rng(7).integers(0, 2, (16, cfg.nbch),
                                           dtype=np.uint8)
    want = np.asarray(qc_ldpc_parity_pallas(
        cols, cfg.nbch, cfg.ldpc_parity_bits, cfg.q_ldpc, jnp.asarray(nb),
        interpret=True))
    sched = ldpc_schedule(cols, cfg.nbch, cfg.ldpc_parity_bits, cfg.q_ldpc,
                          "cpu")
    got = qc_ldpc_parity_plain(sched, torch.from_numpy(nb)).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_matches_pallas_grouped_normal_frames():
    """8k_normal's table (rate 2/3): at 132 frames the Pallas wrapper
    takes its row-grouped kernel, which the one CUDA kernel replaces."""
    nbch, plen, q, cols = _table(FrameSize.NORMAL, CodeRate.C2_3)
    f = 132
    assert _tile_for(nbch, plen, f)[1] < nbch  # grouped
    nb = np.random.default_rng(11).integers(0, 2, (f, nbch), dtype=np.uint8)
    want = np.asarray(qc_ldpc_parity_pallas(cols, nbch, plen, q,
                                            jnp.asarray(nb), interpret=True))
    got = qc_ldpc_parity_plain(ldpc_schedule(cols, nbch, plen, q, "cpu"),
                               torch.from_numpy(nb)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frame_size,rate", _TABLES,
                         ids=[f"{fs.name}-{r.name}" for fs, r in _TABLES])
def test_plain_matches_oracle_every_table(frame_size, rate):
    nbch, plen, q, cols = _table(frame_size, rate)
    nb = np.random.default_rng(3).integers(0, 2, (2, nbch), dtype=np.uint8)
    got = qc_ldpc_parity_plain(ldpc_schedule(cols, nbch, plen, q, "cpu"),
                               torch.from_numpy(nb)).numpy()
    for i in range(2):
        ref = ldpc.encode_ref(nb[i], frame_size, rate, plen, q)
        np.testing.assert_array_equal(got[i], ref)


@pytest.mark.parametrize("frame_size,rate", _TABLES,
                         ids=[f"{fs.name}-{r.name}" for fs, r in _TABLES])
def test_codeword_matches_oracle_every_table(frame_size, rate):
    """The whole codeword: the info bits unchanged, then the oracle's
    parity."""
    nbch, plen, q, cols = _table(frame_size, rate)
    nb = np.random.default_rng(4).integers(0, 2, (2, nbch), dtype=np.uint8)
    got = ldpc_codeword_plain(ldpc_schedule(cols, nbch, plen, q, "cpu"),
                              torch.from_numpy(nb)).numpy()
    assert got.shape == (2, nbch + plen) and got.dtype == np.uint8
    for i in range(2):
        np.testing.assert_array_equal(got[i, :nbch], nb[i])
        np.testing.assert_array_equal(
            got[i, nbch:], ldpc.encode_ref(nb[i], frame_size, rate, plen, q))


def test_codeword_matches_jax_info_and_pallas_parity():
    cfg = vv009_config()
    cols = ldpc.qc_entries(cfg.frame_size, cfg.code_rate, cfg.q_ldpc)
    nb = np.random.default_rng(8).integers(0, 2, (5, cfg.nbch),
                                           dtype=np.uint8)
    par = np.asarray(qc_ldpc_parity_pallas(
        cols, cfg.nbch, cfg.ldpc_parity_bits, cfg.q_ldpc, jnp.asarray(nb),
        interpret=True))
    want = np.asarray(jnp.concatenate([jnp.asarray(nb), par], axis=1))
    got = ldpc_codeword(ldpc_schedule(cols, cfg.nbch, cfg.ldpc_parity_bits,
                                      cfg.q_ldpc, "cpu"),
                        torch.from_numpy(nb)).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_on_cpu_takes_the_twin_and_checks_input():
    cfg = vv009_config()
    cols = ldpc.qc_entries(cfg.frame_size, cfg.code_rate, cfg.q_ldpc)
    sched = ldpc_schedule(cols, cfg.nbch, cfg.ldpc_parity_bits, cfg.q_ldpc,
                          "cpu")
    bits = torch.from_numpy(np.random.default_rng(5).integers(
        0, 2, (3, cfg.nbch), dtype=np.uint8))
    before = ldpc_codeword.launches
    assert torch.equal(ldpc_codeword(sched, bits),
                       ldpc_codeword_plain(sched, bits))
    assert ldpc_codeword.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        ldpc_codeword(sched, bits.to(torch.int32))
    with pytest.raises(ValueError):
        ldpc_codeword(sched, bits[:, :-360])
    with pytest.raises(ValueError):
        ldpc_schedule(cols, cfg.nbch, cfg.ldpc_parity_bits, cfg.q_ldpc + 1,
                      "cpu")
    assert ldpc_codeword(sched, bits[:0]).shape == (0, cfg.ldpc_frame_bits)


def _fake_nvcc(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_build_caches_by_source_hash(tmp_path, monkeypatch):
    """The library is built once per hash of the sources and flags, into
    ``_build/<key>/``; a build whose key exists is not run again."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    log = tmp_path / "calls"
    # the fake compiler writes its -o argument and logs each call
    nvcc = _fake_nvcc(tmp_path / "nvcc", (
        f'echo call >> {log}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo lib > "$2"\n'))
    path = _build.build(nvcc)
    assert path == os.path.join(str(tmp_path / "build"), _build.build_key(),
                                _build.LIB_NAME)
    assert os.path.exists(path)
    # one compile per source, then one link
    calls = log.read_text().count("call")
    assert calls == len(_build._sources()) + 1
    assert _build.build(nvcc) == path
    assert log.read_text().count("call") == calls
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    nvcc = _fake_nvcc(tmp_path / "nvcc",
                      'echo "error: bad kernel" >&2\nexit 2\n')
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build(nvcc)
