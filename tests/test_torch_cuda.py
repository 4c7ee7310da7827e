"""The port's CUDA kernel on the GPU: it runs only where a CUDA device
and nvcc exist, and skips elsewhere.  It imports no JAX, so it runs on a
machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up JAX.)
"""
import numpy as np
import pytest
import torch

from dvbt2ll_tpu_torch import Transmitter, named_config, synthetic_ts
from dvbt2ll_tpu_torch._host.config import CodeRate, FrameSize, T2Config
from dvbt2ll_tpu_torch._host.tables.ldpc import qc_entries
from dvbt2ll_tpu_torch.ops import ifft
from dvbt2ll_tpu_torch.ops.ldpc import (ldpc_schedule, qc_ldpc_parity,
                                        qc_ldpc_parity_plain)
from dvbt2ll_tpu_torch.pipeline import bb_and_fec

pytestmark = pytest.mark.cuda

_TABLES = [(fs, r) for fs in (FrameSize.SHORT, FrameSize.NORMAL)
           for r in (CodeRate.C1_3, CodeRate.C2_5, CodeRate.C1_2,
                     CodeRate.C3_5, CodeRate.C2_3, CodeRate.C3_4,
                     CodeRate.C4_5, CodeRate.C5_6)
           if not (fs == FrameSize.NORMAL
                   and r in (CodeRate.C1_3, CodeRate.C2_5))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")
    return torch.device("cuda")


@pytest.mark.parametrize("frame_size,rate", _TABLES,
                         ids=[f"{fs.name}-{r.name}" for fs, r in _TABLES])
def test_kernel_matches_plain_every_table(cuda, frame_size, rate):
    cfg = T2Config(frame_size=frame_size, code_rate=rate, fec_blocks=1,
                   ti_blocks=1)
    sched = ldpc_schedule(qc_entries(frame_size, rate, cfg.q_ldpc),
                          cfg.nbch, cfg.ldpc_parity_bits, cfg.q_ldpc, cuda)
    bits = torch.from_numpy(np.random.default_rng(3).integers(
        0, 2, (67, cfg.nbch), dtype=np.uint8)).to(cuda)
    before = qc_ldpc_parity.launches
    got = qc_ldpc_parity(sched, bits)
    assert qc_ldpc_parity.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, qc_ldpc_parity_plain(sched, bits))


def test_kernel_refuses_what_it_does_not_take(cuda):
    cfg = named_config("vv009_4kshort")
    cols = qc_entries(cfg.frame_size, cfg.code_rate, cfg.q_ldpc)
    sched = ldpc_schedule(cols, cfg.nbch, cfg.ldpc_parity_bits, cfg.q_ldpc,
                          cuda)
    bits = torch.zeros((4, 2 * cfg.nbch), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        qc_ldpc_parity(sched, bits[:, ::2])
    on_cpu = ldpc_schedule(cols, cfg.nbch, cfg.ldpc_parity_bits,
                           cfg.q_ldpc, "cpu")
    with pytest.raises(ValueError, match="schedule"):
        qc_ldpc_parity(on_cpu, bits[:, :cfg.nbch].contiguous())


def test_tail_refuses_tf32(cuda):
    g = torch.zeros((1, 1, 32, 128), device=cuda)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            ifft.ifft_gi_einsum(g, g, 4096, 128, 1.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("name", ["vv009_4kshort", "8k_normal"])
def test_transmitter_on_card_matches_cpu(cuda, name):
    cfg = named_config(name)
    tx = Transmitter(cfg, 2, strict=False, device=cuda)
    ref = Transmitter(cfg, 2, strict=False, device="cpu")
    ts = synthetic_ts(tx.bytes_per_step, seed=5)
    w = torch.from_numpy(np.concatenate([np.zeros(187, np.uint8), ts]))
    assert torch.equal(bb_and_fec(tx.tensors.plps[0], w.to(cuda)).cpu(),
                       bb_and_fec(ref.tensors.plps[0], w))
    before = qc_ldpc_parity.launches
    got = tx(ts)
    assert qc_ldpc_parity.launches == before + 1
    want = ref(ts)
    err = np.sum(np.abs(got.astype(np.complex128) - want) ** 2)
    assert err == 0 or 10 * np.log10(np.sum(np.abs(want) ** 2) / err) > 120
