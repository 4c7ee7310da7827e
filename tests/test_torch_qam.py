"""The mapper kernel's host side (``ops/qam.py``) on the CPU.

The kernel (``csrc/qam_map.cu``) runs only on a GPU
(tests/test_torch_cuda.py).  Here its u16 bit-index table is held to the
planner's bit permutation for every named configuration, and its
arithmetic, emulated in NumPy as the kernel does it (the table read as
32-bit words, the packed prefix XOR of each axis, every float32 product
and sum rounded on its own, the Q delay's stores in both layouts, the
interleaved layout a tile of 512 cells at a time), is held bit for bit
to the plain twin at every frame size, modulation and rotation.  Then the
wrapper's CPU contract.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from dvbt2ll_tpu_torch import build_plan, named_config, plan_tensors
from dvbt2ll_tpu_torch import pipeline
from dvbt2ll_tpu_torch.config import (NAMED_CONFIGS, CodeRate,
                                      Constellation, FrameSize, Rotation,
                                      T2Config)
from dvbt2ll_tpu_torch.ops import kernel_wrappers
from dvbt2ll_tpu_torch.ops.qam import qam_map, qam_map_plain, qam_tables
from dvbt2ll_tpu_torch.tables.mapper import bit_permutation

THREADS = 512  # csrc/qam_map.cu's kThreads: the interleaved form's tile
# every frame size x modulation x rotation
_MODES = [(fs, c, r) for fs in (FrameSize.SHORT, FrameSize.NORMAL)
          for c in (Constellation.QPSK, Constellation.QAM16,
                    Constellation.QAM64, Constellation.QAM256)
          for r in (Rotation.OFF, Rotation.ON)]
_IDS = [f"{fs.name}-{c.name}-rot{int(r)}" for fs, c, r in _MODES]


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _plp(frame_size, constellation, rotation):
    """What ``qam_tables`` reads of a ``PlpPlan``: the PLP's config and
    its bit permutation (``plan._build_plp_plan``)."""
    cfg = T2Config(frame_size=frame_size, constellation=constellation,
                   rotation=rotation, code_rate=CodeRate.C2_3, fec_blocks=1,
                   ti_blocks=1)
    return types.SimpleNamespace(cfg=cfg, mapper_perm=bit_permutation(cfg))


def _bits(t, frames, seed=7):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 2, (frames, t.frame_bits), dtype=np.uint8))


def emulate_kernel(t, bits: np.ndarray, planar: bool):
    """csrc/qam_map.cu's arithmetic in NumPy: (F, frame_bits) u8 ->
    (re, im) f32 planes, or (F, cells) complex64."""
    h = t.mod // 2
    words = t.perm16.numpy().view(np.uint32)     # (cells, h): I low, Q high

    def level(shift):
        b = bits[:, (words >> np.uint32(shift)) & np.uint32(0xFFFF)].astype(
            np.uint32)                           # (F, cells, h)
        acc = b[..., 0]
        g = acc
        for j in range(1, h):
            acc = acc ^ b[..., j]
            g = (g << np.uint32(1)) | acc
        return (np.int64((1 << h) - 1) - 2 * g.astype(np.int64)).astype(
            np.float32)

    f32 = np.float32
    xi = level(0) * f32(t.inv_norm)
    xq = level(16) * f32(t.inv_norm)
    rotate = t.rotation
    if rotate:
        c, s = f32(t.cos_t), f32(t.sin_t)
        xi, xq = xi * c - xq * s, xi * s + xq * c
    frames, cells = xi.shape
    if planar:
        re = np.empty_like(xi)
        im = np.empty_like(xq)
        re[:, :] = xi
        im[:, (np.arange(cells) + rotate) % cells] = xq
        return re, im
    out = np.zeros((frames, cells, 2), np.float32)
    if not rotate:
        out[..., 0], out[..., 1] = xi, xq
        return out.view(np.complex64)[..., 0]
    carry = np.zeros(frames, np.float32)         # thread 0's register
    for c0 in range(0, cells, THREADS):
        n = min(THREADS, cells - c0)
        s_q = np.zeros((frames, THREADS), np.float32)
        s_q[:, :n] = xq[:, c0:c0 + n]
        prev = np.concatenate([carry[:, None], s_q[:, :-1]], axis=1)
        carry = s_q[:, -1].copy()
        out[:, c0:c0 + n, 0] = xi[:, c0:c0 + n]
        out[:, c0:c0 + n, 1] = prev[:, :n]
        if c0 + n == cells:                      # the last cell's Q
            out[:, 0, 1] = xq[:, -1]
    return out.view(np.complex64)[..., 0]


@pytest.mark.parametrize("name", NAMED_CONFIGS)
def test_u16_table_is_the_bit_permutation_of_every_named_config(name):
    for c in named_config(name).plp_configs:
        perm = bit_permutation(c)
        t = qam_tables(types.SimpleNamespace(cfg=c, mapper_perm=perm),
                       "cpu")
        assert t.perm16.dtype == torch.uint16
        assert t.perm16.shape == (c.cell_size, c.mod_bits) == t.perm.shape
        got = t.perm16.numpy().astype(np.int64)
        assert got.max() < c.ldpc_frame_bits <= 65536
        np.testing.assert_array_equal(got.reshape(-1), perm)
        assert torch.equal(t.perm, torch.from_numpy(got))


@pytest.mark.parametrize("name", ["vv009_4kshort", "multiplp_fef"])
def test_plan_tensors_carry_each_plps_table(name):
    plan = build_plan(named_config(name), 2, strict=False)
    for pp, pt in zip(plan.plps, plan_tensors(plan, "cpu", True).plps):
        np.testing.assert_array_equal(
            pt.qam.perm16.numpy().astype(np.int64).reshape(-1),
            pp.mapper_perm)
        assert pt.qam.mod == pp.cfg.mod_bits
        assert pt.qam.rotation == bool(pp.cfg.rotation)


@pytest.mark.parametrize("planar", [True, False], ids=["planar", "complex"])
@pytest.mark.parametrize("frame_size,constellation,rotation", _MODES,
                         ids=_IDS)
def test_kernel_emulation_matches_the_twin(frame_size, constellation,
                                           rotation, planar):
    """Three frames, so the Q delay's wrap is seen in more than one row;
    the interleaved form's tile carry and its partial last tile (2025,
    4050, 8100 cells: not multiples of 512) included."""
    t = qam_tables(_plp(frame_size, constellation, rotation), "cpu")
    bits = _bits(t, 3)
    got = emulate_kernel(t, bits.numpy(), planar)
    want = qam_map(t, bits, planar)
    if planar:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())
    else:
        np.testing.assert_array_equal(got, want.numpy())


def test_kernel_wrappers_name_the_mapper():
    assert kernel_wrappers()["qam_map"] is qam_map


def test_wrapper_on_cpu_is_the_twin_and_launches_nothing():
    t = qam_tables(_plp(FrameSize.SHORT, Constellation.QAM256, Rotation.ON),
                   "cpu")
    bits = _bits(t, 4)
    before = qam_map.launches
    re, im = qam_map(t, bits, planar=True)
    cells = qam_map(t, bits, planar=False)
    want = qam_map_plain(t, bits)
    assert torch.equal(re, want[0]) and torch.equal(im, want[1])
    assert cells.dtype == torch.complex64
    assert torch.equal(cells, torch.complex(*want))
    assert qam_map.launches == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    t = qam_tables(_plp(FrameSize.SHORT, Constellation.QAM64, Rotation.OFF),
                   "cpu")
    bits = _bits(t, 2)
    for bad in (bits.to(torch.int32), bits[:, :-8], bits[0]):
        with pytest.raises(ValueError):
            qam_map(t, bad, planar=True)
    # a table built for a CUDA device holds no int64 indices for the twin
    with pytest.raises(ValueError):
        qam_map(dataclasses.replace(t, perm=None), bits, planar=True)


def test_pipeline_maps_through_the_wrapper():
    plan = build_plan(named_config("vv009_4kshort"), 1, strict=False)
    pt = plan_tensors(plan, "cpu", True).plps[0]
    bits = _bits(pt.qam, pt.pp.fec_frames)
    re, im = pipeline.map_cells_planes(pt, bits)
    want = qam_map(pt.qam, bits, planar=True)
    assert torch.equal(re, want[0]) and torch.equal(im, want[1])
    assert torch.equal(pipeline.map_cells(pt, bits), torch.complex(re, im))
