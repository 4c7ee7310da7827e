"""The port's compiled step (``compiled.CompiledStep``, the counterpart of
the JAX ``Transmitter``'s ``jax.jit``) on the CPU, where it runs the step
function on its static inputs with no graph: the frame index as a device
tensor, the staging, the output's ownership and the checkpoints, against
the eager step function bit for bit and against the JAX ``Transmitter``
(FEC bit-exact, IQ above 120 dB, the JAX package's bar between two
formulations of the same float32 math).

Every config here has t2_frames = 2, and each batch is odd, so the step's
first frame index alternates: a step that kept a stale index would read
the other frame's L1-post."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt2ll_tpu import pipeline as jpipe
from dvbt2ll_tpu.config import T2Config as JaxT2Config
from dvbt2ll_tpu.pipeline import Transmitter as JaxTransmitter
from dvbt2ll_tpu_torch import (ShardedTransmitter, Transmitter, make_mesh,
                               named_config, synthetic_ts)
from dvbt2ll_tpu_torch import pipeline as tpipe
from dvbt2ll_tpu_torch.compiled import CompiledStep
from dvbt2ll_tpu_torch.config import T2Config
from dvbt2ll_tpu_torch.pipeline import select_step_iq
from dvbt2ll_tpu_torch.tools import kernel_launches
from tests.torch_compare import snr_db

# a 1K FFT with a guard interval of 64 samples: the complex torch.fft tail
_COMPLEX_1K = dict(frame_size="SHORT", code_rate="C1_2", constellation="QPSK",
                   rotation="OFF", fft_size="FFT_1K", guard_interval="GI_1_16",
                   pilot_pattern="PP4", fec_blocks=1, ti_blocks=1,
                   t2_frames=2, num_data_symbols=8, l1_constellation="BPSK")
_CONFIGS = ["vv009_4kshort", "complex_1k", "multiplp_fef"]
_BATCH = 3
_DRIFT = dict(strict=False, allow_phase_drift=True)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfg(name):
    if name == "complex_1k":
        return T2Config.from_dict(_COMPLEX_1K).validate()
    return named_config(name)


def _tx(name, batch=_BATCH):
    return Transmitter(_cfg(name), batch, device="cpu", **_DRIFT)


def _windows(tx, steps, seed):
    """``steps`` consecutive pre-carried windows, a list a PLP each, with
    each step's first frame index."""
    carries = [np.zeros(187, np.uint8) for _ in tx.plan.plps]
    out, idx = [], 0
    for k in range(steps):
        ws = []
        for i, n in enumerate(tx.bytes_per_step_per_plp):
            w = np.concatenate([carries[i],
                                synthetic_ts(n, seed=seed + 10 * k + i)])
            carries[i] = w[-187:]
            ws.append(w)
        out.append((ws, idx))
        idx = (idx + tx.plan.batch_frames) % tx.cfg.t2_frames
    return out


def _one(ws):
    return ws if len(ws) > 1 else ws[0]


def _eager(tx, ws, idx):
    return tx._step_fn(tx.tensors, _one([torch.from_numpy(w) for w in ws]),
                       idx)


@pytest.mark.parametrize("idx", [0, 1], ids=["first", "last"])
@pytest.mark.parametrize("name", ["vv009_4kshort", "complex_1k"])
def test_tensor_frame_index_equals_the_int(name, idx):
    """``frame_grids`` (planar) and ``build_frames`` (complex) with the
    step's first frame index as a 0-d int64 tensor: bit-identical to the
    int, at 0 and t2_frames - 1."""
    tx = _tx(name)
    assert idx in (0, tx.cfg.t2_frames - 1)
    (ws, _), = _windows(tx, 1, seed=3)
    w = torch.from_numpy(ws[0])
    as_tensor = torch.tensor(idx, dtype=torch.int64)
    if select_step_iq(tx.cfg)[1]:
        for a, b in zip(tpipe.frame_grids(tx.tensors, w, as_tensor),
                        tpipe.frame_grids(tx.tensors, w, idx)):
            assert torch.equal(a, b)
    else:
        cells = tpipe.map_cells(tx.tensors.plps[0], tpipe.bb_and_fec(
            tx.tensors.plps[0], w)).reshape(_BATCH, -1)
        assert torch.equal(tpipe.build_frames(tx.tensors, cells, as_tensor),
                           tpipe.build_frames(tx.tensors, cells, idx))
    assert torch.equal(tpipe.frame_index(tx.tensors, as_tensor),
                       (idx + torch.arange(_BATCH)) % 2)


@pytest.fixture(scope="module", params=_CONFIGS)
def jax_stream(request):
    """t2_frames + 2 steps of windows through the JAX ``Transmitter`` at
    an odd batch in drift mode: the windows, the JAX IQ and FEC bits."""
    name = request.param
    cfg = _cfg(name)
    jtx = JaxTransmitter(JaxT2Config.from_json(cfg.to_json()), _BATCH,
                         use_pallas=False, **_DRIFT)
    steps = _windows(_tx(name), cfg.t2_frames + 2, seed=20)
    iq, fec = [], []
    for ws, _ in steps:
        out = np.asarray(jtx.step_window(_one([jnp.asarray(w) for w in ws])))
        iq.append(out[..., 0] + 1j * out[..., 1])
        fec.append([np.asarray(jpipe.bb_and_fec(pp, jnp.asarray(w)))
                    for pp, w in zip(jtx.plan.plps, ws)])
    return name, steps, iq, fec


def test_compiled_transmitter_matches_eager_and_jax(jax_stream):
    """Each step of the CPU ``Transmitter`` (through ``CompiledStep``)
    bit-identical to the eager step function on the same window and frame
    index, its FEC bits equal to the JAX package's and its IQ above
    120 dB against the JAX ``Transmitter``; the frame counter as JAX's."""
    name, steps, iq, fec = jax_stream
    tx = _tx(name)
    before = kernel_launches()
    for k, (ws, idx) in enumerate(steps):
        assert tx.state_dict()["frame_idx"] == idx
        got = tx.step_window(_one(ws))
        assert torch.equal(got, _eager(tx, ws, idx)), f"step {k}"
        for pt, w, want in zip(tx.tensors.plps, ws, fec[k]):
            assert np.array_equal(
                tpipe.bb_and_fec(pt, torch.from_numpy(w)).numpy(), want)
        g = got.numpy()
        snr = snr_db(iq[k], g[..., 0] + 1j * g[..., 1])
        assert snr > 120, f"step {k}: {snr:.1f} dB"
    assert kernel_launches() == before   # no kernel on the CPU


@pytest.mark.parametrize("name", _CONFIGS)
def test_kept_outputs_equal_a_fresh_eager_run(name):
    """Three consecutive steps' outputs, kept, still equal a fresh
    transmitter's eager step function on the same windows: no later step
    wrote to an earlier step's output, nor to its own input's copy."""
    tx = _tx(name)
    steps = _windows(tx, 3, seed=30)
    kept = [tx.step_window(_one(ws)) for ws, _ in steps]
    fresh = _tx(name)
    for k, ((ws, idx), got) in enumerate(zip(steps, kept)):
        assert torch.equal(got, _eager(fresh, ws, idx)), f"step {k}"
    assert len({t.data_ptr() for t in kept}) == 3


@pytest.mark.parametrize("name", _CONFIGS)
def test_load_state_mid_stream_stages_the_restored_frame_index(name):
    """A checkpoint after an odd number of steps, loaded into a new
    transmitter: its next step stages the restored frame index (1) and
    equals the original transmitter's next step."""
    tx = _tx(name)
    steps = _windows(tx, 2, seed=40)
    tx.step_window(_one(steps[0][0]))
    again = _tx(name)
    again.load_state(tx.state_dict())
    got = again.step_window(_one(steps[1][0]))
    assert int(again._compiled.frame_idx) == steps[1][1] == 1
    assert torch.equal(got, tx.step_window(_one(steps[1][0])))
    assert torch.equal(got, _eager(tx, *steps[1]))


@pytest.mark.parametrize("mux,slots", [(1, 4), (2, 4)])
def test_sharded_cpu_slots_equal_the_sequential_chain(mux, slots):
    """``ShardedTransmitter`` on CPU slots, one ``CompiledStep`` over
    every block of the device: every block over three steps bit-identical
    to a sequential ``Transmitter`` of the same per-call batch, whose
    frame index runs through the shards (odd batch: it alternates)."""
    cfg = named_config("vv009_4kshort")
    n_mux = 2
    stx = ShardedTransmitter(cfg, make_mesh(["cpu"] * slots, mux=mux),
                             n_mux=n_mux, frames_per_shard=_BATCH, **_DRIFT)
    (step,) = stx._steps.values()
    assert step.blocks == n_mux * stx.frame_shards
    seqs = [_tx("vv009_4kshort") for _ in range(n_mux)]
    n = seqs[0].bytes_per_step
    for k in range(3):
        ts = np.stack([synthetic_ts(stx.bytes_per_step_per_mux,
                                    seed=50 + 4 * k + c)
                       for c in range(n_mux)])
        out = stx.step_device(ts)
        for c in range(n_mux):
            for s in range(stx.frame_shards):
                want = seqs[c].step_device(ts[c, s * n:(s + 1) * n])
                assert torch.equal(out[c][s], want), (k, c, s)


def test_compiled_step_on_the_cpu():
    """No graph on the CPU (no capture time, no pool); staging refuses a
    window of another count, length or type, and leaves its inputs as
    staged."""
    tx = _tx("multiplp_fef")
    step = tx._compiled
    assert isinstance(step, CompiledStep) and step._graph is None
    assert step.capture_s == 0 and step.pool_bytes == 0
    (ws, _), = _windows(tx, 1, seed=60)
    rows = [w[None] for w in ws]   # the transmitter's one block
    with pytest.raises(ValueError, match="windows for"):
        step.stage(rows[:1], [0])
    with pytest.raises(ValueError, match="window of shape"):
        step.stage([rows[0][:, 1:], rows[1]], [0])
    with pytest.raises(ValueError, match="window of shape"):
        step.stage(ws, [0])
    with pytest.raises(ValueError, match="frame indices"):
        step.stage(rows, [0, 1])
    with pytest.raises(TypeError):
        step.stage([w.astype(np.int32) for w in rows], [0])
    step.stage(rows, [1])
    assert int(step.frame_idx) == 1 and step.frame_idx.dtype == torch.int64
    for d, w in zip(step.windows, rows):
        assert np.array_equal(d.numpy(), w)
    assert torch.equal(step.replay()[0], _eager(tx, ws, 1))
