"""The port's compiled mesh step on the CPU: ``compiled.CompiledStep`` over
k blocks of one device (the counterpart of the JAX package's
``jax.jit(_shard_map(shard_fn))`` on one card), the ``ShardedTransmitter``
that runs one such step a device, and the compiled
``grids_symbol_sharded`` (the counterpart of its ``jax.jit(fn)``).  On the
CPU each runs the eager step function on its static inputs, so these
tests hold the staging, the block indexing, the frame indices and the
outputs' ownership: bit for bit against the eager step and the sequential
chain, and one block against the JAX ``Transmitter`` above 120 dB (the
JAX package's bar between two formulations of the same float32 math).

vv009 and multiplp_fef have t2_frames = 2; at an odd batch on one frame
shard the step's first frame index alternates, and on two shards the
second shard's index is odd."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dvbt2ll_tpu.config import T2Config as JaxT2Config
from dvbt2ll_tpu.parallel import halo_windows as jax_halo_windows
from dvbt2ll_tpu.pipeline import Transmitter as JaxTransmitter
from dvbt2ll_tpu_torch import (ShardedTransmitter, Transmitter, build_plan,
                               grids_symbol_sharded, halo_windows, make_mesh,
                               named_config, plan_tensors, synthetic_ts,
                               transmit_step_iq, vv009_config)
from dvbt2ll_tpu_torch.compiled import CompiledStep
from dvbt2ll_tpu_torch.parallel.sharding import _write_window
from tests.torch_compare import snr_db

_BATCH = 3
_DRIFT = dict(strict=False, allow_phase_drift=True)


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rows(tx, k, seed):
    """k independent pre-carried windows a PLP, stacked: one (k, 187 +
    fresh bytes) uint8 array a PLP."""
    return [np.stack([np.concatenate([
        synthetic_ts(187, seed=seed + 100 * i + p),
        synthetic_ts(n, seed=seed + 100 * i + p + 50)]) for i in range(k)])
        for p, n in enumerate(tx.bytes_per_step_per_plp)]


def _eager(tx, ws, idx):
    ws = [torch.from_numpy(np.ascontiguousarray(w)) for w in ws]
    return tx._step_fn(tx.tensors, ws if len(ws) > 1 else ws[0], idx)


@pytest.fixture(scope="module")
def vv009_jax_block():
    """One vv009 window at the odd batch through the JAX ``Transmitter``
    at frame index 0, and its IQ."""
    tx = Transmitter(vv009_config(), _BATCH, device="cpu", **_DRIFT)
    window = _rows(tx, 1, seed=5)[0][0]
    jtx = JaxTransmitter(JaxT2Config.from_json(tx.cfg.to_json()), _BATCH,
                         use_pallas=False, **_DRIFT)
    out = np.asarray(jtx.step_window(jnp.asarray(window)))
    return window, out[..., 0] + 1j * out[..., 1]


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("name", ["vv009_4kshort", "multiplp_fef"])
def test_k_blocks_equal_k_eager_calls(name, k, vv009_jax_block):
    """``CompiledStep`` over k blocks: block i of a replay bit-identical to
    the eager step function on window row i and frame index i (0 and 1
    in turn), for two steps, each returning one stacked tensor; the
    first step's block 0 is the JAX ``Transmitter``'s vv009 window, held
    above 120 dB."""
    tx = Transmitter(named_config(name), _BATCH, device="cpu", **_DRIFT)
    step = CompiledStep(tx._step_fn, tx.tensors, tx.plan, "cpu", k)
    assert step.blocks == k and step.frame_idx.shape == (k,)
    for n, w in zip(tx.bytes_per_step_per_plp, step.windows):
        assert w.shape == (k, 187 + n)
    for s in range(2):
        rows = _rows(tx, k, seed=10 + 1000 * s)
        if s == 0 and name == "vv009_4kshort":
            rows[0][0] = vv009_jax_block[0]
        idx = [(i + s) % 2 for i in range(k)]
        out = step(rows, idx)
        assert out.shape == (k, _BATCH, tx.cfg.samples_per_frame, 2)
        for i in range(k):
            want = _eager(tx, [r[i] for r in rows], idx[i])
            assert torch.equal(out[i], want), (s, i)
        if s == 0 and name == "vv009_4kshort":
            g = out[0].numpy()
            snr = snr_db(vv009_jax_block[1], g[..., 0] + 1j * g[..., 1])
            assert snr > 120, f"{snr:.1f} dB"


@pytest.mark.parametrize("per", [100, 187, 500])
def test_windows_written_in_place_equal_the_jax_halo_windows(per):
    """``_write_window``, the in-place row a ``ShardedTransmitter`` writes
    into its pinned staging (and ``halo_windows``' body), equal to the
    JAX package's ``halo_windows`` for every shard, with shards shorter
    than the carry among them."""
    rng = np.random.default_rng(per)
    ts = rng.integers(0, 256, (2, 4 * per), dtype=np.uint8)
    carries = rng.integers(0, 256, (2, 187), dtype=np.uint8)
    want = jax_halo_windows(ts, carries, 4)
    got = np.zeros_like(want)
    for c in range(2):
        for f in range(4):
            _write_window(got[c, f], carries[c], ts[c], f * per)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(halo_windows(ts, carries, 4), want)


_MESHES = [(1, 1), (2, 2), (8, 2)]


@pytest.mark.parametrize("mux,frame", _MESHES,
                         ids=[f"{m}x{f}" for m, f in _MESHES])
def test_sharded_equals_the_sequential_chain(mux, frame):
    """A (mux, frame) mesh of CPU slots, one ``CompiledStep`` over all its
    blocks, t2_frames + 1 steps at an odd batch: the gathered output and
    every block bit-identical to a sequential ``Transmitter`` a mux at the
    same per-call batch, whose frame index runs through the shards."""
    cfg = vv009_config()
    stx = ShardedTransmitter(cfg, make_mesh(["cpu"] * (mux * frame),
                                            mux=mux),
                             n_mux=mux, frames_per_shard=_BATCH, **_DRIFT)
    (step,) = stx._steps.values()
    assert step.blocks == mux * frame
    seqs = [Transmitter(cfg, _BATCH, device="cpu", **_DRIFT)
            for _ in range(mux)]
    n = seqs[0].bytes_per_step
    for k in range(cfg.t2_frames + 1):
        ts = np.stack([synthetic_ts(stx.bytes_per_step_per_mux,
                                    seed=50 + 16 * k + c)
                       for c in range(mux)])
        got = stx(ts)
        assert got.shape == (mux, stx.frames_per_step,
                             cfg.samples_per_frame)
        for c in range(mux):
            want = np.concatenate([seqs[c](ts[c, s * n:(s + 1) * n])
                                   for s in range(frame)])
            assert np.array_equal(got[c], want), (k, c)


def test_sharded_multi_plp_fef_stream():
    """multiplp_fef (two PLPs, FEF parts) over a (2, 2) mesh, t2_frames +
    1 steps of ``stream``: each mux's emitted stream, FEF parts included,
    bit-identical to a sequential ``Transmitter``'s ``stream``."""
    cfg = named_config("multiplp_fef")
    stx = ShardedTransmitter(cfg, make_mesh(["cpu"] * 4, mux=2), n_mux=2,
                             frames_per_shard=1, **_DRIFT)
    seqs = [Transmitter(cfg, 1, device="cpu", **_DRIFT) for _ in range(2)]
    per = seqs[0].bytes_per_step_per_plp
    for k in range(cfg.t2_frames + 1):
        ts = [np.stack([synthetic_ts(n, seed=70 + 10 * k + 2 * c + p)
                        for c in range(2)])
              for p, n in enumerate(stx.bytes_per_step_per_mux_per_plp)]
        got = stx.stream(ts)
        for c in range(2):
            want = np.concatenate([seqs[c].stream(
                [ts[p][c, s * per[p]:(s + 1) * per[p]] for p in range(2)])
                for s in range(2)])
            assert np.array_equal(got[c], want), (k, c)


def _eager_blocks(stx, ts, carries, step_no):
    """Each block of one ``step_device`` by the eager step function on
    its halo window and frame index, computed apart."""
    windows = halo_windows(ts, carries, stx.frame_shards)
    base = (step_no % stx.cfg.t2_frames) * stx.frames_per_step
    return [[stx._step_fn(stx.tensors[torch.device("cpu")],
                          torch.from_numpy(windows[c, s]),
                          (base + s * stx.plan.batch_frames)
                          % stx.cfg.t2_frames)
             for s in range(stx.frame_shards)] for c in range(stx.n_mux)]


def test_kept_outputs_equal_a_fresh_eager_run():
    """Blocks kept from step n, read after step n + 1, equal the eager
    step on their windows: no replay wrote into an earlier step's output;
    the blocks of a step are views of one stacked tensor."""
    cfg = vv009_config()
    stx = ShardedTransmitter(cfg, make_mesh(["cpu"] * 4, mux=2), n_mux=2,
                             frames_per_shard=_BATCH, **_DRIFT)
    steps = [np.stack([synthetic_ts(stx.bytes_per_step_per_mux,
                                    seed=90 + 2 * k + c) for c in range(2)])
             for k in range(2)]
    kept = [stx.step_device(ts) for ts in steps]
    carries = np.zeros((2, 187), np.uint8)
    for k, (ts, out) in enumerate(zip(steps, kept)):
        want = _eager_blocks(stx, ts, carries, k)
        carries = ts[:, -187:]
        bases = {o._base.data_ptr() for row in out for o in row}
        assert len(bases) == 1
        for c in range(2):
            for s in range(2):
                assert torch.equal(out[c][s], want[c][s]), (k, c, s)
    assert kept[0][0][0]._base.data_ptr() != kept[1][0][0]._base.data_ptr()


def test_restored_checkpoint_stages_the_restored_frame_indices():
    """A checkpoint after one step of a (2, 1) mesh at the odd batch,
    loaded into a new transmitter: its next step stages frame index 1 in
    every block and equals the original transmitter's next step."""
    cfg = vv009_config()

    def build():
        return ShardedTransmitter(cfg, make_mesh(["cpu"] * 2, mux=2),
                                  n_mux=2, frames_per_shard=_BATCH, **_DRIFT)

    stx = build()
    ts = [np.stack([synthetic_ts(stx.bytes_per_step_per_mux,
                                 seed=110 + 2 * k + c) for c in range(2)])
          for k in range(2)]
    stx.step_device(ts[0])
    again = build()
    again.load_state(stx.state_dict())
    got = again.step_device(ts[1])
    (step,) = again._steps.values()
    assert step.frame_idx.tolist() == [1, 1]
    want = stx.step_device(ts[1])
    for c in range(2):
        assert torch.equal(got[c][0], want[c][0]), c


@pytest.mark.parametrize("frame_idx0", [0, 1])
def test_compiled_symbol_sharded_equals_eager_and_the_whole_step(frame_idx0):
    """vv009's 7 symbols over 8 CPU slots (one slab all padding): the
    compiled callable (one ``CompiledStep`` on one device) stages the
    window and frame index and is bit-identical to its eager form and to
    ``transmit_step_iq``, at both frame indices."""
    cfg = vv009_config()
    plan = build_plan(cfg, 1, strict=False)
    fn = grids_symbol_sharded(plan, make_mesh(["cpu"] * 8, mux=1))
    assert isinstance(fn._step, CompiledStep) and fn.graphs == []
    padded = torch.from_numpy(np.concatenate(
        [np.zeros(187, np.uint8), synthetic_ts(plan.ts_bytes_in, seed=120)]))
    got = fn(padded, frame_idx0)
    assert fn._step.frame_idx.tolist() == [frame_idx0]
    assert torch.equal(fn._step.windows[0][0], padded)
    assert got.shape == (1, cfg.samples_per_frame, 2)
    assert torch.equal(got, fn.eager(padded, frame_idx0))
    assert torch.equal(got, transmit_step_iq(
        plan_tensors(plan, "cpu", False), padded, frame_idx0))
