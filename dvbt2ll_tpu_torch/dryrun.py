"""Dry runs of the multi-device layer: the counterparts of
``__graft_entry__.dryrun_multichip`` and ``tools/dryrun_multihost.py``.

    python -m dvbt2ll_tpu_torch.dryrun multichip [--device cpu|cuda] [--slots N]
    python -m dvbt2ll_tpu_torch.dryrun multihost [--device cpu|cuda] [--slots N]

``multichip``: one sharded step over N slots of one device (mux 2 when N
is even), each block bit-identical to the sequential ``Transmitter`` on
the same device at the same per-call batch, then the symbol-sharded
OFDM back-end against ``pipeline.transmit_step_iq``.

``multihost``: one single-process run of the cases, then two processes
joined by ``torch.distributed`` (gloo, a localhost rendezvous on a free
port), each running only its half of the global mesh (one compiled step
a device over its own blocks, none for the other's): a vv009 drift step
and two strict steps of a phase-invariant HIEFF config.  The steps call
no collective; rank 0 gathers the blocks afterwards and asserts them
bit-identical to the single-process run.  Every worker has a time limit.
``run_workers`` and ``process_group`` are the worker machinery, shared
with ``tools/bench_scaling.py``.
A missing CUDA device is an error, never a CPU run.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .io import synthetic_ts
from .config import (CodeRate, Constellation, FFTSize, FrameSize,
                     GuardInterval, InputMode, PilotPattern, Rotation,
                     T2Config, vv009_config)
from .convert import plan_tensors
from .parallel import (ShardedTransmitter, grids_symbol_sharded, make_mesh)
from .pipeline import Transmitter, transmit_step_iq
from .plan import build_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 2
N_MUX = 2
SLOTS_PER_PROC = 4
TS_SEED = 77
WORKER_TIMEOUT = 300.0   # seconds, for each multihost worker


def phase_invariant_config() -> T2Config:
    """A config whose per-frame TS payload is a whole number of packets
    (HIEFF: 17 x 869 = 79 x 187), so min_batch_frames == 1 and every
    shard and step starts packet-aligned: the valid-continuous-stream
    sharded mode (tests/test_sharding.py::_phase_invariant_cfg)."""
    return T2Config(
        frame_size=FrameSize.SHORT, code_rate=CodeRate.C1_2,
        constellation=Constellation.QAM256, rotation=Rotation.ON,
        fft_size=FFTSize.FFT_4K, guard_interval=GuardInterval.GI_1_32,
        pilot_pattern=PilotPattern.PP7, fec_blocks=17, ti_blocks=1,
        t2_frames=2, num_data_symbols=12,
        input_mode=InputMode.HIEFF).validate()


def dryrun_multichip(n_slots: int = 8, device="cuda") -> dict:
    """One sharded vv009 step over ``n_slots`` slots of ``device`` (dp
    over mux x frame), then the symbol-sharded back-end over the same
    count.  Raises unless every block is bit-identical to the sequential
    single-chain ``Transmitter`` on the same device at the same per-call
    batch (1 frame) and stays on its slot's device, and the symbol-sharded
    step is bit-identical to the whole one."""
    cfg = vv009_config()
    mux = 2 if n_slots % 2 == 0 and n_slots > 1 else 1
    mesh = make_mesh([device] * n_slots, mux=mux)
    dev = mesh.devices[0, 0]
    stx = ShardedTransmitter(cfg, mesh, n_mux=mux, frames_per_shard=1,
                             allow_phase_drift=True, strict=False)
    ts = np.stack([synthetic_ts(stx.bytes_per_step_per_mux, seed=2 + c)
                   for c in range(mux)])
    out = stx.step_device(ts)
    for c in range(mux):
        # per-shard phase-0 windows match allow_phase_drift semantics
        tx = Transmitter(cfg, 1, strict=False, allow_phase_drift=True,
                         device=dev)
        n = tx.bytes_per_step
        for s in range(stx.frame_shards):
            got = out[c][s]
            if got.device != mesh.devices[c // stx.mux_per_shard, s]:
                raise RuntimeError(f"block ({c}, {s}) on {got.device}")
            seq = tx.step_device(ts[c, s * n:(s + 1) * n])
            if not torch.equal(got, seq):
                raise RuntimeError(f"sharded output differs from "
                                   f"sequential at mux {c} shard {s}")

    plan = build_plan(cfg, n_slots, strict=False)
    fn = grids_symbol_sharded(plan, make_mesh([device] * n_slots, mux=1))
    padded = torch.from_numpy(np.concatenate(
        [np.zeros(187, np.uint8), synthetic_ts(plan.ts_bytes_in, seed=9)]))
    padded = padded.to(dev)
    if not torch.equal(fn(padded, 0), transmit_step_iq(
            plan_tensors(plan, dev, False), padded, 0)):
        raise RuntimeError("symbol-sharded back-end differs from the whole "
                           "step")
    return {"blocks": mux * stx.frame_shards, "mux": mux}


def _cases(mesh) -> dict:
    """The multihost checks: (a) one drift-mode vv009 step (mechanism),
    (b) TWO strict phase-invariant steps (the valid-stream mode, with the
    carry between them).  Name -> ``step_device`` blocks."""
    out = {}
    stx = ShardedTransmitter(vv009_config(), mesh, n_mux=N_MUX,
                             frames_per_shard=1, allow_phase_drift=True,
                             strict=False)
    ts = np.stack([synthetic_ts(stx.bytes_per_step_per_mux,
                                seed=TS_SEED + c) for c in range(N_MUX)])
    out["vv009_drift"] = stx.step_device(ts)
    stx2 = ShardedTransmitter(phase_invariant_config(), mesh, n_mux=N_MUX,
                              frames_per_shard=1)
    n = stx2.bytes_per_step_per_mux
    ts2 = np.stack([synthetic_ts(2 * n, seed=TS_SEED + 10 + c)
                    for c in range(N_MUX)])
    out["strict_s1"] = stx2.step_device(ts2[:, :n])
    out["strict_s2"] = stx2.step_device(ts2[:, n:])
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(args: list, timeout: float, what: str) -> list:
    """N_PROCS processes ``python -m <args> --rank r --port p``, r = 0 ..
    N_PROCS - 1, with a free localhost port for their rendezvous
    (``process_group``).  Returns each rank's output; raises when a
    worker fails or the workers run over ``timeout`` seconds in all, and
    leaves no worker running."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    with tempfile.TemporaryDirectory() as tmp:
        # each worker's output goes to a file: a pipe nobody reads while
        # the other worker is waited on could fill and stall both
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(N_PROCS)]
        procs = []
        try:
            for r, log in enumerate(logs):
                with open(log, "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", *map(str, args), "--rank",
                         str(r), "--port", str(port)],
                        cwd=ROOT, env=env, stdout=f,
                        stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"{what}: a worker ran over "
                               f"{timeout:.0f} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        said = []
        for log in logs:
            with open(log) as f:
                said.append(f.read())
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise RuntimeError(f"{what} FAILED, rcs={rcs}\n" + "\n".join(
            f"rank {r}:\n{out}" for r, out in enumerate(said)))
    return said


@contextlib.contextmanager
def process_group(rank: int, port: int):
    """This worker's membership of the N_PROCS-process gloo group that
    ``run_workers`` started, for the block."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=N_PROCS,
        rank=rank, timeout=datetime.timedelta(seconds=WORKER_TIMEOUT))
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def dryrun_multihost(device="cuda", slots: int = SLOTS_PER_PROC,
                     timeout: float = WORKER_TIMEOUT) -> str:
    """Ground truth in this process over N_PROCS * ``slots`` slots, then
    N_PROCS worker processes of ``slots`` slots each on one global mesh.
    Returns rank 0's verdict line; raises when a worker fails, times out
    or its blocks differ."""
    with tempfile.TemporaryDirectory() as tmp:
        truth = os.path.join(tmp, "single.npz")
        outs = _cases(make_mesh([device] * (N_PROCS * slots), mux=N_MUX))
        np.savez(truth, **{name: np.stack([
            np.stack([o.cpu().numpy() for o in row]) for row in blocks])
            for name, blocks in outs.items()})
        said = run_workers(
            ["dvbt2ll_tpu_torch.dryrun", "worker", "--device", device,
             "--slots", slots, "--truth", truth], timeout, "multihost dryrun")
    verdict = [ln for ln in said[0].splitlines() if "BIT-IDENTICAL" in ln]
    if not verdict:
        raise RuntimeError(f"multihost dryrun: rank 0 gave no verdict\n"
                           f"{said[0]}")
    return verdict[0]


def _worker(device, slots: int, rank: int, port: int, truth: str) -> None:
    with process_group(rank, port) as dist:
        mesh = make_mesh([device] * slots, mux=N_MUX)
        if mesh.world != N_PROCS:
            raise RuntimeError(f"mesh over {mesh.world} processes")
        outs = _cases(mesh)
        mine = {}
        mps = N_MUX // mesh.shape["mux"]
        for name, blocks in outs.items():
            for c, row in enumerate(blocks):
                for s, o in enumerate(row):
                    owned = mesh.devices[c // mps, s] is not None
                    if (o is not None) != owned:
                        raise RuntimeError(f"{name} block ({c}, {s}): "
                                           f"owned {owned}, got {o}")
                    if owned:
                        mine[(name, c, s)] = o.cpu().numpy()
        stx = ShardedTransmitter(phase_invariant_config(), mesh,
                                 n_mux=N_MUX, frames_per_shard=1)
        compiled = sum(st.blocks for st in stx._steps.values())
        if compiled != len(mine) // len(outs):
            raise RuntimeError(f"compiled steps over {compiled} blocks, "
                               f"this process owns {len(mine) // len(outs)}")
        try:
            stx(np.zeros((N_MUX, stx.bytes_per_step_per_mux), np.uint8))
        except RuntimeError:
            pass
        else:
            raise RuntimeError("__call__ gathered a mesh it does not own")
        # the gather, after every step
        gathered = [None] * N_PROCS if rank == 0 else None
        dist.gather_object(mine, gathered, dst=0)
        if rank == 0:
            blocks = {}
            for part in gathered:
                blocks.update(part)
            with np.load(truth) as z:
                for name in outs:
                    want = z[name]
                    n_mux, n_frame = want.shape[:2]
                    for c in range(n_mux):
                        for s in range(n_frame):
                            got = blocks.pop((name, c, s))
                            if not np.array_equal(got, want[c, s]):
                                raise RuntimeError(
                                    f"FAIL {name} block ({c}, {s}) differs, "
                                    f"max |d|="
                                    f"{np.abs(got - want[c, s]).max()}")
            if blocks:
                raise RuntimeError(f"blocks no slot owns: {sorted(blocks)}")
            print(f"rank 0: {N_PROCS}-process outputs BIT-IDENTICAL to "
                  f"single-process ({sorted(outs)}; mesh {mesh.shape}, "
                  f"{slots} slots of {device} a process; incl. the strict "
                  f"phase-invariant 2-step valid-stream mode)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["multichip", "multihost", "worker"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of every slot (default cuda; a "
                         "missing CUDA device is an error)")
    ap.add_argument("--slots", type=int, default=None,
                    help="slots of the device (multichip: all of them, "
                         "default 8; multihost: a process, default "
                         f"{SLOTS_PER_PROC})")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--truth", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.what == "multichip":
        res = dryrun_multichip(args.slots or 8, args.device)
        print(f"dryrun_multichip ok: {res}")
    elif args.what == "multihost":
        print(dryrun_multihost(args.device, args.slots or SLOTS_PER_PROC))
        print("dryrun_multihost ok")
    else:
        _worker(args.device, args.slots, args.rank, args.port, args.truth)


if __name__ == "__main__":
    main()
