"""Speed-of-light (roofline) model of the transmit chain on the NVIDIA H100.

    python -m dvbt2ll_tpu_torch.tools.roofline [batch] [config ...] [--device cuda|cpu]

Defaults: batch 256, taken as given at every geometry, and vv009_4kshort,
8k_normal and 32k_extended.  Pure arithmetic on the plan's shapes: the
card is only named (``--device cpu`` prints the same numbers without
one).

Two views of a step's device-memory traffic:

* ``stage_traffic``: the JAX package's stage model (``tools/roofline.py``),
  row for row and byte for byte: every array a stage must materialise
  because the next operation is a gather, an FFT or a reshape that cannot
  fuse through it, and its total over the memory rate as the chain's
  speed of light.
* ``part_traffic``: the parts of the port's device step as
  ``profile_step`` times them (PERF.md section 5): ``bb_and_fec``, the
  mapper, the frame builder, and the OFDM tail.  The planar tail is the
  fused kernel ``csrc/ifft_gi.cu``: the grids, P1 and its two twiddle
  tables read once, the final I/Q written once.  The complex tail is
  ``torch.fft`` with the guard interval, then P1 with ``view_as_real``.

Each bound (``bound``) is the larger of the bytes over the memory rate and
the float32 operations over the float32 rate, at the H100 SXM data-sheet
peaks.  The FEC, mapper and frame-builder parts are bit, byte and gather
work whose few float32 operations are counted but never bind.
"""
from __future__ import annotations

import argparse
import json
import math

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12     # float32 outside the tensor cores, the same
P1_LEN = 2048               # samples of P1 (ops/ifft.py)
N1 = 128                    # the planar tail's second DFT factor
CONFIGS = ("vv009_4kshort", "8k_normal", "32k_extended")


def bound(nbytes: float, flops: float) -> tuple:
    """(ms, what sets it): the larger of the bytes over the memory rate
    and the float32 operations over the float32 rate, both the published
    H100 SXM peaks."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def stage_traffic(cfg, plan, batch):
    """[(stage, bytes, note)] of the unavoidable device-memory reads and
    writes of one step, and its samples: the JAX package's stage model."""
    f = plan.fec_frames
    pp = plan.plps[0]
    samples = batch * cfg.samples_per_frame
    bits = f * cfg.ldpc_frame_bits          # u8 bit-planes
    cells = f * cfg.cell_size * 8           # complex64
    grid = batch * cfg.num_symbols * cfg.fft_points * 8
    out = samples * 8                       # c64 (== f32 I/Q planes)
    return [
        # read the TS bytes, the stream bits once, write the frame bits
        ("bb+BCH+LDPC", pp.ts_bytes_in + f * cfg.nbch + bits,
         "in: TS u8; out: (F, frame_bits) u8"),
        ("bit-ilv + QAM map", bits + cells, "gather src + c64 cells"),
        ("frame build (1 gather)", cells + grid,
         "grid_src gather + pilot add"),
        # an in-place FFT still streams both ways
        ("IFFT", 2 * grid, "per-symbol c64 FFT"),
        ("GI + P1 + IQ out", grid + out,
         "cyclic-prefix concat + f32 planes"),
    ], samples


def tail_kernel_bytes(batch: int, symbols: int, fft: int, gi: int) -> int:
    """The fused planar tail's bytes: the (B, S, N2, 128) re and im grids,
    P1 (2048, 2), the (128, 2) and (fft, 2) twiddle tables, all float32,
    read once, and the (B, 2048 + S (fft + gi), 2) float32 I/Q written
    once."""
    return 4 * (2 * batch * symbols * fft + 2 * P1_LEN + 2 * N1 + 2 * fft
                + 2 * batch * (P1_LEN + symbols * (fft + gi)))


def fft_flops(batch: int, symbols: int, fft: int) -> float:
    """5 N log2 N float32 operations a complex transform of N points."""
    return 5.0 * batch * symbols * fft * math.log2(fft)


def part_traffic(cfg, plan, batch, planar: bool):
    """[(name, part, bytes, float32 operations)] of the port's device
    step, summed over the PLPs where a part runs once a PLP."""
    s, fft, gi = cfg.num_symbols, cfg.fft_points, cfg.guard_samples
    grid_points = batch * s * fft
    fec = mapper = cells = cell_count = 0
    for pp in plan.plps:
        c = pp.cfg
        bits = pp.fec_frames * c.ldpc_frame_bits
        fec += pp.ts_bytes_in + pp.fec_frames * c.nbch + bits
        n_cells = pp.fec_frames * c.cell_size
        mapper += bits + n_cells * 8
        cells += n_cells * 8
        # two levels scaled, then the rotation's four products and two sums
        cell_count += n_cells * (8 if c.rotation else 2)
    # the builder writes the grids once, adding the pilot plane (and the
    # inverse sinc on both planes)
    builder_ops = grid_points * (3 if plan.eq is not None else 1)
    rows = [("bb_and_fec", "bb_and_fec (CRC, BCH, LDPC codeword)", fec, 0.0),
            ("mapper", "mapper", mapper, float(cell_count)),
            ("frame_builder", "frame builder", cells + grid_points * 8,
             float(builder_ops))]
    if planar:
        rows.append(("tail_kernel", "tail kernel with P1 and I/Q",
                     tail_kernel_bytes(batch, s, fft, gi),
                     fft_flops(batch, s, fft)))
    else:
        body = batch * s * (fft + gi) * 8
        eq = fft * 4 if plan.eq is not None else 0
        rows.append(("fft_gi", "torch.fft tail with GI",
                     grid_points * 8 + eq + body, fft_flops(batch, s, fft)))
        rows.append(("p1_iq", "P1 + view_as_real",
                     P1_LEN * 8 + body + batch * cfg.samples_per_frame * 8,
                     0.0))
    return rows


def roofline(name: str, batch: int) -> dict:
    """Both views of ``name`` at ``batch`` frames, with every bound."""
    from ..config import named_config
    from ..ops.ifft import supported
    from ..plan import build_plan
    cfg = named_config(name)
    plan = build_plan(cfg, batch, strict=False)
    planar = supported(cfg.fft_points, cfg.guard_samples)
    stages, samples = stage_traffic(cfg, plan, batch)
    total = sum(r[1] for r in stages)
    parts = []
    for key, label, nbytes, flops in part_traffic(cfg, plan, batch, planar):
        ms, by = bound(nbytes, flops)
        parts.append({"name": key, "part": label, "bytes": nbytes,
                      "flops": flops, "bound_ms": ms, "bound_by": by})
    step_ms = sum(p["bound_ms"] for p in parts)
    n = cfg.fft_points
    return {
        "config": name, "batch": batch, "samples": samples,
        "tail": "planar" if planar else "complex",
        "stages": [{"stage": st, "bytes": b, "note": note}
                   for st, b, note in stages],
        "stage_total_bytes": total,
        "stage_speed_of_light_msamples_s":
            samples / (total / HBM_BYTES_PER_S) / 1e6,
        "ifft_bandwidth_ms": 2 * batch * cfg.num_symbols * n * 8
        / HBM_BYTES_PER_S * 1e3,
        "ifft_compute_ms": fft_flops(batch, cfg.num_symbols, n)
        / FP32_FLOP_PER_S * 1e3,
        "parts": parts,
        "step_bound_ms": step_ms,
        "step_speed_of_light_msamples_s": samples / step_ms / 1e3,
    }


def report(r: dict) -> str:
    """The human-readable table of one ``roofline`` result."""
    lines = [f"== {r['config']} (batch {r['batch']}, "
             f"{r['samples'] / 1e6:.2f} Msamples/step, {r['tail']} tail) =="]
    for st in r["stages"]:
        lines.append(f"  {st['stage']:24s} {st['bytes'] / 1e6:9.2f} MB  "
                     f"{st['bytes'] / HBM_BYTES_PER_S * 1e6:8.2f} us   "
                     f"{st['note']}")
    lines.append(f"  {'TOTAL':24s} {r['stage_total_bytes'] / 1e6:9.2f} MB  "
                 f"{r['stage_total_bytes'] / HBM_BYTES_PER_S * 1e6:8.2f} us")
    fft_bw, fft_ops = r["ifft_bandwidth_ms"], r["ifft_compute_ms"]
    lines.append(f"  IFFT bound: bandwidth {fft_bw * 1e3:.2f} us vs compute "
                 f"{fft_ops * 1e3:.2f} us -> "
                 f"{'BANDWIDTH' if fft_bw > fft_ops else 'COMPUTE'}-bound")
    lines.append(f"  speed-of-light (stage model): "
                 f"{r['stage_speed_of_light_msamples_s']:,.0f} "
                 f"Msamples/s/chip at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    for p in r["parts"]:
        lines.append(f"  part {p['part']:34s} {p['bytes'] / 1e6:9.2f} MB "
                     f"{p['flops'] / 1e9:8.3f} GFLOP  bound "
                     f"{p['bound_ms']:.4f} ms ({p['bound_by']})")
    lines.append(f"  port's device step bound {r['step_bound_ms']:.4f} ms = "
                 f"{r['step_speed_of_light_msamples_s']:,.0f} Msamples/s")
    return "\n".join(lines)


def main(argv=None) -> None:
    from . import device_line, open_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=256)
    ap.add_argument("configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--device", default="cuda",
                    help="the card whose name heads the output (default "
                         "cuda; cpu prints the arithmetic alone)")
    args = ap.parse_args(argv)
    dev = open_device(args.device)
    print(device_line(dev), flush=True)
    for name in args.configs:
        r = roofline(name, args.batch)
        print(report(r))
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
