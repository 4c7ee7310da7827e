"""tail_roofline: the fused planar OFDM tail (``ops/ifft.py`` ->
``csrc/ifft_gi.cu``, IFFT, guard interval, P1, I/Q) against its bound:
grids, P1 and twiddles read once and the I/Q written once, or 5 N log2 N
float32 operations a transform, the larger; every frame of the traced
steps on every card, over the kernels' traced time."""
from txbench.peaks import fft_flops, share_pct, tail_bytes

KERNELS = ("ofdm_tail_kernel",)


def read(run):
    tr = run.trace
    if tr is None or not tr.steps:
        return None
    secs = sum(tr.kernel_s(d, lambda n: any(k in n for k in KERNELS))
               for d in tr.devices)
    cfg = run.ref_cfg
    frames = tr.steps * run.card_frames * run.chips
    return share_pct(tail_bytes(cfg, frames),
                     fft_flops(frames, cfg.num_symbols, cfg.fft_points),
                     secs)
