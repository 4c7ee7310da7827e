"""fft_roofline.32k: the complex OFDM tail's transform
(``pipeline.symbols_with_gi`` -> ``ops.ifft.fft_tail``, cuFFT through
``torch.fft.ifft``) against the bound of the tail's interface, the work
``tail_roofline`` counts whatever implements it: the grids read once and
the final I/Q written once, float32, or 5 N log2 N float32 operations a
transform, the larger.  The time is that of the kernels named as the
card's trace names cuFFT's (on the H100 one kernel a 32K transform,
``vector_fft<32768u, EPT<32u>, ...>``), or ``ofdm_tail``, so that a
later hand-written 32K tail under the port's naming is counted too.  The
scale products after the transform and the guard interval and P1 copies
are other kernels and fall outside it, so folding them into the
transform moves ``device_step_ms``, not this share; every frame of the
traced steps on every card.  Where a cuFFT plan runs a kernel of
another name (an ``fft`` in it that ``KERNELS`` does not match; the
port's stage mark ``dvbt2ll_mark_ifft`` is none), part of the transform
would fall outside the time: the reader then reads nothing."""
from txbench.peaks import fft_flops, share_pct, tail_bytes

KERNELS = ("vector_fft", "ofdm_tail")
MARK = "dvbt2ll_mark_"


def _ours(name: str) -> bool:
    return any(k in name for k in KERNELS)


def _other_fft(name: str) -> bool:
    return ("fft" in name.lower() and not _ours(name)
            and MARK not in name)


def read(run):
    tr = run.trace
    if tr is None or not tr.steps:
        return None
    if any(tr.kernel_s(d, _other_fft) for d in tr.devices):
        return None
    secs = sum(tr.kernel_s(d, _ours) for d in tr.devices)
    cfg = run.ref_cfg
    frames = tr.steps * run.card_frames * run.chips
    return share_pct(tail_bytes(cfg, frames),
                     fft_flops(frames, cfg.num_symbols, cfg.fft_points),
                     secs)
