"""fec_roofline.32k: the FEC layer (``ops/fec.py`` -> ``csrc/bb_bch.cu``,
then ``ops/ldpc.py`` -> ``csrc/ldpc_parity.cu``) against the bytes-bound
of its interface: the step's TS window (the 187 carried bytes and the
fresh TS) read once and every FEC frame's ldpc_frame_bits u8 codeword
written once, over 3.35 TB/s; the (F, nbch) bits that pass from the one
kernel to the other are not the interface's.  The time is the summed
traced time of the kernels named ``bb_bch`` or ``ldpc``; every step
traced, one window a card a step (the runner ``single``)."""
from txbench.peaks import share_pct

KERNELS = ("bb_bch", "ldpc")


def interface_bytes(cfg, frames: int, windows: int) -> int:
    """``windows`` windows of one PLP in NORMAL mode, ``frames`` T2 frames
    in all: (kbch - 80) / 8 fresh TS bytes a FEC frame."""
    fec = frames * cfg.fec_blocks
    return windows * 187 + fec * cfg.df_bytes + fec * cfg.ldpc_frame_bits


def read(run):
    tr = run.trace
    if tr is None or not tr.steps:
        return None
    secs = sum(tr.kernel_s(d, lambda n: any(k in n for k in KERNELS))
               for d in tr.devices)
    windows = tr.steps * run.chips
    return share_pct(interface_bytes(run.ref_cfg, windows * run.card_frames,
                                     windows), 0.0, secs)
