"""map_roofline: the mapper kernel (``ops/qam.py`` -> ``csrc/qam_map.cu``:
bit interleave, Gray QAM levels, rotation, cyclic Q delay) against its
bytes-bound: each FEC frame's ldpc_frame_bits u8 codeword read once and
its cell_size cells written once, 8 bytes a cell (two float32 planes or
complex64), over 3.35 TB/s; every FEC frame of the traced steps on every
card, over the traced time of the kernels named ``qam_map``.  Nothing
where no such kernel ran."""
from txbench.peaks import share_pct

KERNELS = ("qam_map",)


def map_bytes(cfg, fec_frames: int) -> int:
    """The codewords read, the cells written: the mapper row of
    ``dvbt2ll_tpu_torch/tools/roofline.py``'s ``part_traffic``."""
    return fec_frames * (cfg.ldpc_frame_bits + cfg.cell_size * 8)


def read(run):
    tr = run.trace
    if tr is None or not tr.steps:
        return None
    secs = sum(tr.kernel_s(d, lambda n: any(k in n for k in KERNELS))
               for d in tr.devices)
    fec = tr.steps * run.card_frames * run.chips * run.ref_cfg.fec_blocks
    return share_pct(map_bytes(run.ref_cfg, fec), 0.0, secs)
