"""ldpc_roofline: the LDPC codeword kernel (``ops/ldpc.py`` ->
``csrc/ldpc_parity.cu``) against its bytes-bound: each FEC frame's nbch
bits read and its codeword written, u8, over 3.35 TB/s; every FEC frame
of the traced steps on every card, over the kernels' traced time."""
from txbench.peaks import ldpc_bytes, share_pct

KERNELS = ("ldpc_codeword_kernel",)


def read(run):
    tr = run.trace
    if tr is None or not tr.steps:
        return None
    secs = sum(tr.kernel_s(d, lambda n: any(k in n for k in KERNELS))
               for d in tr.devices)
    fec = tr.steps * run.card_frames * run.chips * run.ref_cfg.fec_blocks
    return share_pct(ldpc_bytes(run.ref_cfg, fec), 0.0, secs)
