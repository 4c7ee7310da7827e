"""Hand-written CUDA kernels for Hopper, each beside its plain torch twin."""


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, by the kernel's name (``fft_tail``: the
    complex tail's cuFFT transform).  A wrapper's
    ``launches`` counts its kernel's launches; ``compiled.CompiledStep``
    adds a captured step's share at every replay."""
    from .fec import bb_bch
    from .ifft import fft_tail, ifft_gi
    from .ldpc import ldpc_codeword
    from .qam import qam_map
    return {"bb_bch": bb_bch, "ldpc_parity": ldpc_codeword,
            "qam_map": qam_map, "ifft_gi": ifft_gi, "fft_tail": fft_tail}
