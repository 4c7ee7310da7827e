"""Frequency interleaver permutations H (EN 302 755 section 8.5).

Builds the even/odd permutations for data, P2 and frame-closing symbols from
the FFT-size-specific LFSR + bit permutation, matching reference
lib/framemapperfint_cc_impl.cc:357-424,916-977 (including the 32K special
case where the even permutation is the inverse of the odd one).
"""
import functools

import numpy as np

from . import table

# fft key -> (pn_degree, xor taps, even bitperm, odd bitperm)
_LFSR = {
    "1K": (9, (0, 4), "bitperm1keven", "bitperm1kodd"),
    "2K": (10, (0, 3), "bitperm2keven", "bitperm2kodd"),
    "4K": (11, (0, 2), "bitperm4keven", "bitperm4kodd"),
    "8K": (12, (0, 1, 4, 6), "bitperm8keven", "bitperm8kodd"),
    "16K": (13, (0, 1, 4, 5, 9, 11), "bitperm16keven", "bitperm16kodd"),
    "32K": (14, (0, 1, 2, 12), "bitperm32k", "bitperm32k"),
}


@functools.lru_cache(maxsize=32)
def _raw_sequences(fft_key: str):
    """The two candidate index sequences (even, odd) over all LFSR states."""
    degree, taps, even_name, odd_name = _LFSR[fft_key]
    perm_even = table(even_name)
    perm_odd = table(odd_name)
    max_states = 1 << (degree + 1)
    mask = (1 << degree) - 1

    evens = np.empty(max_states, dtype=np.int64)
    odds = np.empty(max_states, dtype=np.int64)
    lfsr = 0
    for i in range(max_states):
        if i in (0, 1):
            lfsr = 0
        elif i == 2:
            lfsr = 1
        else:
            fb = 0
            for t in taps:
                fb ^= (lfsr >> t) & 1
            lfsr &= mask
            lfsr >>= 1
            lfsr |= fb << (degree - 1)
        even = odd = 0
        for n in range(degree):
            bit = (lfsr >> n) & 1
            even |= bit << perm_even[n]
            odd |= bit << perm_odd[n]
        offset = (i % 2) * (max_states // 2)
        evens[i] = even + offset
        odds[i] = odd + offset
    return evens, odds


def build_h(fft_key: str, n_active: int):
    """(Heven, Hodd) permutations of size n_active (C_DATA, C_P2 or N_FC)."""
    evens, odds = _raw_sequences(fft_key)
    h_even = evens[evens < n_active][:n_active].copy()
    h_odd = odds[odds < n_active][:n_active].copy()
    assert len(h_even) == n_active and len(h_odd) == n_active
    assert len(np.unique(h_even)) == n_active  # must be a permutation
    assert len(np.unique(h_odd)) == n_active
    if fft_key == "32K":
        # Even symbols use the inverse of the odd permutation
        # (reference lib/framemapperfint_cc_impl.cc:961-977).
        inv = np.empty_like(h_odd)
        inv[h_odd] = np.arange(len(h_odd))
        h_even = inv
    return h_even.astype(np.int32), h_odd.astype(np.int32)
