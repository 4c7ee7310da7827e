"""The plain reference of the benchmark: a sequential NumPy DVB-T2 chain.

``chain`` is the stage-by-stage oracle (BB framing with CRC-8, BCH, LDPC,
bit interleaver and mapper with rotation and Q delay, cell, time and
frequency interleavers, L1, pilots, IFFT with guard interval, P1), and
``config`` and ``tables`` the configuration and EN 302 755 tables it
reads: frozen copies, free of ``jax``, of the JAX package and of the
program under test, so no change to either moves the yardstick.
``frames`` works out any T2 frame of a TS stream from the stream alone
and compares the program's IQ with it.
"""
