"""The benchmark of dvbt2ll_tpu_torch on NVIDIA cards.

    python3 txbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Runs one cell of ``BENCHMARK.json`` in this process: makes the TS from
the seed, builds the port's object for the cell and warms it up (set-up),
measures for S seconds, checks what the timed path produced against the
plain NumPy reference (``txbench/reference``), and prints one JSON line
last on standard output: the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics, read from a ``torch.profiler`` trace of a steady
part of the window and from the benchmark's own spans, with ``--trace 1``.
Exits non-zero, with no result line, without enough CUDA cards, without
the port, or when ``jax``, ``jaxlib``, ``flax`` or ``dvbt2ll_tpu`` was
loaded.  ``txbench/harness.py`` holds the loop; a cell's traffic, its
configuration and each metric are files found by name (``traffic/``,
``configs/``, ``metrics/``, ``runners/``).
"""
import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == "__main__":
    from txbench.harness import main
    sys.exit(main(sys.argv[1:], T_START))
