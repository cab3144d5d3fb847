"""The benchmark of `sgnn_tpu_torch`, the PyTorch/CUDA port: one command
(`benchmark/run.py`) runs one cell of BENCHMARK.json once.  Everything here
is the yardstick (the graph generator, the peaks, the bounds and FLOP
counts, the kernel-name patterns, the trace reading, the plain reference
and the comparison that decides `correct`); from the program it takes only
the system under test, through `benchmark/program.py`."""
