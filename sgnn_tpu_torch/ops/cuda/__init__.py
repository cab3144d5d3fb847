"""CUDA kernels of the port: sources under `sgnn_tpu_torch/csrc/`, built by
`build.py` at first use, each wrapped by a module here."""
