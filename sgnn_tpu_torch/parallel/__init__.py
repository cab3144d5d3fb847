"""Data parallelism over `torch.distributed` (the port of sgnn_tpu/parallel/):
the process group (`mesh`), the host-sampled and device-sampled
data-parallel trainers (`dp`, `dp_device`) and row-sharded features
(`sharded_features`)."""
