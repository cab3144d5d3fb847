"""Data and graph parallelism over `torch.distributed` (the port of
sgnn_tpu/parallel/): the process group (`mesh`), the host-sampled and
device-sampled data-parallel trainers (`dp`, `dp_device`), row-sharded
features (`sharded_features`), the vertex-partitioned halo exchange
(`halo`) and the multi-host join and drivers (`multihost`)."""
