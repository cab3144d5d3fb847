"""Which device kernels belong to which layer, by substrings of their
names in the profiler's trace.

The port's kernels' patterns are a frozen copy of
`scripts/torch_profile_training.py`'s `SAMPLED_KERNELS` and
`FULL_KERNELS`: K1's forward (`gather_agg_fwd_kernel`), dx's
transpose (`block_transpose_*`) and dx's CSR sum (csr_sum.cuh's walk with
SumPolicy, its RowStore fix-up and the shared first fix-up level
`csr_carry_group`), K2's forward (`spmm_csr_kernel`) and backward (the
same CSR sum), K3 (`gat_kernel<`), B1 (the walk with SrcPolicy and its
fix-up) and B2 (`gat_bwd_dst_`).  The sampled GAT pair
(`csrc/gat_sampled.cu`) is its forward (`gat_sampled_fwd_kernel`), its
backward's destination pass (`gat_sampled_dst_kernel`), K1's block
transpose handing out the slots, the walk with AttSrcPolicy and its
fix-up (AttSrcStore), and each row's dtd summed onto its source row by
K1 dx's transpose and CSR sum.  `csr_carry_group` is shared by K2's
backward, dx's sum, B1 and the sampled GAT pair, and the transpose and
the SumPolicy walk by K1 dx and the sampled GAT pair, which never run in
one cell's group.  cuBLAS's
products are every kernel whose name holds "gemm" or "gemv" (its SIMT and
tensor-core GEMMs and their split-K reductions) in any case.
"""

from __future__ import annotations

from typing import Dict, Tuple

SUM_WALK = ("SumPolicy", "RowStore", "csr_carry_group")

GROUPS: Dict[str, Tuple[str, ...]] = {
    "gather_agg": ("gather_agg_fwd", "block_transpose") + SUM_WALK,
    "spmm": ("spmm_csr_kernel",) + SUM_WALK,
    "gat": ("gat_kernel<",),
    "gat_bwd": ("SrcPolicy", "SrcStore", "csr_carry_group", "gat_bwd_dst_"),
    "gat_sampled": ("gat_sampled_fwd_kernel", "gat_sampled_dst_kernel",
                    "block_transpose", "AttSrcPolicy", "AttSrcStore")
    + SUM_WALK,
}

PRODUCT_PATTERNS = ("gemm", "gemv", "splitkreduce")


def in_group(name: str, group: str) -> bool:
    """Whether the kernel called `name` belongs to the named group."""
    return any(p in name for p in GROUPS[group])


def is_product(name: str) -> bool:
    """Whether the kernel called `name` is one of cuBLAS's products."""
    low = name.lower()
    return any(p in low for p in PRODUCT_PATTERNS)
