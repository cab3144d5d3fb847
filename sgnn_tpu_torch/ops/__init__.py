from .aggregate import gather_aggregate, gather_aggregate_plain
from .segment import Csr, csr_from_numpy, spmm_csr, spmm_csr_plain

__all__ = ["Csr", "csr_from_numpy", "gather_aggregate",
           "gather_aggregate_plain", "spmm_csr", "spmm_csr_plain"]
