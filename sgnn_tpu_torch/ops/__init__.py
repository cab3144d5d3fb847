from .segment import Csr, csr_from_numpy, spmm_csr, spmm_csr_plain

__all__ = ["Csr", "csr_from_numpy", "spmm_csr", "spmm_csr_plain"]
