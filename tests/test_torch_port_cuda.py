"""Card-only tests of the port's CUDA kernel and serving path.

Every test here carries the `cuda` marker and skips without a card.  The
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda -q

(`--noconftest` skips tests/conftest.py, which imports JAX.)  The kernel is
held to its plain PyTorch version on the same CUDA tensors, and the server
on the card to the same server on the CPU.
"""

import numpy as np
import pytest
import torch

from sgnn_tpu_torch.data.synthetic import random_graph_dataset
from sgnn_tpu_torch.graph.adjacency import Adjacency
from sgnn_tpu_torch.models.gnn import init_model
from sgnn_tpu_torch.ops.cuda.spmm import spmm_csr_cuda
from sgnn_tpu_torch.ops.segment import csr_from_numpy, spmm_csr, spmm_csr_plain
from sgnn_tpu_torch.train.inference import InferenceServer

pytestmark = pytest.mark.cuda

# f32 on both sides with TF32 off: only the summation order differs
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _skewed_csr(rng, v, e, zero_rows):
    dst = (rng.zipf(1.5, e) % v).astype(np.int32)
    dst = dst[~np.isin(dst, zero_rows)]
    src = rng.integers(0, v, dst.size).astype(np.int32)
    w = rng.standard_normal(dst.size).astype(np.float32)
    order = np.argsort(dst, kind="stable")
    rowptr = np.zeros(v + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=v), out=rowptr[1:])
    return rowptr, src[order], w[order]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("feat", [7, 41, 128, 256])
def test_kernel_matches_plain(cuda_device, dtype, tol, feat):
    rng = np.random.default_rng(feat)
    v = 3000
    rowptr, col, w = _skewed_csr(rng, v, 60000, zero_rows=[1, 2])
    csr = csr_from_numpy(rowptr, col, w, v, device=cuda_device)
    x = torch.from_numpy(rng.standard_normal((v, feat)).astype(np.float32))
    xd = x.to(cuda_device, dtype)
    before = spmm_csr_cuda.launches
    out = spmm_csr(xd, *csr)
    torch.cuda.synchronize()
    assert spmm_csr_cuda.launches == before + 1
    assert out.dtype == dtype and out.shape == (v, feat)
    ref = spmm_csr_plain(xd, *csr).float()
    # f32: reassociation only (index_add_ on the card uses atomics);
    # bf16: both sum in f32 and round once, ~1 bf16 ulp (2^-8) of an
    # element — the repo's bf16 kernel bound (tests/test_mxu_spmm.py:57)
    assert ((out.float() - ref).abs().max() / ref.abs().max()).item() <= tol
    assert bool((out[[1, 2]] == 0).all())  # zero in-degree writes zeros
    assert torch.equal(out, spmm_csr(xd, *csr))  # no atomics: deterministic


def test_kernel_rejects_mixed_devices(cuda_device):
    x = torch.ones(2, 3, device=cuda_device)
    with pytest.raises(ValueError, match="rowptr is on cpu"):
        spmm_csr_cuda(x, torch.tensor([0, 1, 2]),
                      torch.tensor([0, 1], dtype=torch.int32,
                                   device=cuda_device),
                      torch.ones(2, device=cuda_device))


@pytest.mark.parametrize("family", ["gcn", "sage"])
@pytest.mark.parametrize("batch_norm", [False, True])
def test_server_on_card_matches_cpu(cuda_device, family, batch_norm):
    ds = random_graph_dataset(500, 8, 32, 5, seed=7)
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    p = init_model(4, family, [32, 16, 5], device="cpu")
    cpu = InferenceServer(p, family, adj, ds.features,
                          batch_norm=batch_norm, device="cpu")
    gpu = InferenceServer(p, family, adj, ds.features,
                          batch_norm=batch_norm, device=cuda_device)
    before = spmm_csr_cuda.launches
    np.testing.assert_allclose(gpu.logprobs(), cpu.logprobs(), **F32)
    assert spmm_csr_cuda.launches == before + 2
    nids = np.array([0, 9, 9, 400])
    np.testing.assert_allclose(gpu.query(nids, fanout=3, seed=1),
                               cpu.query(nids, fanout=3, seed=1), **F32)
