"""Card-only tests of the port's CUDA kernels, serving and training paths.

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

from sgnn_tpu_torch.config import RunConfig
from sgnn_tpu_torch.data.synthetic import random_graph_dataset
from sgnn_tpu_torch.graph.adjacency import Adjacency
from sgnn_tpu_torch.models.gnn import init_model
from sgnn_tpu_torch.ops import aggregate as agg
from sgnn_tpu_torch.ops.cuda import gather_agg as k1
from sgnn_tpu_torch.ops.cuda.spmm import spmm_csr_cuda
from sgnn_tpu_torch.ops.segment import csr_from_numpy, spmm_csr, spmm_csr_plain
from sgnn_tpu_torch.sampler.host import HostSampler
from sgnn_tpu_torch.train import build_trainer
from sgnn_tpu_torch.train.inference import InferenceServer
from sgnn_tpu_torch.train.trainer import host_batch_to_device, loss_and_grads

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


def _block(rng, d, k, s, feat, hubs=()):
    """A sampled-block-shaped input: random slots, 30% zero weights (the
    sampler's padding), and `hubs` source ids that take a run of slots."""
    nbr = rng.integers(0, s, (d, k)).astype(np.int32)
    for i, hub in enumerate(hubs):
        nbr.reshape(-1)[i::len(hubs) * 3] = hub
    w = rng.random((d, k)).astype(np.float32)
    w[rng.random((d, k)) < 0.3] = 0.0
    x = rng.standard_normal((s, feat)).astype(np.float32)
    g = rng.standard_normal((d, feat)).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, nbr, w, g)]


def _rel(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("feat", [7, 41, 128, 602])
@pytest.mark.parametrize("k", [1, 10, 25])
def test_gather_agg_kernels_match_plain(cuda_device, dtype, tol, feat, k):
    rng = np.random.default_rng(100 * k + feat)
    d, s = 1001, 700          # D not a multiple of 8
    x, nbr, w, g = (t.to(cuda_device) for t in
                    _block(rng, d, k, s, feat, hubs=(3, 500)))
    x, g = x.to(dtype), g.to(dtype)
    counts = [f.launches for f in (k1.gather_agg_fwd_cuda,
                                   k1.gather_agg_bwd_dx_cuda,
                                   k1.gather_agg_bwd_dw_cuda)]
    out = agg.gather_agg_fwd(x, nbr, w)
    dx = agg.gather_agg_bwd_dx(g, nbr, w, x)
    dw = agg.gather_agg_bwd_dw(g, x, nbr)
    torch.cuda.synchronize()
    assert [f.launches for f in (k1.gather_agg_fwd_cuda,
                                 k1.gather_agg_bwd_dx_cuda,
                                 k1.gather_agg_bwd_dw_cuda)] == [
        c + 1 for c in counts]
    assert out.dtype == dx.dtype == dtype and dw.dtype == torch.float32
    # f32: only the summation order differs (dx by atomics); bf16: both
    # sum in f32 and round once, ~1 bf16 ulp (tests/test_mxu_spmm.py:57)
    assert _rel(out, agg.gather_aggregate_plain(x, nbr, w)) <= tol
    assert _rel(dx, agg.gather_agg_bwd_dx_plain(g, nbr, w, s, dtype)) <= tol
    assert _rel(dw, agg.gather_agg_bwd_dw_plain(g, x, nbr)) <= tol
    assert torch.equal(out, agg.gather_agg_fwd(x, nbr, w))  # deterministic


def test_gather_aggregate_grads_card_vs_cpu(cuda_device):
    rng = np.random.default_rng(5)
    x, nbr, w, g = _block(rng, 301, 10, 257, 41, hubs=(0,))
    grads = []
    for dev in ("cpu", cuda_device):
        xx = x.to(dev).detach().requires_grad_()
        ww = w.to(dev).detach().requires_grad_()
        out = agg.gather_aggregate(xx, nbr.to(dev), ww)
        (out * g.to(dev)).sum().backward()
        grads.append((out.detach().cpu(), xx.grad.cpu(), ww.grad.cpu()))
    for a, b in zip(*grads):
        assert _rel(a, b) <= 1e-5


def test_gather_agg_kernel_rejects_bad_args(cuda_device):
    x = torch.ones(4, 3, device=cuda_device)
    nbr = torch.zeros(2, 2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="w is on cpu"):
        k1.gather_agg_fwd_cuda(x, nbr, torch.ones(2, 2))
    with pytest.raises(ValueError, match="nbr must be"):
        k1.gather_agg_fwd_cuda(x, nbr.long(), torch.ones(2, 2,
                                                         device=cuda_device))


@pytest.mark.parametrize("family", ["gcn", "sage"])
def test_model_grads_card_vs_cpu(cuda_device, family):
    """Loss and weight gradients of one sampled batch, card against CPU on
    the same blocks and weights (f32, TF32 off): summation order only."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = random_graph_dataset(2000, 10, 48, 5, seed=3)
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    hb = HostSampler(adj, [6, 4], 128, seed=2).sample(
        np.arange(0, 1000, 8, dtype=np.int32))
    payload = hb.payload(ds.features, ds.labels)
    p = init_model(1, family, [48, 16, 5], device="cpu")
    outs = [loss_and_grads(p.to(dev), family,
                           host_batch_to_device(hb, *payload, device=dev),
                           batch_norm=True)
            for dev in ("cpu", cuda_device)]
    assert abs(outs[0].loss.item() - outs[1].loss.item()) <= 1e-5
    for a, b in zip(outs[0].grads, outs[1].grads):
        assert _rel(b.cpu(), a) <= 1e-4


def test_device_trainer_epoch_launch_counts(cuda_device):
    """GSSAMPLEALLGPU on the card: finite losses, and K1 launched 2 forward
    + 2 dx per step, 2 forward per eval batch, no dw."""
    ds = random_graph_dataset(3000, 10, 48, 5, seed=4)
    cfg = RunConfig(algorithm="GSSAMPLEALLGPU", layer_sizes=[48, 16, 5],
                    fanout=[5, 3], batch_size=256, drop_rate=0.5,
                    vertices=ds.num_vertices)
    tr = build_trainer(cfg, ds, device=cuda_device)
    fns = (k1.gather_agg_fwd_cuda, k1.gather_agg_bwd_dx_cuda,
           k1.gather_agg_bwd_dw_cuda)
    before = [f.launches for f in fns]
    loss, acc, edges = tr.train_epoch()
    acc_val = tr.evaluate(tr.val_nids)
    steps = len(tr.step_ms)
    evals = -(-tr.val_nids.size // cfg.batch_size)
    assert np.isfinite(tr.step_losses).all() and edges > 0
    assert 0.0 <= acc <= 1.0 and 0.0 <= acc_val <= 1.0
    assert [f.launches - b for f, b in zip(fns, before)] == [
        2 * steps + 2 * evals, 2 * steps, 0]
    tr.fused_epoch = False            # a sync after every step: same counts
    before = [f.launches for f in fns]
    tr.train_epoch()
    assert len(tr.step_ms) == steps and np.isfinite(tr.step_losses).all()
    assert [f.launches - b for f, b in zip(fns, before)] == [
        2 * steps, 2 * steps, 0]
