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
from sgnn_tpu_torch.nn.functional import nll_loss_masked
from sgnn_tpu_torch.ops import aggregate as agg
from sgnn_tpu_torch.ops.cuda import gather_agg as k1
from sgnn_tpu_torch.ops.cuda.gat import gat_aggregate_cuda
from sgnn_tpu_torch.ops.cuda.gat_bwd import gat_bwd_dst_cuda, gat_bwd_src_cuda
from sgnn_tpu_torch.ops.cuda.spmm import spmm_csr_bwd_cuda, spmm_csr_cuda
from sgnn_tpu_torch.ops.gat import (
    gat_aggregate, gat_aggregate_plain, gat_bwd_dst, gat_bwd_dst_plain,
    gat_bwd_src, gat_bwd_src_plain,
)
from sgnn_tpu_torch.ops.segment import (
    LONG_ROW_EDGES, csr_from_numpy, csr_transpose, spmm_csr, spmm_csr_bwd,
    spmm_csr_plain,
)
from sgnn_tpu_torch.sampler.host import HostSampler
from sgnn_tpu_torch.train import build_trainer
from sgnn_tpu_torch.train.fullbatch import FullBatchTrainer
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
    # the plain version's unrounded f32 sum of the same values: f32 differs
    # by reassociation only (index_add_ on the card uses atomics); bf16 by
    # the kernel's one rounding, at most 2^-8 of an element — the repo's
    # bf16 kernel bound (tests/test_mxu_spmm.py:57).  (Against the plain
    # version's own bf16 result two roundings of differently ordered sums
    # can land one ulp, up to 2^-7, apart.)
    ref = spmm_csr_plain(xd.float(), *csr)
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
    # against the plain versions' unrounded f32 sums of the same values
    # (as test_kernel_matches_plain): f32 differs by summation order only
    # (dx by atomics); bf16 by the kernel's one rounding, at most 2^-8
    assert _rel(out, agg.gather_aggregate_plain(x.float(), nbr, w)) <= tol
    assert _rel(dx, agg.gather_agg_bwd_dx_plain(g, nbr, w, s,
                                                 torch.float32)) <= tol
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


@pytest.mark.parametrize("family", ["gcn", "sage", "gat"])
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


# ------------------------------------------------------------------- K3 ----
def _gat_inputs(rng, v_dst, v_src, e, feat, heads, zero_rows):
    """A skewed dst-sorted CSR (hub rows, `zero_rows` with no edges) and
    score tables of spread 2, with every 97th source row's half raised by
    80 so that its scores pass +60 (the clip).  (A spread of 25 on every
    edge would make the f32 sums' own rounding in the hub rows approach
    the 1e-5 bound: chip_smoke.py's K3_SCORE_STD.)"""
    dst = (rng.zipf(1.5, e) % v_dst).astype(np.int32)
    dst = np.sort(dst[~np.isin(dst, zero_rows)], kind="stable")
    col = rng.integers(0, v_src, dst.size).astype(np.int32)
    rowptr = np.zeros(v_dst + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=v_dst), out=rowptr[1:])
    ht = rng.standard_normal((v_src, feat)).astype(np.float32)
    ts = (rng.standard_normal((v_src, heads)) * 2.0).astype(np.float32)
    ts[::97] += 80.0
    td = (rng.standard_normal((v_dst, heads)) * 2.0).astype(np.float32)
    return [torch.from_numpy(a) for a in (ht, ts, td, rowptr, col)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("heads,feat", [(1, 41), (4, 128), (8, 64),
                                        (16, 256)])
def test_gat_kernel_matches_plain(cuda_device, dtype, tol, heads, feat):
    rng = np.random.default_rng(heads * 1000 + feat)
    ht, ts, td, rowptr, col = (t.to(cuda_device) for t in _gat_inputs(
        rng, 3001, 2500, 60000, feat, heads, zero_rows=[1, 2]))
    assert bool(((ts[col.long()] + td.repeat_interleave(
        rowptr.diff(), dim=0)) > 60).any())   # the clip is exercised
    ht = ht.to(dtype)
    before = gat_aggregate_cuda.launches
    h, z = gat_aggregate(ht, ts, td, rowptr, col, heads)
    torch.cuda.synchronize()
    assert gat_aggregate_cuda.launches == before + 1
    assert h.dtype == dtype and h.shape == (3001, feat)
    assert z.dtype == torch.float32 and z.shape == (3001, heads)
    ref_h, ref_z = gat_aggregate_plain(ht.float(), ts, td, rowptr, col,
                                       heads)
    # against the plain version's unrounded f32 result of the same values:
    # f32 differs by reassociation and expf's last bit (index_add_ on the
    # card uses atomics); bf16 by the kernel's one rounding, at most 2^-8
    assert _rel(h, ref_h) <= tol
    # z elementwise (clipped rows' z dwarf the rest): f32 sums of positive
    # terms in two orders
    assert ((z - ref_z).abs() / ref_z.clamp_min(1e-30)).max().item() <= 1e-5
    assert bool((h[[1, 2]] == 0).all()) and bool((z[[1, 2]] == 0).all())
    again = gat_aggregate(ht, ts, td, rowptr, col, heads)
    assert torch.equal(h, again[0]) and torch.equal(z, again[1])


def test_gat_kernel_rejects_bad_args(cuda_device):
    ht = torch.ones(4, 8, device=cuda_device)
    ts = torch.zeros(4, 2, device=cuda_device)
    td = torch.zeros(2, 2, device=cuda_device)
    rowptr = torch.tensor([0, 1, 2], device=cuda_device)
    col = torch.tensor([0, 3], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="ts is on cpu"):
        gat_aggregate_cuda(ht, ts.cpu(), td, rowptr, col, 2)
    with pytest.raises(ValueError, match="ht must be"):
        gat_aggregate_cuda(ht.half(), ts, td, rowptr, col, 2)
    with pytest.raises(ValueError, match="td must be"):
        gat_aggregate_cuda(ht, ts, td.double(), rowptr, col, 2)
    with pytest.raises(ValueError, match="heads=3"):
        gat_aggregate_cuda(ht, ts, td, rowptr, col, 3)


@pytest.mark.parametrize("heads", [1, 4])
def test_gat_server_on_card_matches_cpu(cuda_device, heads):
    ds = random_graph_dataset(500, 8, 32, 5, seed=7)
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    p = init_model(4, "gat", [32, 16, 5], device="cpu")
    gen = torch.Generator().manual_seed(1)
    p = p._replace(attn=tuple(torch.randn(a.shape, generator=gen)
                              for a in p.attn))
    cpu = InferenceServer(p, "gat", adj, ds.features, heads=heads,
                          device="cpu")
    gpu = InferenceServer(p, "gat", adj, ds.features, heads=heads,
                          device=cuda_device)
    counts = (gat_aggregate_cuda.launches, spmm_csr_cuda.launches)
    np.testing.assert_allclose(gpu.logprobs(), cpu.logprobs(), **F32)
    assert (gat_aggregate_cuda.launches, spmm_csr_cuda.launches) == (
        counts[0] + 2, counts[1])
    nids = np.array([0, 9, 9, 400])
    np.testing.assert_allclose(gpu.query(nids), cpu.query(nids), **F32)
    np.testing.assert_allclose(gpu.query(nids, fanout=3, seed=1),
                               cpu.query(nids, fanout=3, seed=1), **F32)


def test_gat_device_trainer_epoch(cuda_device):
    """GATSAMPLEALLGPU on the card: finite losses, and neither K1 nor K3
    launched (sampled GAT aggregates with torch ops)."""
    ds = random_graph_dataset(3000, 10, 48, 5, seed=4)
    cfg = RunConfig(algorithm="GATSAMPLEALLGPU", layer_sizes=[48, 16, 5],
                    fanout=[5, 3], batch_size=256, drop_rate=0.5, heads=4,
                    vertices=ds.num_vertices)
    tr = build_trainer(cfg, ds, device=cuda_device)
    fns = (k1.gather_agg_fwd_cuda, k1.gather_agg_bwd_dx_cuda,
           k1.gather_agg_bwd_dw_cuda, gat_aggregate_cuda)
    before = [f.launches for f in fns]
    loss, acc, edges = tr.train_epoch()
    acc_val = tr.evaluate(tr.val_nids)
    assert np.isfinite(tr.step_losses).all() and edges > 0
    assert 0.0 <= acc <= 1.0 and 0.0 <= acc_val <= 1.0
    assert [f.launches for f in fns] == before


# --------------------------------------------------- whole-graph training --
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("feat", [7, 41, 128, 256])
def test_spmm_bwd_kernel_matches_plain(cuda_device, dtype, tol, feat):
    """K2's backward: the kernel over the transposed CSR, under its own
    launch count, against the plain version's unrounded f32 sum."""
    rng = np.random.default_rng(feat + 1)
    v = 3000
    rowptr, col, w = _skewed_csr(rng, v, 60000, zero_rows=[1, 2])
    col[::20] = 5      # a hub source: a transposed row split across warps
    csr_t = csr_from_numpy(*csr_transpose(rowptr, col, w, v), v,
                           device=cuda_device)
    assert int(csr_t.rowptr.diff().max()) > LONG_ROW_EDGES
    g = torch.from_numpy(rng.standard_normal((v, feat)).astype(
        np.float32)).to(cuda_device, dtype)
    before = (spmm_csr_cuda.launches, spmm_csr_bwd_cuda.launches)
    dx = spmm_csr_bwd(g, *csr_t)
    torch.cuda.synchronize()
    assert (spmm_csr_cuda.launches, spmm_csr_bwd_cuda.launches) == (
        before[0], before[1] + 1)
    assert dx.dtype == dtype and dx.shape == (v, feat)
    assert _rel(dx, spmm_csr_plain(g.float(), *csr_t)) <= tol
    assert torch.equal(dx, spmm_csr_bwd(g, *csr_t))   # deterministic


# K4's tables against the plain versions, as chip_smoke.py's kernel_k4
# phase holds them (its K4_TABLE_TOL says why they could need more)
K4_TABLE_TOL = 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("heads,feat", [(1, 41), (4, 128), (2, 48), (3, 30),
                                        (16, 256)])
def test_gat_bwd_kernels_match_plain(cuda_device, dtype, tol, heads, feat):
    """B1 and B2 against their plain versions on the same CUDA tensors:
    skewed rows, a hub source (a B1 row split across warps), rows with no
    edges, clipped scores; (2, 48) and (3, 30) put heads off the lane
    groups (one head per tile)."""
    rng = np.random.default_rng(heads * 1000 + feat + 7)
    ht, ts, td, rowptr, col = (t.to(cuda_device) for t in _gat_inputs(
        rng, 2500, 2500, 60000, feat, heads, zero_rows=[1, 2]))
    col[::20] = 5
    ht = ht.to(dtype)
    gz = torch.from_numpy(rng.standard_normal((2500, feat)).astype(
        np.float32)).to(cuda_device)
    rz = torch.from_numpy(rng.standard_normal((2500, heads)).astype(
        np.float32)).to(cuda_device)
    rowptr_t, col_t, _ = (torch.from_numpy(a).to(cuda_device) for a in
                          csr_transpose(rowptr.cpu().numpy(),
                                        col.cpu().numpy(),
                                        np.ones(col.numel(), np.float32),
                                        2500))
    before = (gat_bwd_src_cuda.launches, gat_bwd_dst_cuda.launches)
    dht, dts = gat_bwd_src(ht, ts, gz, td, rz, rowptr_t, col_t, heads)
    dtd = gat_bwd_dst(ht, ts, gz, td, rz, rowptr, col, heads)
    torch.cuda.synchronize()
    assert (gat_bwd_src_cuda.launches, gat_bwd_dst_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    assert int(rowptr_t.diff().max()) > LONG_ROW_EDGES
    ref_ht = ht.float()
    ref_dht, ref_dts = gat_bwd_src_plain(ref_ht, ts, gz, td, rz, rowptr_t,
                                         col_t, heads)
    ref_dtd = gat_bwd_dst_plain(ref_ht, ts, gz, td, rz, rowptr, col, heads)
    assert _rel(dht, ref_dht) <= 1e-5
    assert _rel(dts, ref_dts) <= K4_TABLE_TOL
    assert _rel(dtd, ref_dtd) <= K4_TABLE_TOL
    assert bool((dtd[[1, 2]] == 0).all())      # rows with no in-edges
    again = gat_bwd_src(ht, ts, gz, td, rz, rowptr_t, col_t, heads)
    assert torch.equal(dht, again[0]) and torch.equal(dts, again[1])
    assert torch.equal(dtd, gat_bwd_dst(ht, ts, gz, td, rz, rowptr, col,
                                        heads))


@pytest.mark.parametrize("family,aggregator,heads", [
    ("gcn", "sum", 1), ("sage", "sum", 1), ("gat", "sum", 4),
    ("gcn", "max", 1)])
def test_fullbatch_trainer_card_vs_cpu(cuda_device, family, aggregator,
                                       heads):
    """One whole-graph epoch's loss and gradients, card against CPU from
    the same parameters (drop 0, TF32 off), and the launches of an epoch
    with METRICS:clean at drop 0.5: GCN/SAGE 4 SpMM forward + 2 backward,
    GAT 4 K3 + 2 B1 + 2 B2, min/max none."""
    ds = random_graph_dataset(2000, 10, 48, 5, seed=3)
    cfg = RunConfig(layer_sizes=[48, 16, 5], drop_rate=0.0, heads=heads,
                    aggregator=aggregator, vertices=ds.num_vertices)
    trs = [FullBatchTrainer(cfg, ds, family=family, device=dev)
           for dev in ("cpu", cuda_device)]
    gen = torch.Generator().manual_seed(1)
    p = trs[0].params._replace(attn=tuple(
        torch.randn(a.shape, generator=gen) for a in trs[0].params.attn))
    outs = []
    for tr in trs:
        leaves = [t.detach().to(tr.device).requires_grad_()
                  for t in p.leaves()]
        logp = tr.forward(p.replace_leaves(leaves), train=True)
        loss = nll_loss_masked(logp, tr.y, tr.masks[0])
        loss.backward()
        outs.append((loss.item(), [t.grad.cpu() for t in leaves]))
    assert abs(outs[0][0] - outs[1][0]) <= 1e-5
    for a, b in zip(outs[0][1], outs[1][1]):
        assert _rel(b, a) <= 1e-4
    fns = (spmm_csr_cuda, spmm_csr_bwd_cuda, gat_aggregate_cuda,
           gat_bwd_src_cuda, gat_bwd_dst_cuda)
    tr = FullBatchTrainer(RunConfig(layer_sizes=[48, 16, 5], drop_rate=0.5,
                                    heads=heads, aggregator=aggregator,
                                    vertices=ds.num_vertices),
                          ds, family=family, device=cuda_device)
    before = [f.launches for f in fns]
    loss, *accs = tr.train_epoch()
    assert np.isfinite(loss) and all(0.0 <= a <= 1.0 for a in accs)
    want = {"gat": [0, 0, 4, 2, 2]}.get(
        family, [4, 2, 0, 0, 0] if aggregator == "sum" else [0] * 5)
    assert [f.launches - b for f, b in zip(fns, before)] == want
    before = [f.launches for f in fns]
    tr.predict()
    assert [f.launches - b for f, b in zip(fns, before)] == [
        w // 2 if i in (0, 2) else 0 for i, w in enumerate(want)]
