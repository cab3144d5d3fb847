"""Card-only tests of the port's CUDA kernels, serving and training paths.

Every test here carries the `cuda` marker and skips without a card.  The
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda -q

(`--noconftest` skips tests/conftest.py, which imports JAX.)  The kernel is
held to its plain PyTorch version on the same CUDA tensors, and the server
on the card to the same server on the CPU.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from _rank_scatter import (
    assert_same_blocks, both_ways, rank_scatter_source_set,
)

from sgnn_tpu_torch.config import RunConfig
from sgnn_tpu_torch.data.synthetic import random_graph_dataset
from sgnn_tpu_torch.graph.adjacency import Adjacency
from sgnn_tpu_torch.models.gnn import init_model
from sgnn_tpu_torch.nn.functional import nll_loss_masked
from sgnn_tpu_torch.ops import aggregate as agg
from sgnn_tpu_torch.ops import probes as pr
from sgnn_tpu_torch.ops.cuda import gather_agg as k1
from sgnn_tpu_torch.ops.cuda import probes as prc
from sgnn_tpu_torch.ops.cuda import gat_sampled as gs
from sgnn_tpu_torch.ops.cuda.gat import gat_aggregate_cuda, vector_columns
from sgnn_tpu_torch.ops.cuda.gat_bwd import (
    dst_layout, gat_bwd_dst_cuda, gat_bwd_src_cuda,
)
from sgnn_tpu_torch.ops.cuda.spmm import (
    forward_layout, rows_fit_a_warp, spmm_csr_bwd_cuda, spmm_csr_cuda,
)
from sgnn_tpu_torch.ops.gat import (
    gat_aggregate, gat_aggregate_plain, gat_bwd_dst, gat_bwd_dst_plain,
    gat_bwd_operands, gat_bwd_src, gat_bwd_src_plain,
)
from sgnn_tpu_torch.ops.segment import (
    CSR_CHUNK_MIN, LONG_ROW_EDGES, csr_chunk_edges, csr_from_numpy,
    csr_transpose, spmm_csr, spmm_csr_bwd, spmm_csr_plain,
)
from sgnn_tpu_torch.sampler import device as device_sampler
from sgnn_tpu_torch.sampler.blocks import WeightKind
from sgnn_tpu_torch.sampler.host import HostSampler
from sgnn_tpu_torch.train import build_trainer
from sgnn_tpu_torch.train.fullbatch import FullBatchTrainer
from sgnn_tpu_torch.train.inference import InferenceServer
from sgnn_tpu_torch.train.trainer import host_batch_to_device, loss_and_grads
from sgnn_tpu_torch.utils import timing
from sgnn_tpu_torch.utils.timing import cuda_graph_ms

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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("feat", [7, 41, 128, 256])
def test_forward_row_kernel_matches_plain(cuda_device, dtype, tol, feat):
    """A CSR whose every row fits one warp takes the forward's row kernel
    (`rows_fit_a_warp`); held to the plain version as above."""
    rng = np.random.default_rng(feat + 3)
    v = 3000
    dst = np.sort(rng.integers(0, v, 60000)).astype(np.int32)
    dst = dst[~np.isin(dst, [1, 2])]
    rowptr = np.zeros(v + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=v), out=rowptr[1:])
    col = rng.integers(0, v, dst.size).astype(np.int32)
    w = rng.standard_normal(dst.size).astype(np.float32)
    csr = csr_from_numpy(rowptr, col, w, v, device=cuda_device)
    assert rows_fit_a_warp(csr.rowptr)
    x = torch.from_numpy(rng.standard_normal((v, feat)).astype(
        np.float32)).to(cuda_device, dtype)
    before = spmm_csr_cuda.launches
    out = spmm_csr(x, *csr)
    torch.cuda.synchronize()
    assert spmm_csr_cuda.launches == before + 1 and out.dtype == dtype
    assert _rel(out, spmm_csr_plain(x.float(), *csr)) <= tol
    assert bool((out[[1, 2]] == 0).all())
    assert torch.equal(out, spmm_csr(x, *csr))


# rows of these lengths reach every tail of a 32-edge window, of the four
# rows in flight and of the half-warps' alternate edges
ROW_LENGTHS = (0, 1, 31, 32, 33, 1000)


def _row_tail_csr(rng, v_src):
    """A CSR with rows of each of ROW_LENGTHS edges (4 each) and 60 rows of
    2-199, in random order: (lengths, rowptr, col)."""
    deg = np.concatenate([np.repeat(ROW_LENGTHS, 4), rng.integers(2, 200, 60)])
    deg = deg[rng.permutation(deg.size)]
    rowptr = np.zeros(deg.size + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    return deg, rowptr, rng.integers(0, v_src, rowptr[-1]).astype(np.int32)


def _placed(a, dtype, device, aligned):
    """a as a contiguous tensor of `dtype` on `device`, 16-byte aligned or
    a view one element past an aligned address."""
    flat = torch.from_numpy(np.append(a.ravel(), np.float32(0))).to(
        device, dtype)
    return (flat[:-1] if aligned else flat[1:]).view(a.shape)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("feat", [7, 41, 64, 128, 256, 602])
def test_forward_row_kernel_rows_and_layouts(cuda_device, aligned, dtype,
                                             tol, feat):
    """K2's row kernel on rows of 0, 1, 31, 32, 33 and 1000 edges: vector
    columns (4 a load) where F % 4 == 0 and x is aligned, else scalar;
    half-warps on alternate edges for F <= 64; held to the plain version's
    unrounded f32 sum, rows with no edges zero, bit-identical on repeat."""
    rng = np.random.default_rng(feat * 5 + aligned)
    deg, rowptr, col = _row_tail_csr(rng, 1500)
    csr = csr_from_numpy(rowptr, col,
                         rng.standard_normal(col.size).astype(np.float32),
                         1500, device=cuda_device)
    assert rows_fit_a_warp(csr.rowptr)
    x = _placed(rng.standard_normal((1500, feat)).astype(np.float32), dtype,
                cuda_device, aligned)
    layout = forward_layout(x)
    assert layout["vec"] == (4 if feat % 4 == 0 and aligned else 1)
    assert layout["lanes"] == (16 if feat <= 64 else 32)
    assert 16 * layout["cols"] * layout["vec"] >= min(feat, 64)
    assert 0 < layout["registers"] <= 48     # the cap: 5 blocks an SM
    before = spmm_csr_cuda.launches
    out = spmm_csr_cuda(x, *csr)
    again = spmm_csr_cuda(x, *csr)
    torch.cuda.synchronize()
    assert spmm_csr_cuda.launches == before + 2
    assert out.dtype == dtype and out.shape == (deg.size, feat)
    assert _rel(out, spmm_csr_plain(x.float(), *csr)) <= tol
    empty = torch.from_numpy(np.flatnonzero(deg == 0)).to(cuda_device)
    assert bool((out[empty] == 0).all())
    assert torch.equal(out, again)


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
    # (as test_kernel_matches_plain): f32 differs by summation order only;
    # bf16 by the kernel's one rounding, at most 2^-8
    assert _rel(out, agg.gather_aggregate_plain(x.float(), nbr, w)) <= tol
    assert _rel(dx, agg.gather_agg_bwd_dx_plain(g, nbr, w, s,
                                                 torch.float32)) <= tol
    assert _rel(dw, agg.gather_agg_bwd_dw_plain(g, x, nbr)) <= tol
    assert torch.equal(out, agg.gather_agg_fwd(x, nbr, w))  # deterministic
    assert torch.equal(dx, agg.gather_agg_bwd_dx(g, nbr, w, x))
    assert torch.equal(dw, agg.gather_agg_bwd_dw(g, x, nbr))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("feat,k", [(7, 25), (41, 10), (64, 3), (128, 40),
                                    (602, 17)])
def test_dw_layouts_match_plain(cuda_device, dtype, tol, feat, k):
    # every lane count, both column paths (g and x aligned or one element
    # off), 8 / 16 / 32 partial sums a row, K > 32 in two passes and runs
    # of repeated sources
    rng = np.random.default_rng(7 * feat + k)
    d, s = 333, 500
    x, nbr, _, g = _block(rng, d, k, s, feat, hubs=(9,))
    nbr[::3, k // 2:] = 0     # the sampler's padding: runs of one source
    nbr[7] = 4
    nbr = nbr.to(cuda_device)
    want = {7: 8, 41: 16, 64: 32, 128: 32, 602: 32}[feat]  # scalar
    for aligned in (True, False):
        xs, gs = (_placed(t.numpy(), dtype, cuda_device, aligned)
                  for t in (x, g))
        lay = k1.dw_layout(gs, xs, k)
        vec = 4 if aligned and feat % 4 == 0 else 1
        assert (lay["vec"], lay["slots"]) == (vec, 8 if k <= 8 else
                                              16 if k <= 16 else 32)
        assert lay["registers"] > 0
        if vec == 1:
            assert lay["lanes"] == want
        dw = k1.gather_agg_bwd_dw_cuda(gs, xs, nbr)
        assert _rel(dw, agg.gather_agg_bwd_dw_plain(gs, xs, nbr)) <= tol
        assert torch.equal(dw, k1.gather_agg_bwd_dw_cuda(gs, xs, nbr))


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
    transposes = k1.block_transpose_cuda.launches
    loss, acc, edges = tr.train_epoch()
    acc_val = tr.evaluate(tr.val_nids)
    steps = len(tr.step_ms)
    evals = -(-tr.val_nids.size // cfg.batch_size)
    assert np.isfinite(tr.step_losses).all() and edges > 0
    assert 0.0 <= acc <= 1.0 and 0.0 <= acc_val <= 1.0
    assert [f.launches - b for f, b in zip(fns, before)] == [
        2 * steps + 2 * evals, 2 * steps, 0]
    assert k1.block_transpose_cuda.launches - transposes == 2 * steps
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("heads,feat,aligned,vector", [
    (1, 7, True, False), (1, 41, True, False), (1, 128, True, True),
    (1, 128, False, False), (4, 128, True, True), (2, 256, True, True),
    (16, 256, True, True), (3, 30, True, False)])
def test_gat_kernel_row_tails_and_columns(cuda_device, dtype, tol, heads,
                                          feat, aligned, vector):
    """K3 on rows of every length 0-33 (each tail of the kUnroll rows in
    flight and of a 32-edge window) and a few of 40-200, with vector
    columns (4 a lane) where F and the head are multiples of 4 and ht is
    aligned, else scalar ones; H=16 at F=256 spans two column tiles; held
    to the plain version's unrounded f32 result, bit-identical on repeat,
    rows with no edges zero."""
    rng = np.random.default_rng(feat * 7 + heads + aligned)
    deg = np.concatenate([np.tile(np.arange(34), 20),
                          rng.integers(40, 200, 30)])
    deg = deg[rng.permutation(deg.size)]
    v_src = 1500
    rowptr = np.zeros(deg.size + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    col = rng.integers(0, v_src, rowptr[-1]).astype(np.int32)
    ts = (rng.standard_normal((v_src, heads)) * 2.0).astype(np.float32)
    ts[::97] += 80.0                        # past the +60 clip
    td = (rng.standard_normal((deg.size, heads)) * 2.0).astype(np.float32)
    flat = torch.from_numpy(rng.standard_normal(v_src * feat + 1).astype(
        np.float32)).to(cuda_device, dtype)
    # a view one element in: contiguous, but not 16-byte aligned
    ht = flat[:-1].view(v_src, feat) if aligned else flat[1:].view(v_src,
                                                                   feat)
    args = [ht] + [torch.from_numpy(a).to(cuda_device)
                   for a in (ts, td, rowptr, col)] + [heads]
    assert vector_columns(ht, heads) == vector
    h, z = gat_aggregate_cuda(*args)
    again = gat_aggregate_cuda(*args)
    torch.cuda.synchronize()
    ref_h, ref_z = gat_aggregate_plain(ht.float(), *args[1:])
    assert h.dtype == dtype and h.shape == (deg.size, feat)
    assert _rel(h, ref_h) <= tol
    assert ((z - ref_z).abs() / ref_z.clamp_min(1e-30)).max().item() <= 1e-5
    empty = torch.from_numpy(np.flatnonzero(deg == 0)).to(cuda_device)
    assert bool((h[empty] == 0).all()) and bool((z[empty] == 0).all())
    assert torch.equal(h, again[0]) and torch.equal(z, again[1])


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
    """GATSAMPLEALLGPU on the card: finite losses, neither K1 nor K3
    launched, and the sampled GAT kernels taken by every layer: a forward
    per layer of each step and eval batch, a backward per layer of each
    step."""
    ds = random_graph_dataset(3000, 10, 48, 5, seed=4)
    cfg = RunConfig(algorithm="GATSAMPLEALLGPU", layer_sizes=[48, 16, 5],
                    fanout=[5, 3], batch_size=256, drop_rate=0.5, heads=4,
                    vertices=ds.num_vertices)
    tr = build_trainer(cfg, ds, device=cuda_device)
    fns = (k1.gather_agg_fwd_cuda, k1.gather_agg_bwd_dx_cuda,
           k1.gather_agg_bwd_dw_cuda, k1.block_transpose_cuda,
           gat_aggregate_cuda)
    before = [f.launches for f in fns]
    ours = [gs.gat_sampled_fwd_cuda.launches, gs.gat_sampled_bwd_cuda.launches]
    loss, acc, edges = tr.train_epoch()
    acc_val = tr.evaluate(tr.val_nids)
    steps = len(tr.step_ms)
    evals = -(-tr.val_nids.size // cfg.batch_size)
    assert np.isfinite(tr.step_losses).all() and edges > 0
    assert 0.0 <= acc <= 1.0 and 0.0 <= acc_val <= 1.0
    assert [f.launches for f in fns] == before
    assert [gs.gat_sampled_fwd_cuda.launches - ours[0],
            gs.gat_sampled_bwd_cuda.launches - ours[1]] == [
        2 * (steps + evals), 2 * steps]


# ---------------------------------------- sampled GAT (gat_sampled.cu) ----
def _batch_to(batch, device):
    """A SampledBatch with every tensor moved to `device`."""
    def move(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if hasattr(getattr(obj, f.name), "to")})
    return dataclasses.replace(move(batch),
                               blocks=[move(b) for b in batch.blocks])


def _gat_sampled_inputs(rng, d, k, s, feat, heads, hub=None):
    """A sampled GAT block: 30% padded slots (pointing at row 0, as the
    sampler's), every 7th row with no valid slot, `hub` (if given) taking
    half the slots, seeds drawn with repeats; h, G and score tables of a
    size that spreads the attention."""
    nbr = rng.integers(0, s, (d, k)).astype(np.int32)
    if hub is not None:
        nbr[rng.random((d, k)) < 0.5] = hub
    w = rng.random((d, k)).astype(np.float32) + 0.5
    w[rng.random((d, k)) < 0.3] = 0.0
    w[::7] = 0.0
    nbr[w == 0] = 0
    seed = rng.integers(0, s, d).astype(np.int32)
    h = rng.standard_normal((s, feat)).astype(np.float32)
    g = rng.standard_normal((d, feat)).astype(np.float32)
    ts = (2 * rng.standard_normal((s, heads))).astype(np.float32)
    td = (2 * rng.standard_normal((s, heads))).astype(np.float32)
    return [torch.from_numpy(a) for a in (h, ts, td, nbr, w, seed, g)]


def _gat_sampled_check(dev, dtype, tol, d, k, s, feat, heads, hub=None,
                       seed=0, own=False):
    """The forward and backward kernels against their plain versions on the
    same values in f64 (the rows rounded to `dtype` first): f32 differs by
    its own rounding, bf16 by the kernel's one rounding of out and dh;
    bit-identical on repeat, each wrapper launched once a call.  `own`:
    the block under the self-loop rule (`own_row_slots`, every 7th row a
    padded destination)."""
    from sgnn_tpu_torch.ops import gat_sampled as op

    rng = np.random.default_rng(seed)
    h, ts, td, nbr, w, sd, g = (t.to(dev) for t in _gat_sampled_inputs(
        rng, d, k, s, feat, heads, hub))
    if own:
        valid = torch.ones(d, dtype=torch.bool, device=dev)
        valid[::7] = False
        nbr, w = op.own_row_slots(nbr, w, sd, valid)
    h, g = h.to(dtype), g.to(dtype)
    counts = [gs.gat_sampled_fwd_cuda.launches,
              gs.gat_sampled_bwd_cuda.launches]
    out, att = op.gat_sampled_fwd(h, ts, td, nbr, w, sd, heads)
    grads = op.gat_sampled_bwd(g, h, ts, td, nbr, w, sd, att, heads)
    torch.cuda.synchronize()
    assert [gs.gat_sampled_fwd_cuda.launches,
            gs.gat_sampled_bwd_cuda.launches] == [c + 1 for c in counts]
    assert out.dtype == grads[0].dtype == dtype
    h64, ts64, td64 = h.double(), ts.double(), td.double()
    ref_out, ref_att = op.gat_sampled_fwd_plain(h64, ts64, td64, nbr, w, sd,
                                                heads)
    ref = op.gat_sampled_bwd_plain(g.double(), h64, ts64, td64, nbr, w, sd,
                                   ref_att, heads)
    errs = [_rel(out, ref_out), _rel(att, ref_att),
            *(_rel(a, b) for a, b in zip(grads, ref))]
    assert max(errs) <= tol, errs
    assert torch.equal(att[::7], torch.zeros_like(att[::7]))
    again = op.gat_sampled_fwd(h, ts, td, nbr, w, sd, heads)
    assert torch.equal(out, again[0]) and torch.equal(att, again[1])
    for a, b in zip(grads,
                    op.gat_sampled_bwd(g, h, ts, td, nbr, w, sd, att, heads)):
        assert torch.equal(a, b)
    return errs


# (heads, F, K): the cell's two layers' widths; K past 32 (slots in two
# chunks); a power-of-two head of lanes (8, 64) and heads reduced over the
# whole group (3, 30); column tiles in both modes (16 heads of 64 and 2 of
# 512 over F = 1024); scalar columns at F = 7
GAT_SAMPLED_CASES = [(4, 128, 10), (1, 41, 25), (8, 64, 40), (3, 30, 5),
                     (16, 1024, 3), (2, 1024, 4), (1, 7, 33)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("heads,feat,k", GAT_SAMPLED_CASES)
def test_gat_sampled_kernels_match_plain(cuda_device, dtype, tol, heads,
                                         feat, k):
    _gat_sampled_check(cuda_device, dtype, tol, 1001, k, 700, feat, heads,
                       hub=5, seed=heads * feat + k)
    lay = gs.row_layout(torch.empty(1, feat, device=cuda_device, dtype=dtype),
                        torch.empty(1, feat, device=cuda_device, dtype=dtype),
                        heads)
    assert lay["vec"] == (4 if feat % 4 == 0 and (feat // heads) % 4 == 0
                          else 1)
    assert lay["lanes"] in (8, 16, 32) and lay["registers"] > 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("d,k,feat,heads", [(233_088, 10, 128, 4),
                                            (10_112, 25, 41, 1)])
def test_gat_sampled_kernels_at_the_cells_shapes(cuda_device, dtype, tol, d,
                                                 k, feat, heads):
    """The sampled GAT cell's two layers (602-128-41, 4 heads, fanout
    25-10, batch 10,000): D, K, F and H as the device sampler pads them,
    S the Reddit-shaped graph's 233,088 padded rows, a hub source.  A
    forward and backward hold less scratch beside their outputs than one
    [D, K, F] edge tensor of the torch ops."""
    from sgnn_tpu_torch.ops import gat_sampled as op

    s = 233_088
    h, ts, td, nbr, w, sd, g = (t.to(cuda_device) for t in
                                _gat_sampled_inputs(np.random.default_rng(3),
                                                    d, k, s, feat, heads))
    h, g = h.to(dtype), g.to(dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    out, att = op.gat_sampled_fwd(h, ts, td, nbr, w, sd, heads)
    grads = op.gat_sampled_bwd(g, h, ts, td, nbr, w, sd, att, heads)
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for t in (out, att, *grads))
    edge_tensor = d * k * feat * h.element_size()
    assert torch.cuda.max_memory_allocated(cuda_device) - base < (
        held + edge_tensor)
    del h, ts, td, nbr, w, sd, g, out, att, grads
    _gat_sampled_check(cuda_device, dtype, tol, d, k, s, feat, heads,
                       hub=17)


@pytest.mark.parametrize("own", [False, True], ids=["sampled", "own_row"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("heads,feat", [(4, 512), (4, 188)])
def test_gat_sampled_kernels_pyg_widths(cuda_device, dtype, tol, heads, feat,
                                        own):
    """The pyg GAT's layers: heads of 128 (F = 512, vector columns, two
    column tiles) and 4 heads of 47 (F = 188, scalar columns, a head across
    a tile), with and without the own-row slot, against the plain
    versions; bit-identical on repeat."""
    _gat_sampled_check(cuda_device, dtype, tol, 1001, 10, 700, feat, heads,
                       hub=5, seed=feat, own=own)
    lay = gs.row_layout(torch.empty(1, feat, device=cuda_device, dtype=dtype),
                        torch.empty(1, feat, device=cuda_device, dtype=dtype),
                        heads)
    assert lay["vec"] == (4 if feat == 512 else 1)


@pytest.mark.parametrize("d,s,feat", [(61_952, 681_472, 512),
                                      (5_632, 61_952, 512), (512, 5_632, 188)])
def test_gat_sampled_kernels_at_the_products_shapes(cuda_device, d, s, feat):
    """The gat_products cell's three layers (100-4x128-4x128-4x47, fan-out
    10-10-10, batch 512): D and S as the device sampler pads them, K = 10
    sampled slots and the own row's, f32."""
    _gat_sampled_check(cuda_device, torch.float32, 1e-5, d, 10, s, feat, 4,
                       hub=17, own=True)


def test_pyg_gat_step_card_vs_cpu(cuda_device):
    """One gat_variant "pyg" GATSAMPLEALLGPU batch sampled on the card, with
    sampled self-loops: loss and the 15 leaves' gradients through the
    kernels against the CPU's plain versions on the same blocks and
    weights (no dropout drawn), and per step 3 layers through the kernel
    pair."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = random_graph_dataset(3000, 10, 48, 5, seed=4)
    cfg = RunConfig(algorithm="GATSAMPLEALLGPU", layer_sizes=[48, 32, 32, 5],
                    fanout=[5, 4, 3], batch_size=256, heads=4,
                    gat_variant="pyg", vertices=ds.num_vertices)
    tr = build_trainer(cfg, ds, device=cuda_device)
    gen = torch.Generator().manual_seed(2)
    p = tr.params.replace_leaves([
        (torch.rand(t.shape, generator=gen) - 0.5).to(cuda_device)
        for t in tr.params.leaves()])
    batch = tr.sample(*next(tr._seed_batches(tr.train_nids, False)))
    launches = [gs.gat_sampled_fwd_cuda.launches,
                gs.gat_sampled_bwd_cuda.launches]
    card = loss_and_grads(p, "gat", batch, heads=4)
    assert [gs.gat_sampled_fwd_cuda.launches - launches[0],
            gs.gat_sampled_bwd_cuda.launches - launches[1]] == [3, 3]
    cpu = loss_and_grads(p.to("cpu"), "gat", _batch_to(batch, "cpu"),
                         heads=4)
    assert abs(card.loss.item() - cpu.loss.item()) <= 1e-5
    assert len(card.grads) == 15
    for a, b in zip(card.grads, cpu.grads):
        assert _rel(a.cpu(), b) <= 1e-4


def test_gat_sampled_kernels_reject_bad_args(cuda_device):
    from sgnn_tpu_torch.ops import gat_sampled as op

    h, ts, td, nbr, w, sd, g = (t.to(cuda_device) for t in
                                _gat_sampled_inputs(np.random.default_rng(1),
                                                    8, 3, 5, 8, 2))
    with pytest.raises(ValueError, match="td is on cpu"):
        op.gat_sampled_fwd(h, ts, td.cpu(), nbr, w, sd, 2)
    with pytest.raises(ValueError, match="h must be"):
        op.gat_sampled_fwd(h.double(), ts, td, nbr, w, sd, 2)
    with pytest.raises(ValueError, match="heads=3"):
        op.gat_sampled_fwd(h, ts, td, nbr, w, sd, 3)
    _, att = op.gat_sampled_fwd(h, ts, td, nbr, w, sd, 2)
    with pytest.raises(ValueError, match="g must be"):
        op.gat_sampled_bwd(g[:4], h, ts, td, nbr, w, sd, att, 2)


@pytest.mark.parametrize("heads", [1, 4])
def test_gat_sampled_step_card_vs_cpu(cuda_device, heads):
    """One GATSAMPLEALLGPU batch, sampled on the card: loss and gradients
    through the kernels against the CPU's plain versions on the same
    blocks and weights with nonzero attention vectors (f32, TF32 off;
    test_model_grads_card_vs_cpu's tolerances), and a forward launch for
    each of the 2 layers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = random_graph_dataset(3000, 10, 48, 5, seed=4)
    cfg = RunConfig(algorithm="GATSAMPLEALLGPU", layer_sizes=[48, 16, 5],
                    fanout=[5, 3], batch_size=256, heads=heads,
                    vertices=ds.num_vertices)
    tr = build_trainer(cfg, ds, device=cuda_device)
    gen = torch.Generator().manual_seed(2)
    p = tr.params._replace(attn=tuple(
        torch.randn(a.shape, generator=gen).to(cuda_device)
        for a in tr.params.attn))
    batch = tr.sample(*next(tr._seed_batches(tr.train_nids, False)))
    before = gs.gat_sampled_fwd_cuda.launches
    card = loss_and_grads(p, "gat", batch, heads=heads)
    assert gs.gat_sampled_fwd_cuda.launches - before == 2
    cpu = loss_and_grads(p.to("cpu"), "gat", _batch_to(batch, "cpu"),
                         heads=heads)
    assert abs(card.loss.item() - cpu.loss.item()) <= 1e-5
    for a, b in zip(card.grads, cpu.grads):
        assert _rel(a.cpu(), b) <= 1e-4


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


# ------------------------------------------ the CSR sum's chunk edges ----
def _chunk_edge_csr(rng, v_src, small):
    """Row lengths around the CSR sum's chunks (c = CSR_CHUNK_MIN, the
    chunk of a CSR this small, `csr_chunk_edges`): a row
    ending exactly at a chunk edge, rows with no edges there, a long row
    (3c + 5) then 40 empty rows inside a chunk that holds only those and
    two long rows' pieces, a long row starting mid-chunk (7c - 3), rows of
    c - 1, c + 1 and c edges, a hub of 40c + 11 edges, a last chunk cut
    short and trailing empty rows; `small`: E < one chunk."""
    c = CSR_CHUNK_MIN
    deg = ([3, 0, 2, 0] if small else
           [c, 0, 0, 3 * c + 5] + [0] * 40 + [7 * c - 3, 1, c - 1, c + 1, c]
           + list(rng.integers(0, 60, 300)) + [40 * c + 11]
           + list(rng.integers(0, 3, 200)) + [0] * 5)
    if sum(deg) % c == 0:
        deg[-6] += 1
    rowptr = np.zeros(len(deg) + 1, np.int64)
    rowptr[1:] = np.cumsum(deg)
    col = rng.integers(0, v_src, rowptr[-1]).astype(np.int32)
    w = rng.standard_normal(rowptr[-1]).astype(np.float32)
    return rowptr, col, w, np.asarray(deg)


@pytest.mark.parametrize("small", [False, True],
                         ids=["chunk_edges", "under_one_chunk"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("feat", [7, 41, 128, 256])
def test_csr_sum_chunk_edges_match_plain(cuda_device, small, dtype, tol,
                                         feat):
    """K2's backward at the chunk edges, and the forward on the same CSR
    (whose hub sends it to the same sum, csrc/csr_sum.cuh), against the
    plain version's unrounded f32 sum; bit-identical on repeat; rows with
    no edges zero; each wrapper counts its launches."""
    rng = np.random.default_rng(feat + 31 * small)
    rowptr, col, w, deg = _chunk_edge_csr(rng, 500, small)
    assert csr_chunk_edges(int(rowptr[-1])) == CSR_CHUNK_MIN
    assert small == (rowptr[-1] < CSR_CHUNK_MIN)
    assert small == rows_fit_a_warp(torch.from_numpy(rowptr))
    csr = csr_from_numpy(rowptr, col, w, 500, device=cuda_device)
    x = torch.from_numpy(rng.standard_normal((500, feat)).astype(
        np.float32)).to(cuda_device, dtype)
    ref = spmm_csr_plain(x.float(), *csr)
    empty = torch.from_numpy(np.flatnonzero(deg == 0)).to(cuda_device)
    for fn in (spmm_csr_cuda, spmm_csr_bwd_cuda):
        before = fn.launches
        out, again = fn(x, *csr), fn(x, *csr)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        assert out.dtype == dtype and out.shape == (deg.size, feat)
        assert _rel(out, ref) <= tol
        assert torch.equal(out, again)
        assert bool((out[empty] == 0).all())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("feat", [7, 41, 128, 256])
def test_gather_agg_dx_over_the_transpose(cuda_device, dtype, tol, feat):
    """K1's dx: the card's transpose equals the plain one bit for bit, and
    dx, at transposed rows of exactly c, c + 1, 2c and 40c + 11 entries
    (c = CSR_CHUNK_MIN, the chunk at D*K = 30000), sources with no slot and
    zero-weight padding
    pointing at row 0, matches the plain version and repeats bit for bit."""
    c = CSR_CHUNK_MIN
    rng = np.random.default_rng(feat + 5)
    d, k, s = 3000, 10, 2000
    assert csr_chunk_edges(d * k) == c
    x, nbr, w, g = _block(rng, d, k, s, feat)
    flat_n, flat_w = nbr.view(-1), w.view(-1)
    flat_n[(flat_n >= 100) & (flat_n < 200)] = 4   # sources without a slot
    slots = torch.from_numpy(rng.permutation(d * k))
    at = 0
    for src, n in ((5, 40 * c + 11), (9, c), (11, c + 1), (13, 2 * c)):
        flat_n[(flat_n == src) & (flat_w != 0)] = 4
        pick = slots[at:at + n]
        flat_n[pick], flat_w[pick] = src, 0.5 + torch.rand(n)
        at += n
    flat_n[flat_w == 0] = 0                        # the sampler's padding
    dev = [t.to(cuda_device) for t in (x, nbr, w, g)]
    xd, gd = dev[0].to(dtype), dev[3].to(dtype)
    csr_t = agg.block_transpose(dev[1], dev[2], s)
    for got, want in zip(csr_t, agg.block_transpose(nbr, w, s)):
        assert torch.equal(got.cpu(), want)
    lengths = csr_t[0].diff().cpu()
    assert [int(lengths[i]) for i in (5, 9, 11, 13)] == [40 * c + 11, c,
                                                          c + 1, 2 * c]
    before = (k1.block_transpose_cuda.launches,
              k1.gather_agg_bwd_dx_cuda.launches)
    dx = agg.gather_agg_bwd_dx(gd, dev[1], dev[2], xd)
    again = agg.gather_agg_bwd_dx(gd, dev[1], dev[2], xd)
    torch.cuda.synchronize()
    assert (k1.block_transpose_cuda.launches,
            k1.gather_agg_bwd_dx_cuda.launches) == (before[0] + 2,
                                                   before[1] + 2)
    assert dx.dtype == dtype and dx.shape == (s, feat)
    assert _rel(dx, agg.gather_agg_bwd_dx_plain(gd, dev[1], dev[2], s,
                                                torch.float32)) <= tol
    assert torch.equal(dx, again)
    assert bool((dx[100:200] == 0).all())


# K4's tables against the plain versions, as chip_smoke.py's kernel_k4
# phase holds them (its K4_TABLE_TOL says why they could need more)
K4_TABLE_TOL = 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("heads,feat", [(1, 41), (4, 128), (2, 48), (3, 30),
                                        (16, 256)])
def test_gat_bwd_kernels_match_plain(cuda_device, dtype, tol, heads, feat):
    """B1 and B2 against their plain versions on the same CUDA tensors:
    skewed rows, a hub source (a B1 row in the walk's pieces), rows with no
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


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,feat", [(1, 7), (1, 41), (1, 128), (2, 256),
                                        (4, 128), (8, 64), (16, 256)])
def test_gat_bwd_dst_rows_and_layouts(cuda_device, aligned, dtype, heads,
                                      feat):
    """B2 on rows of 0, 1, 31, 32, 33 and 1000 in-edges, clipped scores,
    and a source whose raised score dominates its destinations' attention
    (t_e ~ rz[d] there, where the identity's two sums nearly cancel), with
    Gz and rz from a cotangent through the forward as training makes them:
    vector columns where F and the head are multiples of 4 and ht and gz
    are aligned, else scalar; held to the plain version at 1e-5, rows with
    no edges zero, bit-identical on repeat."""
    rng = np.random.default_rng(heads * 100 + feat + aligned)
    v_src = 1500
    deg, rowptr, col = _row_tail_csr(rng, v_src)
    hub_row = int(np.flatnonzero(deg == 33)[0])
    col[rowptr[hub_row]:rowptr[hub_row] + 3] = 11
    ts = (rng.standard_normal((v_src, heads)) * 2.0).astype(np.float32)
    ts[::97] += 80.0                       # past the +60 clip
    ts[11] = 12.0                          # u ~ e^12: source 11 dominates
    td = (rng.standard_normal((deg.size, heads)) * 2.0).astype(np.float32)
    ht = _placed(rng.standard_normal((v_src, feat)).astype(np.float32),
                 dtype, cuda_device, aligned)
    ts, td, rowptr, col = (torch.from_numpy(a).to(cuda_device)
                           for a in (ts, td, rowptr, col))
    h, z = gat_aggregate_plain(ht.float(), ts, td, rowptr, col, heads)
    cot = torch.from_numpy(rng.standard_normal((deg.size, feat)).astype(
        np.float32)).to(cuda_device)
    gz, rz = gat_bwd_operands(cot, h, z, heads)
    gz = _placed(gz.cpu().numpy(), torch.float32, cuda_device, aligned)
    layout = dst_layout(ht, gz, heads)
    assert layout["vec"] == (4 if feat % 4 == 0 and (feat // heads) % 4 == 0
                             and aligned else 1)
    # the cap by layout: 4 blocks an SM with vector columns, else 5
    assert 0 < layout["registers"] <= (64 if layout["vec"] == 4 else 48)
    args = (ht, ts, gz, td, rz, rowptr, col, heads)
    before = gat_bwd_dst_cuda.launches
    dtd = gat_bwd_dst_cuda(*args)
    again = gat_bwd_dst_cuda(*args)
    torch.cuda.synchronize()
    assert gat_bwd_dst_cuda.launches == before + 2
    assert _rel(dtd, gat_bwd_dst_plain(ht.float(), *args[1:])) <= K4_TABLE_TOL
    empty = torch.from_numpy(np.flatnonzero(deg == 0)).to(cuda_device)
    assert bool((dtd[empty] == 0).all())
    assert torch.equal(dtd, again)


@pytest.mark.parametrize("heads,feat,dtype", [(3, 30, torch.bfloat16),
                                              (1, 41, torch.float32),
                                              (4, 128, torch.float32)])
def test_gat_bwd_dst_repeats_bit_for_bit(cuda_device, heads, feat, dtype):
    """B2 launched 300 times on one input of 20,000 destination rows of
    0-199 in-edges, clipped scores: every result equals the first bit for
    bit.  Each 32-edge window's c and sources are staged in a per-warp
    shared buffer between two __syncwarp; a lane writing the next
    window's before another lane has read this one's would show as a
    launch that differs.  (3, 30) takes one head a tile with scalar
    columns, (1, 41) scalar columns, (4, 128) vector columns."""
    rng = np.random.default_rng(heads * 10 + feat)
    v = 20000
    rowptr = np.zeros(v + 1, np.int64)
    np.cumsum(rng.integers(0, 200, v), out=rowptr[1:])
    col = rng.integers(0, v, int(rowptr[-1])).astype(np.int32)
    ts = (rng.standard_normal((v, heads)) * 2.0).astype(np.float32)
    ts[::97] += 80.0
    ht, gz = rng.standard_normal((2, v, feat)).astype(np.float32)
    td, rz = (rng.standard_normal((2, v, heads)) * 2.0).astype(np.float32)
    ht, ts, gz, td, rz, rowptr, col = (
        torch.from_numpy(a).to(cuda_device)
        for a in (ht, ts, gz, td, rz, rowptr, col))
    args = (ht.to(dtype), ts, gz, td, rz, rowptr, col, heads)
    first = gat_bwd_dst_cuda(*args)
    same = sum(bool(torch.equal(first, gat_bwd_dst_cuda(*args)))
               for _ in range(300))
    assert same == 300


def _hub_source_inputs(rng, v, e, feat, heads, hub_edges):
    """K4's inputs over a dst-sorted CSR whose source 5 takes `hub_edges`
    edges (a transposed row spanning many of the walk's chunks), whose
    sources 3 mod 17 have no out-edges, with clipped scores; and the
    transposed CSR."""
    ht, ts, td, rowptr, col = _gat_inputs(rng, v, v, e, feat, heads,
                                          zero_rows=[1, 2])
    col = col.numpy()
    col = np.where(col % 17 == 3, col - 1, col)
    col[rng.choice(col.size, size=hub_edges, replace=False)] = 5
    gz = rng.standard_normal((v, feat)).astype(np.float32)
    rz = rng.standard_normal((v, heads)).astype(np.float32)
    csr_t = csr_transpose(rowptr.numpy(), col, np.ones(col.size, np.float32),
                          v)
    return ht, ts, torch.from_numpy(gz), td, torch.from_numpy(rz), csr_t


@pytest.mark.parametrize("chunk", [64, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,feat", [(1, 41), (4, 128), (8, 64)])
def test_gat_bwd_src_walk_matches_plain(cuda_device, monkeypatch, chunk,
                                        dtype, heads, feat):
    """B1, csr_sum.cuh's edge-balanced walk with one dot product a row,
    at 64 and 1024 edges a warp: a hub source of 10^5 edges in pieces
    combined by the fixed tree, sources with no out-edges (zeros), clipped
    scores, f32 and bf16 ht, scalar (F=41) and vector columns; held to the
    plain version (f64 over the hub row) at 1e-5, bit-identical on
    repeat."""
    from sgnn_tpu_torch.ops.cuda import gat_bwd as k4

    monkeypatch.setattr(k4, "csr_chunk_edges", lambda _: chunk)
    rng = np.random.default_rng(heads * 100 + feat + chunk)
    ht, ts, gz, td, rz, csr_t = _hub_source_inputs(
        rng, 3000, 260000, feat, heads, 100000)
    ht, ts, gz, td, rz = (t.to(cuda_device) for t in (ht, ts, gz, td, rz))
    ht = ht.to(dtype)
    rowptr_t, col_t, _ = (torch.from_numpy(a).to(cuda_device) for a in csr_t)
    lengths = rowptr_t.diff()
    assert int(lengths[5]) >= 100000 and int(lengths[5]) > 40 * chunk
    args = (ht, ts, gz, td, rz, rowptr_t, col_t, heads)
    before = gat_bwd_src_cuda.launches
    dht, dts = gat_bwd_src_cuda(*args)
    again = gat_bwd_src_cuda(*args)
    torch.cuda.synchronize()
    assert gat_bwd_src_cuda.launches == before + 2
    ref_dht, ref_dts = gat_bwd_src_plain(ht.float(), *args[1:])
    assert _rel(dht, ref_dht) <= 1e-5
    assert _rel(dts, ref_dts) <= K4_TABLE_TOL
    empty = torch.nonzero(lengths == 0).flatten()
    assert empty.numel() > 100
    assert bool((dht[empty] == 0).all()) and bool((dts[empty] == 0).all())
    assert torch.equal(dht, again[0]) and torch.equal(dts, again[1])


@pytest.mark.parametrize("family,aggregator,heads", [
    ("gcn", "sum", 1), ("sage", "sum", 1), ("gat", "sum", 4),
    ("gcn", "max", 1)])
def test_fullbatch_trainer_card_vs_cpu(cuda_device, family, aggregator,
                                       heads):
    """One whole-graph epoch's loss and gradients, card against CPU from
    the same parameters (drop 0, TF32 off), and the launches of an epoch
    with METRICS:clean at drop 0.5: GCN/SAGE 4 SpMM forward + 2 backward,
    GAT 4 K3 + 2 B1 + 2 B2, min/max none; none of the sampled GAT
    kernels in any."""
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

    def sampled_gat():
        return [gs.gat_sampled_fwd_cuda.launches,
                gs.gat_sampled_bwd_cuda.launches]

    sampled_before = sampled_gat()
    loss, *accs = tr.train_epoch()
    assert np.isfinite(loss) and all(0.0 <= a <= 1.0 for a in accs)
    want = {"gat": [0, 0, 4, 2, 2]}.get(
        family, [4, 2, 0, 0, 0] if aggregator == "sum" else [0] * 5)
    assert [f.launches - b for f, b in zip(fns, before)] == want
    before = [f.launches for f in fns]
    tr.predict()
    assert [f.launches - b for f, b in zip(fns, before)] == [
        w // 2 if i in (0, 2) else 0 for i, w in enumerate(want)]
    assert sampled_gat() == sampled_before


# ---- rate probes (ops/probes.py, csrc/probe_gather.cu, probe_tile.cu) ----
# each kernel against its plain version on the same CUDA tensors: P-G and
# P-T at 1e-5 relative (f32 sums in another order), P-S exact, P-A out at
# 5e-3 (a one-ulp expf difference can flip bf16(u)) and z at 1e-5
@pytest.mark.parametrize("t_rows,edges,tile,feat", [(2048, 1 << 14, 2048, 128),
                                                    (300, 1000, 100, 40)])
def test_probe_gather_sum_matches_plain(cuda_device, t_rows, edges, tile,
                                        feat):
    table, idx = (torch.from_numpy(a).to(cuda_device) for a in
                  pr.gather_inputs(t_rows, t_rows, edges, feat, tile))
    ref = pr.gather_sum_plain(table, idx)
    for resident in (True, False):
        before = prc.gather_sum_cuda.launches
        out = pr.gather_sum(table, idx, resident)
        again = pr.gather_sum(table, idx, resident)
        torch.cuda.synchronize()
        assert prc.gather_sum_cuda.launches == before + 2
        assert _rel(out, ref) <= 1e-5
        assert torch.equal(out, again)


@pytest.mark.parametrize("shape,axis", [((128, 128), 0), ((100, 300), 1),
                                        ((2048, 37), 0)])
def test_probe_shuffle_matches_plain(cuda_device, shape, axis):
    x = torch.from_numpy(pr.shuffle_input(1, *shape)).to(cuda_device)
    out = pr.shuffle(x, axis)
    assert torch.equal(out, pr.shuffle_plain(x, axis))
    assert torch.equal(out, pr.shuffle(x, axis))


def test_cuda_graph_ms_counts_the_replayed_runs(cuda_device):
    # a warm-up call, `reps` captured calls, two replays: 1 + 2 * reps runs
    x = torch.from_numpy(pr.shuffle_input(1, 64, 64)).to(cuda_device)
    before = prc.shuffle_cuda.launches
    ms = cuda_graph_ms(lambda: pr.shuffle(x, 0), 3, prc.COUNTED)
    assert ms > 0 and prc.shuffle_cuda.launches == before + 7


@pytest.mark.parametrize("cfg", [(4, 64, 512, 256, 64, 96, 128),
                                 (3, 100, 300, 96, 32, 40, 40)])
def test_probe_tile_spmm_matches_plain(cuda_device, cfg):
    n, s_blk, d_blk, e_t, e_sub, w_win, feat = cfg
    t = pr.to_torch(pr.tile_inputs(n, s_blk, d_blk, e_t, e_sub, w_win, n,
                                   feat), cuda_device)
    args = (t["slab"], t["src"], t["dst"], t["w"], t["r0"], d_blk)
    out = pr.tile_spmm(*args)
    assert _rel(out, pr.tile_spmm_plain(*args)) <= 1e-5
    # sorted by row and summed in order: the ordered plain sum bit for bit
    assert torch.equal(out, pr.tile_spmm_ordered(*args))
    assert torch.equal(out, pr.tile_spmm(*args))
    gathered = pr.tile_gather(t["slab"], t["src"])
    assert torch.equal(gathered, pr.tile_gather_plain(t["slab"], t["src"]))
    assert torch.equal(gathered, pr.tile_gather(t["slab"], t["src"]))


def test_probe_tile_parts_match_plain(cuda_device):
    t = pr.to_torch(pr.tile_part_inputs(2, 64, 256, 48, 512, 4), cuda_device)
    for part in pr.TILE_PARTS:
        fn, args = pr.tile_part_args(part, t["slab"], t["src"], t["w"],
                                     t["r0s"], 48, 512)
        plain = (pr.tile_gather_plain if part == "c1"
                 else pr.tile_spmm_plain)
        out = fn(*args)
        assert _rel(out, plain(*args)) <= 1e-5, part
        assert torch.equal(out, fn(*args)), part
        if part != "c1":
            assert torch.equal(out, pr.tile_spmm_ordered(*args)), part


def test_probe_tile_spmm_config0_matches_plain(cuda_device):
    # configuration 0 at its size: 512 steps of 2048 edges into [8192, 128]
    s_blk, d_blk, e_t, e_sub, w_win = pr.TILE_CONFIGS["0"]
    t = pr.to_torch(pr.tile_inputs(0, s_blk, d_blk, e_t, e_sub, w_win),
                    cuda_device)
    args = (t["slab"], t["src"], t["dst"], t["w"], t["r0"], d_blk)
    before = prc.tile_spmm_cuda.launches
    out = pr.tile_spmm(*args)
    again = pr.tile_spmm(*args)
    torch.cuda.synchronize()
    assert prc.tile_spmm_cuda.launches == before + 2
    assert _rel(out, pr.tile_spmm_plain(*args)) <= 1e-5
    assert torch.equal(out, again)
    assert torch.equal(out, pr.tile_spmm_ordered(*args))
    assert prc.tile_sum_resources()["registers"] > 0


@pytest.mark.parametrize("kw", [{}, dict(n_tiles=16, s_blk=100, w_win=50,
                                         n_edges=120, feat=64, heads=2,
                                         n_live=90, cols=4)])
def test_probe_gat_tile_matches_plain(cuda_device, kw):
    a = pr.gat_tile_inputs(4, **kw)
    a["src"][:, -10:] = kw.get("s_blk", pr.GAT_S_BLK)  # sentinel sources
    a["dst"][:, -10:] = np.arange(10) % kw.get("w_win", pr.GAT_W)
    t = pr.to_torch(a, cuda_device)
    args = (t["slab"], t["ts"], t["td"], t["src"], t["dst"],
            kw.get("heads", pr.GAT_HEADS))
    out, z = pr.gat_tile(*args)
    ref_out, ref_z = pr.gat_tile_plain(*args)
    assert _rel(out, ref_out) <= 5e-3 and _rel(z, ref_z) <= 1e-5
    again = pr.gat_tile(*args)
    assert torch.equal(out, again[0]) and torch.equal(z, again[1])


def test_probe_kernels_reject_bad_args(cuda_device):
    table = torch.ones(8, 16, device=cuda_device)
    idx = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="idx is on cpu"):
        pr.gather_sum(table, idx)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        prc.gather_sum_cuda(table.cpu(), idx)
    with pytest.raises(ValueError, match="x must be"):
        pr.shuffle(table.double(), 0)
    slab = torch.ones(8, 16, device=cuda_device)      # f32, not bf16
    src = torch.zeros(2, 4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="slab must be"):
        pr.tile_gather(slab, src)
    # one bucket pass of the sum takes out blocks of up to MAX_TILE_ROWS
    r0 = torch.zeros(2, 1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="out rows"):
        pr.tile_spmm(slab.to(torch.bfloat16), src, None, None, r0,
                     prc.MAX_TILE_ROWS + 1)
    with pytest.raises(ValueError, match="heads"):
        pr.gat_tile(torch.ones(1, 4, 8, dtype=torch.bfloat16,
                               device=cuda_device),
                    torch.ones(1, 4, 2, dtype=torch.bfloat16,
                               device=cuda_device),
                    torch.ones(1, 2, 2, device=cuda_device), src[:1],
                    src[:1], 3)


# ------------------------------------------------- serving and training extras
@pytest.mark.parametrize("family,heads", [("gcn", 1), ("gat", 4)])
def test_int8_server_card_matches_cpu(cuda_device, family, heads):
    """int8 residency on the card: log-probs and queries held to the same
    int8 server on the CPU at the serving bound (1e-4 abs), 2 kernel
    launches a pass, a quarter of the f32 feature bytes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = random_graph_dataset(3000, 10, 48, 5, seed=5)
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    p = init_model(2, family, [48, 16, 5], device="cpu")
    if family == "gat":
        gen = torch.Generator().manual_seed(3)
        p = p._replace(attn=tuple(torch.randn(a.shape, generator=gen) * 0.3
                                  for a in p.attn))
    card = InferenceServer(p, family, adj, ds.features, heads=heads,
                           dtype="int8", device=cuda_device)
    cpu = InferenceServer(p, family, adj, ds.features, heads=heads,
                          dtype="int8", device="cpu")
    assert card.feature_bytes * 4 == ds.features.nbytes
    kernel = gat_aggregate_cuda if family == "gat" else spmm_csr_cuda
    before = kernel.launches
    got = card.logprobs()
    assert kernel.launches - before == 2
    ref = cpu.logprobs()
    assert np.abs(got - ref).max() <= 1e-4
    nids = np.arange(0, 3000, 37)
    assert np.abs(card.query(nids) - got[nids]).max() <= 1e-4


@pytest.mark.parametrize("family,heads", [("gcn", 1), ("sage", 1),
                                          ("gat", 4)])
def test_chunked_layerwise_card_matches_whole_graph(cuda_device, family,
                                                    heads):
    """Chunked layerwise_inference on the card: 2 launches a chunk (K2, or
    K3 for GAT), held to the whole-graph pass at 1e-4 abs.  It runs first,
    after a caller switched TF32 on: the chunked mode itself must turn
    the products back to full f32."""
    from sgnn_tpu_torch.train.inference import layerwise_inference

    torch.backends.cuda.matmul.allow_tf32 = True
    ds = random_graph_dataset(3000, 10, 48, 5, seed=6)
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    p = init_model(2, family, [48, 16, 5], device="cpu")
    if family == "gat":
        gen = torch.Generator().manual_seed(4)
        p = p._replace(attn=tuple(torch.randn(a.shape, generator=gen) * 0.3
                                  for a in p.attn))
    kernel = gat_aggregate_cuda if family == "gat" else spmm_csr_cuda
    other = spmm_csr_cuda if family == "gat" else gat_aggregate_cuda
    before, before_other = kernel.launches, other.launches
    got = layerwise_inference(p, family, adj, ds.features, heads=heads,
                              whole_graph=False, chunk_size=1000,
                              device=cuda_device)
    assert kernel.launches - before == 2 * 3
    assert other.launches == before_other
    assert not torch.backends.cuda.matmul.allow_tf32
    whole = layerwise_inference(p, family, adj, ds.features, heads=heads,
                                whole_graph=True, device=cuda_device)
    assert np.abs(got - whole).max() <= 1e-4


@pytest.mark.parametrize("algo", ["GSSAMPLEALLGPU", "GCNFULLBATCH"])
def test_resume_on_the_card(cuda_device, tmp_path, algo):
    """2 epochs straight against 1 epoch, save, restore into a new trainer,
    1 more: parameters within 1e-4 relative max-abs (the autograd
    backward of index_select sums with float atomics on the card, so bit
    equality is not promised there)."""
    from sgnn_tpu_torch.train.checkpoint import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = random_graph_dataset(3000, 10, 48, 5, seed=7)
    cfg = RunConfig(algorithm=algo, layer_sizes=[48, 16, 5], fanout=[5, 3],
                    batch_size=256, drop_rate=0.5, vertices=ds.num_vertices)
    a = build_trainer(cfg, ds, device=cuda_device)
    a.train_epoch()
    a.train_epoch()
    b = build_trainer(cfg, ds, device=cuda_device)
    b.train_epoch()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, b)
    c = build_trainer(cfg, ds, device=cuda_device)
    assert mgr.restore(c) == 0
    c.train_epoch()
    pa = getattr(a, "base", a).params.leaves()
    pc = getattr(c, "base", c).params.leaves()
    for x, y in zip(pa, pc):
        assert y.device.type == "cuda"
        assert _rel(y.cpu(), x.cpu()) <= 1e-4


# ------------------------------------------------------------- the caches --
def _hot_graph(feat):
    """A 6,000-vertex graph with hub destinations, its hot set (a fifth of
    the vertices, by presampled hotness) and Gaussian [V, feat] rows."""
    from sgnn_tpu_torch.cache.hotness import presample_hotness

    rng = np.random.default_rng(feat)
    v = 6000
    dst = np.concatenate([rng.zipf(1.6, 60000) % v,
                          rng.integers(0, v, 60000)]).astype(np.int32)
    src = rng.integers(0, v, dst.size).astype(np.int32)
    adj = Adjacency.from_edges(np.stack([src, dst], 1), v)
    ids = presample_hotness(adj, np.arange(0, v, 3), [10, 5], 0.2)
    x = rng.standard_normal((v, feat)).astype(np.float32)
    return adj, ids, x


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 5e-3),
                                       (torch.int8, 1e-5)])
@pytest.mark.parametrize("feat", [7, 602])
def test_pushdown_aggregate_matches_plain(cuda_device, dtype, tol, feat):
    """K2's forward over the hot set's CSR (rows: the cache slots, up to
    hundreds of edges) against its plain version on the same card tensors;
    int8 levels (exact in f32) in blocks of unique source rows, scaled
    after the sum; one launch a plan for f32/bf16, bit-identical on
    repeat."""
    from sgnn_tpu_torch.cache.embedding_cache import EmbeddingCache
    from sgnn_tpu_torch.data.quant import quantize_columns

    adj, ids, x = _hot_graph(feat)
    cache = EmbeddingCache.build(adj, ids, WeightKind.GCN, device=cuda_device)
    assert int(np.diff(cache.rowptr).max()) > 100
    scale = None
    if dtype == torch.int8:
        q, scale = quantize_columns(x)
        xt = torch.from_numpy(q).to(cuda_device)
        ref_x = torch.from_numpy(q.astype(np.float32)).to(cuda_device)
    else:
        xt = torch.from_numpy(x).to(cuda_device, dtype)
        ref_x = xt.float()
    before = spmm_csr_cuda.launches
    cache.precompute_aggregate(xt, scale)
    got = cache.cache_agg
    n = spmm_csr_cuda.launches - before
    assert n >= 1 if dtype == torch.int8 else n == 1
    cache.precompute_aggregate(xt, scale)
    assert torch.equal(got, cache.cache_agg)
    csr = csr_from_numpy(cache.rowptr, cache.col, cache.w, x.shape[0],
                         cuda_device)
    ref = spmm_csr_plain(ref_x, *csr)
    if scale is not None:
        ref = ref * torch.from_numpy(scale).to(cuda_device)[None, :]
    assert got.dtype == torch.float32 and got.device.type == "cuda"
    assert _rel(got.cpu(), ref.cpu()) <= tol


def test_cold_row_scatter_on_the_card(cuda_device):
    """The feature cache's compacted misses scattered onto the source axis
    on CUDA tensors, padding entries (one past the axis) included, then
    the hot rows laid over them: equal to the full gather."""
    from sgnn_tpu_torch.cache.feature_cache import (
        FeatureCache, check_cold_pos, scatter_cold_rows,
    )

    rng = np.random.default_rng(5)
    feats = rng.standard_normal((5000, 41)).astype(np.float32)
    fc = FeatureCache.build(feats, np.arange(0, 5000, 4, dtype=np.int32),
                            device=cuda_device)
    for n_src in (0, 3, 700, 2048):
        srcs = np.zeros(2048, np.int32)
        srcs[:n_src] = np.sort(rng.choice(5000, n_src, replace=False))
        valid = np.arange(2048) < n_src
        x_cold, pos = fc.gather_cold_compact(feats, srcs, valid)
        assert (pos == 2048).sum() == pos.size - (
            valid & (fc.slot_map[srcs] < 0)).sum()
        check_cold_pos(pos, 2048)
        x0 = scatter_cold_rows(torch.from_numpy(x_cold).to(cuda_device),
                               torch.from_numpy(pos).to(cuda_device), 2048)
        x0 = fc.merge_device(x0, torch.from_numpy(srcs).to(cuda_device),
                             torch.from_numpy(valid).to(cuda_device))
        torch.cuda.synchronize()
        full = np.where(valid[:, None], feats[srcs], 0.0)
        np.testing.assert_array_equal(x0.cpu().numpy(), full)


@pytest.mark.parametrize("algo,extra", [
    ("GSSAMPLECACHE", {}),
    ("GCNSAMPLEPDCACHE", dict(pd_refresh="host")),
    # past the device: under int8 features (144 kB) beside the 8 plans'
    # aggregates (461 kB); the feature cache stages the 204 rows a plan
    # that the aggregates leave of the budget
    ("GSSAMPLEPDCACHE", dict(hbm_budget=500_000, feature_cache_rate=0.3,
                             feature_cache_plan="per_sb")),
])
def test_cached_trainers_train_on_the_card(cuda_device, algo, extra):
    """The cached trainers on the card: K2 launched once a plan at build
    (none when the aggregate is the host's), finite losses, hits counted,
    and the card's first epoch within 1e-3 of the CPU's from the same
    weights (host sampler: the same blocks)."""
    ds = random_graph_dataset(3000, 10, 48, 5, seed=7)
    cfg = RunConfig(algorithm=algo, layer_sizes=[48, 16, 5], fanout=[5, 3],
                    batch_size=128, pipeline_num=2, drop_rate=0.0,
                    vertices=ds.num_vertices, **extra)
    cpu = build_trainer(cfg, ds, device="cpu")
    before = spmm_csr_cuda.launches
    tr = build_trainer(cfg, ds, device=cuda_device)
    built = spmm_csr_cuda.launches - before
    assert built == (0 if "hbm_budget" in extra else len(tr.sb_caches))
    assert len(tr.sb_caches) > 1
    cpu.params = tr.params.to("cpu")
    loss, _, edges = tr.train_epoch()
    assert np.isfinite(loss) and edges > 0
    assert 0 < tr.cache_hits < tr.cache_lookups
    assert spmm_csr_cuda.launches - before == built
    if algo != "GSSAMPLECACHE":
        cpu_loss, _, cpu_edges = cpu.train_epoch()
        assert cpu_edges == edges
        assert abs(cpu_loss - loss) <= 1e-3 * abs(cpu_loss)


@pytest.mark.parametrize("multi,single", [
    ("GCNSAMPLEALLMULTI", "GCNSAMPLEALLGPU"),
    ("GSSAMPLEPCMULTI", "GSSAMPLECACHE"),
])
def test_one_rank_nccl_dp_matches_the_single_device_engine(cuda_device,
                                                          multi, single):
    """A *MULTI engine on a one-rank NCCL group (parallel/mesh.make_group)
    trains bit for bit as its single-device engine from the same seed, at
    drop 0.5: the same epoch results, per-step losses and parameters (the
    *PCMULTI against the cached trainer with its one global hot set)."""
    import dataclasses

    import torch.distributed as dist

    from sgnn_tpu_torch.parallel.mesh import make_group
    from sgnn_tpu_torch.train.device_cached import DeviceCachedSampleTrainer

    ds = random_graph_dataset(3000, 10, 48, 5, seed=7)
    cfg = RunConfig(algorithm=multi, layer_sizes=[48, 16, 5], fanout=[5, 3],
                    batch_size=128, pipeline_num=2, drop_rate=0.5,
                    vertices=ds.num_vertices)
    group = make_group(cuda_device)
    try:
        assert (group.backend, group.world_size) == ("nccl", 1)
        dp = build_trainer(cfg, ds, device=cuda_device)
        single_cfg = dataclasses.replace(cfg, algorithm=single)
        sd = (DeviceCachedSampleTrainer(single_cfg, ds, device=cuda_device,
                                        per_sb=False)
              if multi.endswith("PCMULTI")
              else build_trainer(single_cfg, ds, device=cuda_device))
        assert type(dp.base) is type(sd)
        for _ in range(2):
            assert dp.train_epoch() == sd.train_epoch()
            assert dp.base.step_losses == sd.step_losses
        for a, b in zip(dp.params.leaves(), sd.params.leaves()):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


# ---- vertex-partitioned whole-graph training (parallel/halo.py) ---------
def _shard_cases(cuda_device, halo, wk, feat, part=1):
    """Shard `part` of a 4-way degree-balanced plan of a random graph, on
    the card and on the CPU, and what the exchange delivers to it from a
    random slot table: a rectangular CSR (rows local slots, sources the
    exchanged rows) whose transpose is mostly empty rows."""
    from sgnn_tpu_torch.parallel.halo import (
        build_targeted_halo, exchange_reference, shard_graph, shard_on_device,
    )
    from sgnn_tpu_torch.train.fullbatch import build_coo

    ds = random_graph_dataset(3000, 10, 48, 5, seed=11)
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    _, _, w = build_coo(adj, wk)
    build = build_targeted_halo if halo == "targeted" else shard_graph
    plan = build(adj, 4, w, balance="degree")
    rng = np.random.default_rng(feat)
    table = torch.from_numpy(rng.standard_normal(
        (4 * plan.rows_per_shard, feat)).astype(np.float32))
    ext = exchange_reference(plan, part, table)
    return (shard_on_device(plan, part, cuda_device),
            shard_on_device(plan, part, "cpu"), ext, rng)


@pytest.mark.parametrize("feat", [41, 128])
@pytest.mark.parametrize("halo", ["all_gather", "targeted"])
def test_shard_local_k2_on_a_rectangular_csr(cuda_device, halo, feat):
    """K2's forward and backward over one shard's CSR and its transpose
    (n·rows or rows + n·H_pad sources, most transposed rows empty, the
    tail past the last edge too) against the plain versions on the same
    CUDA tensors, and bit-identical on repeat."""
    from sgnn_tpu_torch.parallel.halo import local_aggregate

    card, _, ext, rng = _shard_cases(cuda_device, halo, WeightKind.GCN,
                                     feat)
    rowptr_t = card.csr_t.rowptr
    empty = (rowptr_t[1:] == rowptr_t[:-1])
    assert card.csr_t.num_rows == ext.shape[0] > card.rows
    assert bool(empty.any()) and bool(empty[-1])
    x = ext.to(cuda_device).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((card.rows, feat)).astype(
        np.float32)).to(cuda_device)
    before = (spmm_csr_cuda.launches, spmm_csr_bwd_cuda.launches)
    out = local_aggregate(x, card)
    out.backward(g)
    torch.cuda.synchronize()
    assert (spmm_csr_cuda.launches - before[0],
            spmm_csr_bwd_cuda.launches - before[1]) == (1, 1)
    ref = spmm_csr_plain(x.detach(), *card.csr)
    ref_dx = spmm_csr_plain(g, *card.csr_t)
    torch.testing.assert_close(out.detach(), ref, **F32)
    torch.testing.assert_close(x.grad, ref_dx, **F32)
    assert bool((x.grad[empty] == 0).all())
    assert torch.equal(spmm_csr_bwd(g, *card.csr_t), x.grad)


@pytest.mark.parametrize("heads,feat", [(1, 41), (4, 128)])
@pytest.mark.parametrize("halo", ["all_gather", "targeted"])
def test_shard_local_gat_on_a_rectangular_csr(cuda_device, halo, heads,
                                              feat):
    """K3 and K4 over one shard's CSR (sources the exchanged rows with
    their score table, destinations the shard's rows with theirs) against
    the same layer on the CPU (the plain versions): the forward at 1e-5,
    the gradients of the exchanged rows and of both score tables at
    cosine > 0.999 (tests/test_mxu_gat.py:195-197), bit-identical on
    repeat."""
    from sgnn_tpu_torch.ops.gat import pack_score_tables
    from sgnn_tpu_torch.parallel.halo import local_gat

    card, cpu, ext, rng = _shard_cases(cuda_device, halo, WeightKind.NONE,
                                       feat)
    a = torch.from_numpy((rng.standard_normal(2 * feat) * 0.3).astype(
        np.float32))
    ts_ext, _ = pack_score_tables(ext, a[:feat], a[feat:], heads)
    own = torch.from_numpy(rng.standard_normal((card.rows, feat)).astype(
        np.float32))
    _, td = pack_score_tables(own, a[:feat], a[feat:], heads)
    g = torch.from_numpy(rng.standard_normal((card.rows, feat)).astype(
        np.float32))
    fns = (gat_aggregate_cuda, gat_bwd_src_cuda, gat_bwd_dst_cuda)
    results = []
    for shard, dev in ((cpu, "cpu"), (card, cuda_device), (card,
                                                           cuda_device)):
        xs = [t.detach().to(dev).requires_grad_() for t in (ext, ts_ext, td)]
        before = [f.launches for f in fns]
        out = local_gat(*xs, shard, heads)
        out.backward(g.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1]
        results.append([out.detach().cpu()] + [t.grad.cpu() for t in xs])

    def cos(x, y):
        x, y = x.double().flatten(), y.double().flatten()
        return float(x @ y / (x.norm() * y.norm()))

    (ref, *ref_grads), (got, *grads), (again, *grads2) = results
    torch.testing.assert_close(got, ref, **F32)
    for x, y in zip(grads, ref_grads):
        assert cos(x, y) > 0.999
    assert torch.equal(got, again)
    assert all(torch.equal(x, y) for x, y in zip(grads, grads2))


@pytest.mark.parametrize("family,halo", [("gcn", "targeted"),
                                         ("gat", "all_gather")])
def test_one_rank_nccl_graph_group_matches_one_device(cuda_device, family,
                                                      halo):
    """FullBatchTrainer on a one-rank NCCL graph group (the sharded program
    at n = 1, a CSR with padding rows) against the single-device trainer
    from the same seed at drop 0.5: losses and parameters within 1e-6
    relative, the same kernel launches an epoch."""
    import torch.distributed as dist

    from sgnn_tpu_torch.parallel.mesh import make_group

    ds = random_graph_dataset(3000, 10, 48, 5, seed=7)
    cfg = RunConfig(layer_sizes=[48, 16, 5], drop_rate=0.5, heads=4,
                    vertices=ds.num_vertices)
    fns = (spmm_csr_cuda, spmm_csr_bwd_cuda, gat_aggregate_cuda,
           gat_bwd_src_cuda, gat_bwd_dst_cuda)
    group = make_group(cuda_device, graph=1)
    try:
        assert (group.backend, group.world_size) == ("nccl", 1)
        trs = [FullBatchTrainer(cfg, ds, family=family, device=cuda_device),
               FullBatchTrainer(cfg, ds, family=family, mesh=group,
                                halo=halo, device=cuda_device)]
        for _ in range(2):
            got = []
            for tr in trs:
                before = [f.launches for f in fns]
                got.append((tr.train_epoch(),
                            [f.launches - b for f, b in zip(fns, before)]))
            np.testing.assert_allclose(got[1][0], got[0][0], rtol=1e-6)
            assert got[1][1] == got[0][1]
        for a, b in zip(trs[1].params.leaves(), trs[0].params.leaves()):
            assert _rel(a, b) <= 1e-6
        assert np.abs(trs[1].predict() - trs[0].predict()).max() <= 1e-5
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_multihost_fullbatch_is_the_single_trainer(
        cuda_device, tmp_path):
    """`initialize_distributed` at a TCP coordinator joins a one-rank NCCL
    group; the whole-graph driver on it (GCN, drop 0.5, 3 epochs) is bit
    for bit the single-device FullBatchTrainer, and its checkpoint resumes
    to the same parameters."""
    import socket

    import torch.distributed as dist

    from sgnn_tpu_torch.parallel import multihost as mh

    ds = random_graph_dataset(3000, 10, 48, 5, seed=7)
    cfg = RunConfig(layer_sizes=[48, 16, 5], drop_rate=0.5, epochs=3,
                    vertices=ds.num_vertices)
    single = FullBatchTrainer(cfg, ds, device=cuda_device)
    want = [single.train_epoch()[0] for _ in range(3)]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert mh.initialize_distributed(f"127.0.0.1:{port}", 1, 0) == (0, 1)
    try:
        assert dist.get_backend() == "nccl"
        state = {}
        before = spmm_csr_cuda.launches
        got = mh.run_multihost_fullbatch_epochs(cfg, ds, state_out=state)
        assert spmm_csr_cuda.launches - before == 12   # 4 an epoch
        assert got == want
        for a, b in zip(state["params"]["weights"], single.params.weights):
            assert torch.equal(a, b.cpu())
        mh.multihost_checkpoint_save(str(tmp_path), 3, state)
        back = mh.multihost_checkpoint_restore(str(tmp_path))
        more = mh.run_multihost_fullbatch_epochs(cfg, ds, epochs=1,
                                                 resume_state=back)
        assert more == [single.train_epoch()[0]]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["degree", "bfs"])
def test_reordered_k2_matches_plain(cuda_device, mode):
    """K2's forward and backward over a renumbered power-law graph's CSR
    and transpose against their plain versions, and the renumbered rows
    mapped back against the original graph's kernel rows."""
    from sgnn_tpu_torch.data.synthetic import powerlaw_graph_dataset
    from sgnn_tpu_torch.graph import apply_vertex_order, vertex_order
    from sgnn_tpu_torch.train.fullbatch import build_coo

    ds = powerlaw_graph_dataset(20000, 12, 8, 4, seed=3)
    order = vertex_order(ds, mode)
    rds, old_to_new = apply_vertex_order(ds, order)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(ds.num_vertices, 64, generator=gen)
    outs = []
    for d, xd in ((ds, x), (rds, x[torch.from_numpy(order).long()])):
        adj = Adjacency.from_edges(d.edges, d.num_vertices)
        src, _, w = build_coo(adj, WeightKind.GCN)
        v = d.num_vertices
        csr = csr_from_numpy(adj.indptr, src, w, v, cuda_device)
        csr_t = csr_from_numpy(*csr_transpose(adj.indptr, src, w, v), v,
                               cuda_device)
        xc = xd.to(cuda_device)
        out = spmm_csr_cuda(xc, *csr)
        dx = spmm_csr_bwd_cuda(xc, *csr_t)
        torch.testing.assert_close(out, spmm_csr_plain(xc, *csr), **F32)
        torch.testing.assert_close(dx, spmm_csr_plain(xc, *csr_t), **F32)
        outs.append(out.cpu())
    back = outs[1][torch.from_numpy(old_to_new).long()]
    torch.testing.assert_close(back, outs[0], **F32)


def test_sample_span_holds_its_kernel_launches(cuda_device):
    """The program's spans are on the clock of the profiler's events on
    the card too: in a profiled `sample` call (CUDA activity only, as the
    benchmark's traced window records), every kernel or graph launch the
    trace holds lies inside the `sample` span (the call replays the
    sampler's graph: one graph launch), and the span's events give its
    device time."""
    from torch.profiler import ProfilerActivity, profile

    from sgnn_tpu_torch.utils import timing

    ds = random_graph_dataset(4000, 10, 32, 5, seed=0)
    cfg = RunConfig(algorithm="GATSAMPLEALLGPU", layer_sizes=[32, 16, 5],
                    fanout=[5, 3], batch_size=512, heads=2, vertices=4000)
    trainer = build_trainer(cfg, ds, device=cuda_device)
    seeds, valid = next(trainer._seed_batches(trainer.train_nids, False))
    trainer.sample(seeds, valid)
    torch.cuda.synchronize()
    timing.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert timing.tracing()
        trainer.sample(seeds, valid)
        torch.cuda.synchronize()
    (s,) = [r for r in timing.RECORDER.records() if r["name"] == "sample"]
    launches = [e for e in prof.profiler.kineto_results.events()
                if "LaunchKernel" in e.name() or "GraphLaunch" in e.name()]
    assert sum("GraphLaunch" in e.name() for e in launches) == 1
    for e in launches:
        a = e.start_ns()
        assert s["start_ns"] <= a and a + e.duration_ns() <= s["end_ns"], (
            e.name(), a, s)
    assert s["device"] and s["device_ms"] > 0


@pytest.mark.parametrize("num_src_pad", [5632, 2048])
def test_source_set_matches_rank_scatter_at_products_size(cuda_device,
                                                          monkeypatch,
                                                          num_src_pad):
    """One hop at ogbn-products' size (V = 2,449,152 padded, 512 seeds of
    which 12 are padding, fanout 10) over a random graph of in-degree 50
    whose sources are Zipf-skewed (density 1/rank: low ids are hubs): the
    block and the overflow count equal the rank scatter's for the same
    draws, at the exact pad (5,632) and at one the rank space overflows."""
    v, in_deg, b, fanout = 2_449_152, 50, 512, 10
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    indptr = torch.arange(v + 1, dtype=torch.int64, device=cuda_device)
    indptr *= in_deg
    u = torch.rand(v * in_deg, generator=gen, device=cuda_device)
    indices = (torch.exp(u * math.log(v)) - 1).to(torch.int32).clamp_(
        0, v - 1)
    del u
    seeds = torch.randint(0, v, (b,), generator=gen, device=cuda_device,
                          dtype=torch.int32)
    valid = torch.arange(b, device=cuda_device) < b - 12
    seeds = torch.where(valid, seeds, 0)

    def hop():
        return device_sampler._sample_hop(
            gen, seeds, valid, indptr, indices, fanout, num_src_pad,
            WeightKind.GCN, None, None)

    (own, own_over), (ref, ref_over) = both_ways(monkeypatch, gen, hop)
    assert int(own_over) == int(ref_over)
    assert (int(own_over) > 0) == (num_src_pad < 5632)
    assert_same_blocks([own], [ref])


# kernel launches of the trainer below's sampler op by op with the rank
# scatter that the sorted search replaced (NVIDIA H100 80GB HBM3, torch
# 2.11 with CUDA 12.8; the sorted search's: 226)
RANK_SCATTER_SAMPLE_LAUNCHES = 244


def _sample_launches(trainer, seeds, valid):
    """Kernel launches of the trainer's sampler op by op: what its CUDA
    graph holds."""
    from torch.profiler import ProfilerActivity, profile

    trainer._sample_batch(seeds, valid)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer._sample_batch(seeds, valid)
        torch.cuda.synchronize()
    return sum("LaunchKernel" in e.name()
               for e in prof.profiler.kineto_results.events())


def test_sample_launches_no_more_than_rank_scatter(cuda_device, monkeypatch):
    """The sampler of a 3-hop GATSAMPLEALLGPU trainer whose three hops
    all build a source set, op by op (the kernels its `sample` call's
    graph holds), launches no more kernels than under the rank scatter:
    than the count stated for it, and than the plain reference in the
    sampler's place."""
    ds = random_graph_dataset(20000, 10, 32, 5, seed=0)
    cfg = RunConfig(algorithm="GATSAMPLEALLGPU", layer_sizes=[32, 16, 16, 5],
                    fanout=[5, 3, 3], batch_size=128, heads=2,
                    vertices=20000)
    trainer = build_trainer(cfg, ds, device=cuda_device)
    assert max(trainer.src_pads) < trainer.dev_indptr.shape[0] - 1
    seeds, valid = next(trainer._seed_batches(trainer.train_nids, False))
    counters = timing.RECORDER.counters
    before = counters.get("sampler.rank_hops")
    own = _sample_launches(trainer, seeds, valid)
    # two `sample` calls (a warm one, then the profiled one), three hops each
    assert counters.get("sampler.rank_hops") - before == 2 * 3
    with monkeypatch.context() as m:
        m.setattr(device_sampler, "_source_set", rank_scatter_source_set)
        ref = _sample_launches(trainer, seeds, valid)
    print(f"sample launches: {own}, under the rank scatter {ref}")
    assert own <= ref
    assert own <= RANK_SCATTER_SAMPLE_LAUNCHES
