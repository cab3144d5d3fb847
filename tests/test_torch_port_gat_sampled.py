"""The sampled GAT layer's attention op (ops/gat_sampled.py) on the CPU.

Its plain versions, which the card's kernels are held to
(tests/test_torch_port_cuda.py), against the composition of the edge ops
of ops/aggregate.py (`scatter_src_to_edges`, the score einsums,
`edge_softmax`, `aggregate_edges_to_dst`): forward and gradients in h and
both halves of the attention vector in float64, gradcheck, bf16 rows
against f32; and `model_forward("gat")` on the CPU through the op.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sgnn_tpu_torch.models import gnn
from sgnn_tpu_torch.ops import gat_sampled as op
from sgnn_tpu_torch.ops.aggregate import (
    aggregate_edges_to_dst, edge_softmax, scatter_src_to_edges,
)
from sgnn_tpu_torch.ops.cuda import gat_sampled as kern
from sgnn_tpu_torch.ops.gat import NEG_SLOPE, pack_score_tables
from sgnn_tpu_torch.sampler.blocks import SampledBatch, SampledBlock

# float64 on both sides: only the order of the sums differs
F64 = 1e-12
# tests/test_torch_port_gat.py's bf16 bound (the Pallas kernel's)
BF16 = 3e-2
# float32 on both sides: the same sums in another order
F32 = 1e-5


def _torch_ops(h, a_src, a_dst, nbr, w, seed_in_src, heads):
    """A sampled GAT layer's attention aggregation after `h = x @ W` in the
    edge ops: the [D, K, F] edge tensors, the score einsums, `edge_softmax`
    and `aggregate_edges_to_dst`, with autograd's backward."""
    fprime = h.shape[-1]
    h_src_e = scatter_src_to_edges(h, nbr)
    h_dst = h.index_select(0, seed_in_src)
    mask = w != 0.0
    if heads > 1:
        fh = fprime // heads
        d, k = h_src_e.shape[0], h_src_e.shape[1]
        src_h = h_src_e.view(d, k, heads, fh)
        score = torch.einsum("dkhf,hf->dkh", src_h, a_src.view(heads, fh))
        score = score + torch.einsum("dhf,hf->dh", h_dst.view(d, heads, fh),
                                     a_dst.view(heads, fh))[:, None, :]
        att = edge_softmax(F.leaky_relu(score, NEG_SLOPE), mask)
        return aggregate_edges_to_dst(src_h, att).reshape(d, fprime)
    score = torch.einsum("dkf,f->dk", h_src_e, a_src) + (h_dst @ a_dst)[:, None]
    att = edge_softmax(F.leaky_relu(score, NEG_SLOPE), mask)
    return aggregate_edges_to_dst(h_src_e, att)


def _block(rng, d, k, s, hub=None):
    """Sampler-shaped slots: 30% padded (pointing at row 0, as the device
    sampler's), every 5th row with no valid slot, `hub` taking 60% of the
    slots; distinct seed rows."""
    nbr = rng.integers(0, s, (d, k)).astype(np.int32)
    if hub is not None:
        nbr[rng.random((d, k)) < 0.6] = hub
    w = (rng.random((d, k)) + 0.5).astype(np.float32)
    w[rng.random((d, k)) < 0.3] = 0.0
    w[::5] = 0.0
    nbr[w == 0] = 0
    seed = rng.permutation(s)[:d].astype(np.int32)
    return [torch.from_numpy(a) for a in (nbr, w, seed)]


def _inputs(heads, feat, k, d=37, s=61, hub=None, seed=0):
    rng = np.random.default_rng(seed)
    nbr, w, sd = _block(rng, d, k, s, hub)
    h = torch.from_numpy(rng.standard_normal((s, feat)))
    a = torch.from_numpy(rng.standard_normal(2 * feat) * 0.5)
    g = torch.from_numpy(rng.standard_normal((d, feat)))
    return h, a, nbr, w, sd, g


def _grads(fn, h, a, g):
    h = h.detach().requires_grad_()
    a = a.detach().requires_grad_()
    out = fn(h, a)
    return (out.detach(), *torch.autograd.grad(out, (h, a), g))


def _rel(got, ref):
    return ((got.double() - ref.double()).abs().max()
            / ref.double().abs().max()).item()


@pytest.mark.parametrize("hub", [None, 3])
@pytest.mark.parametrize("k", [10, 25])
@pytest.mark.parametrize("heads,feat", [(1, 41), (4, 128), (1, 128),
                                        (4, 16)])
def test_plain_matches_torch_ops(heads, feat, k, hub):
    """Forward and the gradients in h, a_src and a_dst (one vector a, both
    halves), float64, through the op and through the torch ops."""
    h, a, nbr, w, sd, g = _inputs(heads, feat, k, hub=hub, seed=feat + k)

    def ours(h, a):
        ts, td = pack_score_tables(h, a[:feat], a[feat:], heads)
        return op.gat_sampled_aggregate(h, ts, td, nbr, w, sd, heads)

    def theirs(h, a):
        return _torch_ops(h, a[:feat], a[feat:], nbr, w, sd, heads)

    got, ref = _grads(ours, h, a, g), _grads(theirs, h, a, g)
    for x, y in zip(got, ref):
        assert _rel(x, y) <= F64
    assert torch.equal(got[0][::5], torch.zeros_like(got[0][::5]))


@pytest.mark.parametrize("heads,feat,k", [(1, 5, 4), (2, 6, 3)])
def test_op_gradcheck(heads, feat, k):
    h, _, nbr, w, sd, _ = _inputs(heads, feat, k, d=9, s=11, hub=2)
    rng = np.random.default_rng(7)
    ts, td = (torch.from_numpy(rng.standard_normal((11, heads)))
              .requires_grad_() for _ in range(2))
    assert torch.autograd.gradcheck(
        lambda h_, ts_, td_: op.gat_sampled_aggregate(h_, ts_, td_, nbr, w,
                                                      sd, heads),
        (h.requires_grad_(), ts, td))


def test_padding_and_empty_rows_pass_nothing_back():
    """Padded slots point at row 0 with weight 0: row 0 gets no gradient
    from them, and a row with no valid slot passes nothing back."""
    heads, feat, k, d, s = 2, 8, 4, 6, 9
    h, a, nbr, w, sd, g = _inputs(heads, feat, k, d=d, s=s)
    w[:] = 0.0
    w[1, 2] = 1.0
    nbr[1, 2] = 5
    ts, td = pack_score_tables(h, a[:feat], a[feat:], heads)
    out, att = op.gat_sampled_fwd(h, ts, td, nbr, w, sd, heads)
    dh, dts, dtd = op.gat_sampled_bwd(g, h, ts, td, nbr, w, sd, att, heads)
    assert torch.equal(att[1, 2], torch.ones(heads, dtype=att.dtype))
    assert torch.equal(out[1], h[5])
    assert torch.count_nonzero(out[[0, 2, 3, 4, 5]]) == 0
    nz = torch.nonzero(dh.abs().sum(1))[:, 0].tolist()
    assert nz == [5] and torch.equal(dh[5], g[1])
    # one valid slot: att is 1 whatever its score, so no score gradient
    assert torch.count_nonzero(dts) == 0 and torch.count_nonzero(dtd) == 0


def test_bf16_rows_against_f32():
    heads, feat, k = 4, 128, 10
    h, a, nbr, w, sd, g = _inputs(heads, feat, k, d=64, s=90, hub=7)
    h, a, g = h.float(), a.float(), g.float()
    outs = []
    for dt in (torch.float32, torch.bfloat16):
        hh = h.to(dt).float().to(dt)

        def fn(x, aa):
            ts, td = pack_score_tables(x, aa[:feat], aa[feat:], heads)
            return op.gat_sampled_aggregate(x, ts, td, nbr, w, sd, heads)

        outs.append(_grads(fn, hh, a, g.to(dt)))
    for got, ref in zip(outs[1], outs[0]):
        assert got.dtype in (torch.bfloat16, torch.float32)
        assert _rel(got, ref) <= BF16


def test_rejects_bad_args():
    h, a, nbr, w, sd, g = _inputs(2, 8, 3, d=5, s=7)
    ts, td = pack_score_tables(h, a[:8], a[8:], 2)
    with pytest.raises(ValueError, match="heads=3"):
        op.gat_sampled_fwd(h, ts, td, nbr, w, sd, 3)
    with pytest.raises(ValueError, match="nbr must be"):
        op.gat_sampled_fwd(h, ts, td, nbr.long(), w, sd, 2)
    with pytest.raises(ValueError, match="seed_in_src must be"):
        op.gat_sampled_fwd(h, ts, td, nbr, w, sd[:4], 2)
    with pytest.raises(ValueError, match="ts must be"):
        op.gat_sampled_fwd(h, ts.float(), td, nbr, w, sd, 2)
    _, att = op.gat_sampled_fwd(h, ts, td, nbr, w, sd, 2)
    with pytest.raises(ValueError, match="g must be"):
        op.gat_sampled_bwd(g.float(), h, ts, td, nbr, w, sd, att, 2)
    with pytest.raises(ValueError, match="att must be"):
        op.gat_sampled_bwd(g, h, ts, td, nbr, w, sd, att[:, :2], 2)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        kern.gat_sampled_fwd_cuda(h.float(), ts.float(), td.float(), nbr, w,
                                  sd, 2)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        kern.gat_sampled_bwd_cuda(g.float(), h.float(), ts.float(),
                                  td.float(), nbr, w, sd, att.float(), 2)


def _batch(seed=0):
    """A two-block sampled batch: 602-wide rows reduced to [48, 16, 5]."""
    rng = np.random.default_rng(seed)
    blocks, srcs = [], 80
    for d, k in ((40, 6), (12, 4)):
        nbr, w, sd = _block(rng, d, k, srcs, hub=1)
        blocks.append(SampledBlock(
            nbr=nbr, weight=w, srcs=torch.arange(srcs, dtype=torch.int32),
            seeds=sd, dst_valid=torch.ones(d, dtype=torch.bool),
            src_valid=torch.ones(srcs, dtype=torch.bool), seed_in_src=sd))
        srcs = d
    x0 = torch.from_numpy(rng.standard_normal((80, 48)).astype(np.float32))
    return SampledBatch(blocks=blocks, x0=x0,
                        labels=torch.zeros(12, dtype=torch.int64),
                        label_valid=torch.ones(12, dtype=torch.bool))


@pytest.mark.parametrize("heads", [1, 4])
def test_cpu_model_forward_is_the_op(monkeypatch, heads):
    """On the CPU `model_forward("gat")` takes the op, as the card does:
    bit for bit the layer composed here from `pack_score_tables` and
    `gat_sampled_aggregate`, one op call a layer, and within float32's
    rounding of the edge ops' composition."""
    batch = _batch()
    p = gnn.init_model(3, "gat", [48, 16, 5], device="cpu")
    gen = torch.Generator().manual_seed(1)
    p = p._replace(attn=tuple(torch.randn(a.shape, generator=gen)
                              for a in p.attn))
    calls = []

    def counted(*args):
        calls.append(args[-1])
        return op.gat_sampled_aggregate(*args)

    monkeypatch.setattr(gnn, "gat_sampled_aggregate", counted)
    got = gnn.model_forward(p, "gat", batch, heads=heads)
    assert calls == [heads, 1]
    x = y = batch.x0
    for l, blk in enumerate(batch.blocks):
        hd = 1 if l == len(batch.blocks) - 1 else heads
        h, g = x @ p.weights[l], y @ p.weights[l]
        f = h.shape[1]
        a_src, a_dst = p.attn[l][:f, 0], p.attn[l][f:, 0]
        ts, td = pack_score_tables(h, a_src, a_dst, hd)
        x = torch.relu(op.gat_sampled_aggregate(h, ts, td, blk.nbr,
                                                blk.weight, blk.seed_in_src,
                                                hd))
        y = torch.relu(_torch_ops(g, a_src, a_dst, blk.nbr, blk.weight,
                                  blk.seed_in_src, hd))
    assert torch.equal(got, torch.log_softmax(x.float(), dim=-1))
    assert _rel(got, torch.log_softmax(y.float(), dim=-1)) <= F32
