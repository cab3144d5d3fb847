"""PyG's ogbn-products GAT on the port's sampled path (RunConfig
gat_variant "pyg", models/gnn._pyg_gat_layer) against the plain reference
`benchmark/reference/gat_pyg.py`, on the CPU at a small size: 100-32x4-32x4-8x4
mean, fan-out 3-3-3, batch 8, on 300-vertex graphs with and without
self-loops; seeded random weights, every leaf drawn.

The loss and every leaf's gradient in float64 (only the order of sums
differs), dropout from the program's recorded masks; three training steps
of the float32 trainer against torch's Adam in float64; the parameter
count at the published widths; the other families' leaves unchanged; the
engines and the reference-only forwards that refuse the variant; the
harness's calls of the reference.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import spec
from sgnn_tpu_torch.config import RunConfig, parse_cfg_text
from sgnn_tpu_torch.data.synthetic import random_graph_dataset
from sgnn_tpu_torch.graph.adjacency import Adjacency
from sgnn_tpu_torch.models import gnn
from sgnn_tpu_torch.ops import gat_sampled as op
from sgnn_tpu_torch.ops.aggregate import (
    aggregate_edges_to_dst, edge_softmax, scatter_src_to_edges,
)
from sgnn_tpu_torch.ops.gat import NEG_SLOPE
from sgnn_tpu_torch.ops.segment import csr_from_numpy, csr_transpose
from sgnn_tpu_torch.sampler.blocks import WeightKind
from sgnn_tpu_torch.train import build_trainer
from sgnn_tpu_torch.train.checkpoint import load_params, params_state
from sgnn_tpu_torch.train.fullbatch import build_coo, full_forward
from sgnn_tpu_torch.train.inference import (
    InferenceServer, layerwise_inference,
)
from sgnn_tpu_torch.train.trainer import loss_and_grads
from sgnn_tpu_torch.utils import timing

ref = spec.reference_module("gat_pyg")

WIDTHS = [100, 32 * 4, 32 * 4, 8]
HEADS = 4
# float64 on both sides: only the order of the sums differs
F64 = 1e-10
# the float32 program against the float64 reference: a leaf's gradient
# norm and a step's loss carry float32 round-off of ~1e-7 relative
F32 = 1e-5


def _dataset(self_loops: bool, seed: int = 3):
    ds = random_graph_dataset(300, 6, WIDTHS[0], WIDTHS[-1], seed=seed)
    if not self_loops:
        e = ds.edges
        ds = dataclasses.replace(ds, edges=e[e[:, 0] != e[:, 1]])
    return ds


def _cfg(**kw):
    base = dict(algorithm="GATSAMPLEALLGPU", layer_sizes=list(WIDTHS),
                heads=HEADS, fanout=[3, 3, 3], batch_size=8,
                gat_variant="pyg", adam_epsilon=1e-8, learn_rate=1e-3,
                weight_decay=0.0, decay_rate=1.0, decay_epoch=0,
                drop_rate=0.5, vertices=300, seed=5,
                estimator_advisor="off")
    base.update(kw)
    return RunConfig(**base)


def _random_leaves(params, seed, dtype=torch.float32):
    """Every leaf uniform in +-sqrt(6 / (fan_in + fan_out)) (a 1-D leaf's
    fans its width and 1), from one generator."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for t in params.leaves():
        fi, fo = (t.shape[0], t.shape[1]) if t.dim() == 2 else (t.shape[0], 1)
        b = math.sqrt(6.0 / (fi + fo))
        out.append((torch.rand(t.shape, generator=gen, dtype=torch.float64)
                    * 2 - 1).mul(b).to(dtype))
    return params.replace_leaves(out)


def _global_layers(batch):
    """The batch's blocks as the reference takes them: valid destinations
    and their slots as global ids, -1 where a slot holds no edge."""
    out = []
    for blk in batch.blocks:
        valid = blk.dst_valid
        nbr = blk.srcs.long()[blk.nbr[valid].long()]
        out.append({"dst": blk.seeds[valid].long(),
                    "nbr": torch.where(blk.weight[valid] != 0, nbr, -1)})
    return out


class _Masks:
    """The module's dropout, recording each call's keep mask."""

    def __init__(self, monkeypatch):
        self.masks = []
        orig = gnn.dropout

        def dropout(generator, x, rate, train):
            out = orig(generator, x, rate, train)
            self.masks.append(out != 0)
            return out

        monkeypatch.setattr(gnn, "dropout", dropout)


def _ref_inputs(ds, batch, masks):
    layers = _global_layers(batch)
    top = layers[-1]["dst"]
    return {"x": torch.from_numpy(ds.features),
            "edges": ref.layer_edges(layers),
            "masks": [m[batch.blocks[l].dst_valid]
                      for l, m in enumerate(masks)],
            "labels": torch.from_numpy(ds.labels.astype(np.int64))[top],
            "rows": torch.arange(top.numel())}


def _sampled_self_loops(batch) -> int:
    return sum(int(((blk.nbr == blk.seed_in_src[:, None])
                    & (blk.weight != 0)).sum()) for blk in batch.blocks)


@pytest.mark.parametrize("train", [True, False], ids=["dropout", "eval"])
@pytest.mark.parametrize("self_loops", [True, False],
                         ids=["sampled_self_loops", "no_self_loops"])
def test_loss_and_gradients_match_the_reference_f64(monkeypatch, self_loops,
                                                    train):
    """The program's forward and backward in float64 (the CPU's plain
    ops): the loss and every leaf's gradient against the reference's,
    with dropout from the program's own masks; the head mean on the last
    layer and the self-loop rule are in both."""
    ds = _dataset(self_loops)
    tr = build_trainer(_cfg(), ds, device="cpu")
    params = _random_leaves(tr.params, 11, torch.float64)
    batch = tr.sample(*next(iter(tr._seed_batches(tr.train_nids[:8],
                                                  False))))
    assert (_sampled_self_loops(batch) > 0) == self_loops
    batch = dataclasses.replace(batch, x0=batch.x0.double())
    rec = _Masks(monkeypatch)
    out = loss_and_grads(params, "gat", batch, drop_rate=0.5,
                         generator=tr.generator if train else None,
                         heads=HEADS)
    assert len(rec.masks) == (2 if train else 0)
    inp = _ref_inputs(ds, batch, rec.masks)
    leaves = [t.clone().requires_grad_() for t in params.leaves()]
    loss = ref.nll(ref.forward(leaves, inp["x"].double(), inp["edges"],
                               inp["masks"], HEADS, 0.5), inp["labels"],
                   inp["rows"])
    grads = torch.autograd.grad(loss, leaves)
    loss = float(loss.detach())
    assert abs(float(out.loss) - loss) <= F64 * abs(loss)
    assert len(out.grads) == 15
    for g, r in zip(out.grads, grads):
        assert (g - r).norm() <= F64 * max(float(r.norm()), 1e-30)


def test_three_adam_steps_match_torch_adam(monkeypatch):
    """The float32 trainer's first three steps through `train_step` (its
    Adam, eps 1e-8, bias-corrected) against the reference's torch Adam in
    float64 from the same leaves, blocks and masks: each loss, the first
    gradient (from the first moment) and each leaf's change."""
    ds = _dataset(True)
    tr = build_trainer(_cfg(), ds, device="cpu")
    tr.params = _random_leaves(tr.params, 12)
    tr.opt_state = tr.optimizer.init(tr.params.leaves())
    p0 = [t.clone() for t in tr.params.leaves()]
    rec = _Masks(monkeypatch)
    steps, losses, m1 = [], [], None
    for seeds, valid in list(tr._seed_batches(tr.train_nids, True))[:3]:
        rec.masks.clear()
        batch = tr.sample(seeds, valid)
        loss, _ = tr.train_step(batch)
        losses.append(float(loss))
        steps.append(_ref_inputs(ds, batch, list(rec.masks)))
        m1 = m1 or [m.clone() for m in tr.opt_state.m]
    got = ref.adam_steps(p0, steps, HEADS, 0.5, 1e-3, eps=1e-8)
    for a, b in zip(losses, got["losses"]):
        assert abs(a - b) <= F32 * abs(b)
    for m, g in zip(m1, got["grad1"]):
        assert (m.double() / 0.1 - g).norm() <= F32 * max(float(g.norm()),
                                                          1e-30)
    for p, q, r in zip(tr.params.leaves(), p0, got["params"]):
        mine, theirs = p.double() - q.double(), r - q.double()
        # the port's Adam takes 1 - beta^t in float32 (1.3e-5 off in
        # beta2's), torch's in float64: a change 6.6e-6 apart, and an
        # element whose gradient is round-off small may take another sign
        assert (mine - theirs).norm() <= 1e-3 * theirs.norm()


def test_the_published_widths_hold_751574_parameters():
    p = gnn.init_model(0, "gat", [100, 512, 512, 47], heads=4,
                       gat_variant="pyg", device="cpu")
    shapes = [tuple(t.shape) for t in p.leaves()]
    assert shapes == [(100, 512), (512, 512), (512, 188), (1024, 1),
                      (1024, 1), (376, 1), (512,), (512,), (47,),
                      (100, 512), (512, 512), (512, 47), (512,), (512,),
                      (47,)]
    assert sum(t.numel() for t in p.leaves()) == 751_574
    assert p.gatconv
    gnn.check_heads(p, "gat", 4)


@pytest.mark.parametrize("family,attn", [("gcn", []), ("sage", []),
                                         ("gat", [(256, 1), (82, 1)])])
def test_the_other_families_leaves_are_unchanged(family, attn):
    p = gnn.init_model(0, family, [602, 128, 41], device="cpu")
    assert [tuple(t.shape) for t in p.leaves()] == [(602, 128),
                                                    (128, 41)] + attn
    assert p.bias == p.skip_w == p.skip_b == ()
    again = p.replace_leaves([t + 1 for t in p.leaves()])
    assert [tuple(t.shape) for t in again.weights] == [(602, 128), (128, 41)]
    assert len(again.attn) == len(attn) and not again.gatconv
    with pytest.raises(ValueError, match="gat_variant"):
        gnn.init_model(0, family, [602, 128, 41], device="cpu",
                       gat_variant="pyg" if family != "gat" else "dgl")


def test_the_checkpoint_carries_every_group():
    p = _random_leaves(gnn.init_model(0, "gat", WIDTHS, heads=HEADS,
                                      gat_variant="pyg", device="cpu"), 3)
    back = load_params(params_state(p), p.replace_leaves(
        [torch.zeros_like(t) for t in p.leaves()]))
    assert all(torch.equal(a, b) for a, b in zip(back.leaves(), p.leaves()))
    old = {"weights": params_state(p)["weights"], "attn": []}
    with pytest.raises(ValueError, match="shapes"):
        load_params(old, p)


@pytest.mark.parametrize("algorithm,extra", [
    ("GATFULLBATCH", {}), ("GATSAMPLEPDCACHE", {}),
    ("GATSAMPLEALLMULTI", {}), ("GATSAMPLEPCMULTI", {}),
    ("GCNSAMPLEALLGPU", {}), ("GATSAMPLEALLGPU", {"pushdown": True})])
def test_other_engines_refuse_the_variant_by_name(algorithm, extra):
    with pytest.raises(ValueError, match="gat_variant"):
        build_trainer(_cfg(algorithm=algorithm, **extra), _dataset(True),
                      device="cpu")


def test_the_cfg_keys():
    cfg = parse_cfg_text("ALGORITHM:GATSAMPLEALLGPU\nGAT_VARIANT:pyg\n"
                         "ADAM_EPSILON:1e-8\n")
    assert (cfg.gat_variant, cfg.adam_epsilon) == ("pyg", 1e-8)
    assert (RunConfig().gat_variant, RunConfig().adam_epsilon) == ("", 1e-9)
    with pytest.raises(ValueError, match="gat_variant"):
        gnn.init_model(0, "gat", WIDTHS, heads=HEADS, gat_variant="dgl")


def _edge_ops(h, a, nbr, w, seed_in_src, heads):
    """A sampled GAT layer's attention aggregation in the edge ops of
    ops/aggregate.py: the [D, K, F'] edge tensors, the score einsums,
    `edge_softmax`, `aggregate_edges_to_dst`."""
    (d, k), fprime = nbr.shape, h.shape[-1]
    fh = fprime // heads
    src_h = scatter_src_to_edges(h, nbr).view(d, k, heads, fh)
    h_dst = h.index_select(0, seed_in_src).view(d, heads, fh)
    score = (torch.einsum("dkhf,hf->dkh", src_h,
                          a[:fprime, 0].view(heads, fh))
             + torch.einsum("dhf,hf->dh", h_dst,
                            a[fprime:, 0].view(heads, fh))[:, None, :])
    att = edge_softmax(F.leaky_relu(score, NEG_SLOPE), w != 0.0)
    return aggregate_edges_to_dst(src_h, att).reshape(d, fprime)


@pytest.mark.parametrize("heads,feat", [(4, 16), (4, 12), (1, 5)])
def test_own_row_slots_on_both_paths(heads, feat):
    """The self-loop rule's block: a sampled self slot masked, the own row
    one more slot (weight 0 on a padded destination); the edge ops and the
    op's plain version agree over it in float64."""
    rng = np.random.default_rng(feat)
    d, k, s = 9, 4, 14
    nbr = torch.from_numpy(rng.integers(0, s, (d, k)).astype(np.int32))
    seed = torch.from_numpy(rng.permutation(s)[:d].astype(np.int32))
    nbr[0, 1] = seed[0]
    w = torch.ones((d, k))
    w[2] = 0.0
    w[-1] = 0.0    # a padded destination, as the sampler leaves it
    valid = torch.ones(d, dtype=torch.bool)
    valid[-1] = False
    nbr2, w2 = op.own_row_slots(nbr, w, seed, valid)
    assert nbr2.shape == (d, k + 1) and torch.equal(nbr2[:, k], seed)
    assert torch.equal(w2[:, :k], torch.where(nbr == seed[:, None], 0.0, w))
    assert torch.equal(w2[:, k], valid.float())
    h = torch.from_numpy(rng.standard_normal((s, feat)))
    a = torch.from_numpy(rng.standard_normal((2 * feat, 1)))
    plain = _edge_ops(h, a, nbr2, w2, seed, heads)
    ts, td = gnn.pack_score_tables(h, a[:feat, 0], a[feat:, 0], heads)
    fused = op.gat_sampled_aggregate(h, ts, td, nbr2, w2, seed, heads)
    assert (plain - fused).abs().max() <= F64 * plain.abs().max()
    # row 2 has no sampled slot: it attends to its own row alone
    assert torch.allclose(plain[2], h[seed[2].long()])
    assert torch.count_nonzero(plain[-1]) == 0


def test_one_epilogue_span_a_layer():
    """Each layer records one `epilogue` span a forward while a profiler
    records."""
    ds = _dataset(True)
    tr = build_trainer(_cfg(), ds, device="cpu")
    batch = tr.sample(*next(iter(tr._seed_batches(tr.train_nids, False))))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        timing.RECORDER.clear()
        tr.train_step(batch)
        names = [r["name"] for r in timing.RECORDER.records()]
    assert names.count("epilogue") == 3


def _reference_forward(where, params, ds):
    """Call `where`, a forward that runs the reference stack alone, with
    `params` over `ds`'s whole graph."""
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    if where == "full_forward":
        src, _, w = build_coo(adj, WeightKind.NONE)
        v = adj.num_vertices
        csr = csr_from_numpy(adj.indptr, src, w, v, "cpu")
        csr_t = csr_from_numpy(*csr_transpose(adj.indptr, src, w, v), v,
                               "cpu")
        return full_forward(params, "gat", torch.from_numpy(ds.features),
                            csr, heads=HEADS, graph_t=csr_t)
    if where == "update_params":
        ref_params = gnn.init_model(0, "gat", WIDTHS, heads=HEADS,
                                    device="cpu")
        srv = InferenceServer(ref_params, "gat", adj, ds.features,
                              heads=HEADS, device="cpu")
        return srv.update_params(params)
    if where == "InferenceServer":
        return InferenceServer(params, "gat", adj, ds.features, heads=HEADS,
                               device="cpu").logprobs()
    return layerwise_inference(params, "gat", adj, ds.features, heads=HEADS,
                               whole_graph=where.endswith("whole"),
                               chunk_size=64, device="cpu")


@pytest.mark.parametrize("where", [
    "full_forward", "InferenceServer", "update_params",
    "layerwise_inference.whole", "layerwise_inference.chunked"])
def test_reference_only_forwards_refuse_gatconv(where):
    """The whole-graph forward and serving run the reference stack alone:
    PyG's GATConv parameters (biases, skips) raise, where a reference GAT
    of the same widths and heads runs."""
    ds = _dataset(True)
    pyg = gnn.init_model(0, "gat", WIDTHS, heads=HEADS, gat_variant="pyg",
                         device="cpu")
    ref_gat = gnn.init_model(0, "gat", WIDTHS, heads=HEADS, device="cpu")
    _reference_forward(where, ref_gat, ds)
    with pytest.raises(ValueError, match="GATConv"):
        _reference_forward(where, pyg, ds)
    skips_only = ref_gat._replace(skip_w=pyg.skip_w)
    with pytest.raises(ValueError, match="GATConv"):
        _reference_forward(where, skips_only, ds)


def test_the_harness_calls_are_the_reference():
    """What the harness calls of the reference: its leaves are the
    program's, in the program's order, and its `train_steps` (the
    harness's signature, from the configuration) are `adam_steps`."""
    cfg = {"layer_sizes": WIDTHS, "heads": HEADS, "drop_rate": 0.5,
           "learn_rate": 1e-3, "weight_decay": 0.0,
           "adam": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}}
    decl = ref.leaves(cfg)
    p = gnn.init_model(0, "gat", WIDTHS, heads=HEADS, gat_variant="pyg",
                       device="cpu")
    assert [s for _, s, _ in decl] == [tuple(t.shape) for t in p.leaves()]
    ds = _dataset(True)
    tr = build_trainer(_cfg(), ds, device="cpu")
    batch = tr.sample(*next(iter(tr._seed_batches(tr.train_nids, False))))
    layers = _global_layers(batch)
    inp = {"x": torch.from_numpy(ds.features),
           "edges": ref.sampled_edges(cfg, layers, 300, None, None, "cpu"),
           "masks": [None, None],
           "labels": torch.from_numpy(ds.labels.astype(np.int64))[
               layers[-1]["dst"]],
           "rows": torch.arange(layers[-1]["dst"].numel())}
    p0 = _random_leaves(p, 4).leaves()
    a = ref.train_steps(cfg, True, p0, [inp])
    b = ref.adam_steps(p0, [inp], HEADS, 0.5, 1e-3, eps=1e-8)
    assert a["losses"] == b["losses"]
    assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
