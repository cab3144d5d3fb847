"""PyG's ogbn-products GAT with GATv2Conv layers on the port's sampled
path (RunConfig gat_variant "pyg_v2", models/gnn._pyg_attention) against
the plain reference `benchmark/reference/gatv2_pyg.py`, on the CPU at a
small size: 100-32x4-32x4-8x4 mean, fan-out 3-3-3, batch 8, on
300-vertex graphs with and without self-loops; seeded random weights,
every leaf drawn.

The op's plain path by gradcheck in float64; the loss and every leaf's
gradient in float64 (only the order of sums differs), dropout from the
program's recorded masks; three training steps of the float32 trainer
against torch's Adam in float64; the leaves and the parameter count at
the published widths; the engines and the reference-only forwards that
refuse the variant; the `attention` span and the op's counters.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from benchmark import spec
from sgnn_tpu_torch.config import parse_cfg_text
from sgnn_tpu_torch.models import gnn
from sgnn_tpu_torch.ops import gat_sampled as gat_op
from sgnn_tpu_torch.ops import gatv2_sampled as op
from sgnn_tpu_torch.train import build_trainer
from sgnn_tpu_torch.train.checkpoint import load_params, params_state
from sgnn_tpu_torch.train.trainer import loss_and_grads
from sgnn_tpu_torch.utils import roofline, timing

from test_torch_port_gat_pyg import (
    F32, F64, HEADS, WIDTHS, _cfg as _pyg_cfg, _dataset, _Masks,
    _random_leaves, _ref_inputs, _reference_forward, _sampled_self_loops,
)

ref = spec.reference_module("gatv2_pyg")
PUBLISHED = [100, 512, 512, 47]


def _cfg(**kw):
    return _pyg_cfg(**{"gat_variant": "pyg_v2", **kw})


def _block(rng, d, k, s):
    """A sampled block under the self-loop rule: padded slots, a row with
    no sampled slot, a padded destination."""
    nbr = torch.from_numpy(rng.integers(0, s, (d, k)).astype(np.int32))
    seed = torch.from_numpy(rng.permutation(s)[:d].astype(np.int32))
    w = torch.from_numpy((rng.random((d, k)) > 0.3).astype(np.float32))
    w[2] = 0.0
    w[-1] = 0.0
    valid = torch.ones(d, dtype=torch.bool)
    valid[-1] = False
    return gat_op.own_row_slots(nbr, w, seed, valid)


@pytest.mark.parametrize("heads,c", [(2, 3), (1, 4)])
def test_the_ops_plain_path_passes_gradcheck(heads, c):
    rng = np.random.default_rng(heads * 10 + c)
    d, k, s = 6, 3, 10
    nbr, w = _block(rng, d, k, s)
    xl, xr, att = (torch.from_numpy(rng.standard_normal(shape))
                   .requires_grad_() for shape in
                   ((s, heads * c), (d, heads * c), (heads * c,)))
    assert torch.autograd.gradcheck(
        lambda a, b, t: op.gatv2_sampled_aggregate(a, b, t, nbr, w, heads),
        (xl, xr, att))
    out, alpha = op.gatv2_sampled_fwd(xl.detach(), xr.detach(),
                                      att.detach(), nbr, w, heads)
    # a padded destination attends to nothing; a row with no sampled slot
    # to its own row alone
    assert torch.count_nonzero(out[-1]) == 0
    assert torch.count_nonzero(alpha[-1]) == 0
    assert torch.allclose(out[2], xl.detach()[nbr[2, k].long()])


def test_uniform_attention_is_the_mean_of_the_sources():
    """att = 0: every score is 0, so each destination averages its valid
    slots' rows, whatever xr holds."""
    rng = np.random.default_rng(4)
    nbr, w = _block(rng, 7, 4, 12)
    xl = torch.from_numpy(rng.standard_normal((12, 8)))
    xr = torch.from_numpy(rng.standard_normal((7, 8)))
    out = op.gatv2_sampled_aggregate(xl, xr, torch.zeros(8, dtype=xl.dtype),
                                     nbr, w, 2)
    keep = (w != 0).double()
    mean = (xl[nbr.long()] * keep[..., None]).sum(1) / keep.sum(
        1, keepdim=True).clamp_min(1)
    assert torch.allclose(out, mean)


@pytest.mark.parametrize("train", [True, False], ids=["dropout", "eval"])
@pytest.mark.parametrize("self_loops", [True, False],
                         ids=["sampled_self_loops", "no_self_loops"])
def test_loss_and_gradients_match_the_reference_f64(monkeypatch, self_loops,
                                                    train):
    """The program's forward and backward in float64 (the CPU's plain
    ops): the loss and each of the 24 leaves' gradients against the
    reference's, with dropout from the program's own masks."""
    ds = _dataset(self_loops)
    tr = build_trainer(_cfg(), ds, device="cpu")
    params = _random_leaves(tr.params, 11, torch.float64)
    assert params.gatv2 and params.gatconv
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
    assert len(out.grads) == 24
    for g, r in zip(out.grads, grads):
        assert float(r.norm()) > 0
        assert (g - r).norm() <= F64 * max(float(r.norm()), 1e-30)


def test_three_adam_steps_match_torch_adam(monkeypatch):
    """The float32 trainer's first three steps through `train_step` (its
    Adam, eps 1e-8, bias-corrected) against the reference's torch Adam in
    float64 from the same leaves, blocks and masks: each loss, the first
    gradient (from the first moment) and each leaf's change.

    GATv2 makes gradients that are zero but for round-off: where every
    slot of a destination takes one slope of leaky_relu in a column,
    dxr's column is att · slope · Σ dscore, and Σ dscore is 0.  At these
    sizes whole columns of WR_l get such gradients, and Adam moves their
    elements by about a learning rate a step with round-off's sign.  So
    the changes are compared over the elements whose reference gradient
    is above round-off, and the others are held to Adam's step bound."""
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
    for p, q, r, g in zip(tr.params.leaves(), p0, got["params"],
                          got["grad1"]):
        mine, theirs = p.double() - q.double(), r - q.double()
        above = g.abs() > 1e-9 * g.abs().max()
        assert above.float().mean() > 0.5
        # as the pyg stack's test: Adam's 1 - beta^t in float32
        assert ((mine - theirs)[above].norm()
                <= 1e-3 * theirs[above].norm())
        # three steps of Adam move an element by at most 3 learning rates
        small = mine[~above].abs()
        assert small.numel() == 0 or float(small.max()) <= 3e-3 * 1.001


def test_the_published_widths_hold_1162386_parameters():
    """24 leaves: the pyg stack's 15 with att [H·C, 1], then bL, WR, bR;
    156,160 + 788,992 + 217,234 by layer."""
    p = gnn.init_model(0, "gat", PUBLISHED, heads=4, gat_variant="pyg_v2",
                       device="cpu")
    shapes = [tuple(t.shape) for t in p.leaves()]
    assert shapes == [(100, 512), (512, 512), (512, 188), (512, 1),
                      (512, 1), (188, 1), (512,), (512,), (47,),
                      (100, 512), (512, 512), (512, 47), (512,), (512,),
                      (47,), (512,), (512,), (188,), (100, 512),
                      (512, 512), (512, 188), (512,), (512,), (188,)]
    assert sum(t.numel() for t in p.leaves()) == 1_162_386
    per_layer = [sum(g[l].numel() for g in p) for l in range(3)]
    assert per_layer == [156_160, 788_992, 217_234]
    assert p.gatv2 and p.gatconv
    gnn.check_heads(p, "gat", 4)
    assert [s for _, s, _ in ref.leaves({"layer_sizes": PUBLISHED,
                                         "heads": 4})] == shapes
    pyg = gnn.init_model(0, "gat", PUBLISHED, heads=4, gat_variant="pyg",
                         device="cpu")
    assert not pyg.gatv2 and len(pyg.leaves()) == 15
    with pytest.raises(ValueError, match="attention vector"):
        gnn.check_heads(p._replace(attn=pyg.attn), "gat", 4)
    with pytest.raises(ValueError, match="pyg_v2"):
        gnn.check_heads(p._replace(bias_r=p.bias_r[:2]), "gat", 4)


def test_the_checkpoint_carries_every_group():
    p = _random_leaves(gnn.init_model(0, "gat", WIDTHS, heads=HEADS,
                                      gat_variant="pyg_v2", device="cpu"), 3)
    back = load_params(params_state(p), p.replace_leaves(
        [torch.zeros_like(t) for t in p.leaves()]))
    assert all(torch.equal(a, b) for a, b in zip(back.leaves(), p.leaves()))
    pyg_state = params_state(_random_leaves(gnn.init_model(
        0, "gat", WIDTHS, heads=HEADS, gat_variant="pyg", device="cpu"), 3))
    with pytest.raises(ValueError, match="shapes"):
        load_params(pyg_state, p)


@pytest.mark.parametrize("algorithm,extra", [
    ("GATFULLBATCH", {}), ("GATSAMPLEPDCACHE", {}),
    ("GATSAMPLEALLMULTI", {}), ("GCNSAMPLEALLGPU", {}),
    ("GATSAMPLEALLGPU", {"pushdown": True})])
def test_other_engines_refuse_the_variant_by_name(algorithm, extra):
    with pytest.raises(ValueError, match="pyg_v2"):
        build_trainer(_cfg(algorithm=algorithm, **extra), _dataset(True),
                      device="cpu")


@pytest.mark.parametrize("where", [
    "full_forward", "InferenceServer", "layerwise_inference.whole"])
def test_reference_only_forwards_refuse_the_gatv2_stack(where):
    """The whole-graph forward and serving run the reference stack alone
    and name both PyG stacks when they refuse one."""
    v2 = gnn.init_model(0, "gat", WIDTHS, heads=HEADS, gat_variant="pyg_v2",
                        device="cpu")
    with pytest.raises(ValueError, match="GATv2Conv"):
        _reference_forward(where, v2, _dataset(True))


def test_the_cfg_key_and_init_model():
    cfg = parse_cfg_text("ALGORITHM:GATSAMPLEALLGPU\nGAT_VARIANT:pyg_v2\n")
    assert cfg.gat_variant == "pyg_v2"
    with pytest.raises(ValueError, match="gat_variant"):
        gnn.init_model(0, "gcn", WIDTHS, gat_variant="pyg_v2")


def test_one_attention_span_and_one_count_each_way_a_layer():
    """A training step opens one `attention` span a layer while a profiler
    records, and raises `attention.gatv2_forwards` and
    `attention.gatv2_backwards` by one a layer, traced or not."""
    tr = build_trainer(_cfg(), _dataset(True), device="cpu")
    batch = tr.sample(*next(iter(tr._seed_batches(tr.train_nids, False))))
    counters = timing.RECORDER.counters

    def counts():
        d = counters.as_dict()
        return [d.get(f"attention.gatv2_{k}", 0)
                for k in ("forwards", "backwards")]

    before = counts()
    tr.train_step(batch)
    assert [a - b for a, b in zip(counts(), before)] == [3, 3]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        timing.RECORDER.clear()
        tr.train_step(batch)
        names = [r["name"] for r in timing.RECORDER.records()]
    assert names.count("attention") == 3 and names.count("epilogue") == 3


def test_the_harness_calls_are_the_reference():
    """What the harness calls of the reference: its leaves are the
    program's, in the program's order, and its `train_steps` (the
    harness's signature, from the configuration) are `adam_steps`."""
    cfg = {"layer_sizes": WIDTHS, "heads": HEADS, "drop_rate": 0.5,
           "learn_rate": 1e-3, "weight_decay": 0.0,
           "adam": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}}
    p = gnn.init_model(0, "gat", WIDTHS, heads=HEADS, gat_variant="pyg_v2",
                       device="cpu")
    assert [s for _, s, _ in ref.leaves(cfg)] == [tuple(t.shape)
                                                  for t in p.leaves()]
    ds = _dataset(True)
    tr = build_trainer(_cfg(), ds, device="cpu")
    batch = tr.sample(*next(iter(tr._seed_batches(tr.train_nids, False))))
    inp = _ref_inputs(ds, batch, [])
    p0 = _random_leaves(p, 4).leaves()
    a = ref.train_steps(cfg, True, p0, [inp])
    b = ref.adam_steps(p0, [inp], HEADS, 0.5, 1e-3, eps=1e-8)
    assert a["losses"] == b["losses"] and math.isfinite(a["losses"][0])
    assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))


# gatv2_products' three layers, (D, K, S, F, H, nnz, dv, sv) as one
# random block of each read on the card: K the sampled slots
PRODUCTS_LAYERS = [(61_952, 10, 681_472, 512, 4, 493_197, 55_899, 378_514),
                   (5_632, 10, 61_952, 512, 4, 44_706, 5_070, 34_256),
                   (512, 10, 5_632, 188, 4, 4_511, 512, 3_341)]


@pytest.mark.parametrize("layer", PRODUCTS_LAYERS, ids=["l0", "l1", "l2"])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_the_pair_bound_is_the_benchmarks_frozen_copy(backward, layer):
    """`roofline.kernel_bound` of the GATv2 pair (K with the own-row slot)
    is the work the benchmark's reference module froze (`pair_work`, K
    the sampled slots), at each of gatv2_products' layers."""
    D, K, S, F, H, nnz, dv, sv = layer
    got = roofline.kernel_bound(
        f"gatv2_sampled_{'bwd' if backward else 'fwd'}",
        "NVIDIA H100 80GB HBM3", 4, D=D, K=K + 1, S=S, F=F, H=H, nnz=nnz,
        dv=dv, sv=sv)
    want = ref.pair_work(D, K, S, F, H, nnz, dv, sv, backward)
    assert (got["bytes_once"], got["operations"]) == want
    assert got["bound_by"] == "bytes"
    assert got["gather_bytes"] > got["bytes_once"]
