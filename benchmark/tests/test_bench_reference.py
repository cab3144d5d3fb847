"""The plain reference against hand-worked tiny GCN and GAT steps: loops
over edges in float64 numpy for the forward pass, central differences for
the gradients, the update rule written out; and its sample check against
planted violations."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import spec

ref = spec.reference_module("gnn")

# 5 vertices; (src, dst) edges with a self-loop on each vertex and one
# repeated edge
EDGES = [(0, 1), (2, 1), (3, 1), (1, 0), (4, 2), (0, 2), (2, 3), (3, 4),
         (0, 4), (0, 4), (0, 0), (1, 1), (2, 2), (3, 3), (4, 4)]
V = 5
CFG = {"layer_sizes": [3, 4, 2], "heads": 2, "drop_rate": 0.5,
       "learn_rate": 0.01, "weight_decay": 1e-4, "decay_rate": 0.97,
       "decay_epoch": 100, "leaky_relu_slope": 0.2,
       "adam": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-9}}


def _data(seed=0):
    g = np.random.default_rng(seed)
    x = g.standard_normal((V, 3))
    w = [g.uniform(-1, 1, (3, 4)), g.uniform(-1, 1, (4, 2))]
    a = [g.uniform(-1, 1, (8, 1)), g.uniform(-1, 1, (4, 1))]
    mask = g.random((V, 4)) < 0.5
    labels = np.array([0, 1, 1, 0, 1])
    return x, w, a, mask, labels


def _loops_forward(family, x, w, a, mask, heads=2):
    """Layer by layer, destination by destination, edge by edge."""
    ind = np.zeros(V)
    outd = np.zeros(V)
    for s, d in EDGES:
        ind[d] += 1
        outd[s] += 1
    h = x
    for l in range(2):
        t = h @ w[l]
        out = np.zeros((V, t.shape[1]))
        nh = heads if l == 0 else 1
        fh = t.shape[1] // nh
        for d in range(V):
            into = [s for s, dd in EDGES if dd == d]
            if family == "gcn":
                for s in into:
                    out[d] += t[s] / math.sqrt(outd[s] * ind[d])
                continue
            for k in range(nh):
                cols = slice(k * fh, (k + 1) * fh)
                f = t.shape[1]
                sc = [t[s, cols] @ a[l][:f][cols, 0]
                      + t[d, cols] @ a[l][f:][cols, 0] for s in into]
                sc = [v if v >= 0 else 0.2 * v for v in sc]
                e = np.exp(np.array(sc) - max(sc))
                att = e / e.sum()
                for s, p in zip(into, att):
                    out[d, cols] += p * t[s, cols]
        if family == "gat":
            out = np.maximum(out, 0)
        if l == 0:
            h = np.maximum(out, 0) * mask * 2.0
        else:
            z = out - out.max(1, keepdims=True)
            h = z - np.log(np.exp(z).sum(1, keepdims=True))
    return h


def _ref_inputs(family, x, mask, labels, rows):
    src = torch.tensor([s for s, _ in EDGES])
    dst = torch.tensor([d for _, d in EDGES])
    ind, outd = ref.degrees(src, dst, V)
    cfg = dict(CFG, family=family)
    edges = ref.whole_graph_edges(cfg, src, dst, V, ind, outd)
    return cfg, {"x": torch.tensor(x), "edges": edges,
                 "masks": [torch.tensor(mask)],
                 "labels": torch.tensor(labels), "rows": torch.tensor(rows)}


@pytest.mark.parametrize("family", ["gcn", "gat"])
def test_forward_and_loss_equal_the_loops(family):
    x, w, a, mask, labels = _data()
    rows = [0, 2, 3]
    cfg, inp = _ref_inputs(family, x, mask, labels, rows)
    params = {"weights": [torch.tensor(t) for t in w],
              "attn": [torch.tensor(t) for t in a] if family == "gat" else []}
    logp = ref.forward(cfg, params, inp["x"], inp["edges"], inp["masks"],
                       torch.matmul)
    want = _loops_forward(family, x, w, a, mask)
    np.testing.assert_allclose(logp.numpy(), want, rtol=1e-12, atol=1e-12)
    loss = ref.nll(logp, inp["labels"], inp["rows"])
    assert float(loss) == pytest.approx(
        -np.mean([want[r, labels[r]] for r in rows]), rel=1e-12)


@pytest.mark.parametrize("family", ["gcn", "gat"])
def test_one_step_gradient_and_update_by_hand(family):
    x, w, a, mask, labels = _data(1)
    rows = [1, 2, 4]
    cfg, inp = _ref_inputs(family, x, mask, labels, rows)
    leaves = w + (a if family == "gat" else [])
    assert [name for name, _, _ in ref.leaves(cfg)] == (
        ["W0", "W1"] + (["a0", "a1"] if family == "gat" else []))
    out = ref.train_steps(cfg, True, [torch.tensor(t) for t in leaves],
                          [inp], "float64")

    def loss_of(vals):
        ww, aa = vals[:2], vals[2:] or a
        lp = _loops_forward(family, x, ww, aa, mask)
        return -np.mean([lp[r, labels[r]] for r in rows])

    eps = 1e-6
    for i, leaf in enumerate(leaves):
        num = np.zeros_like(leaf)
        for idx in np.ndindex(leaf.shape):
            up = [t.copy() for t in leaves]
            dn = [t.copy() for t in leaves]
            up[i][idx] += eps
            dn[i][idx] -= eps
            num[idx] = (loss_of(up) - loss_of(dn)) / (2 * eps)
        g = num + CFG["weight_decay"] * leaf
        np.testing.assert_allclose(out["grad1"][i].numpy(), g, rtol=1e-5,
                                   atol=1e-8)
        # Adam's first bias-corrected step: m/(1-b1) = g, v/(1-b2) = g^2
        step = leaf - 0.01 * g / (np.abs(g) + 1e-9)
        np.testing.assert_allclose(out["params"][i].numpy(), step,
                                   rtol=1e-6, atol=1e-9)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(10000, dtype=torch.float32)
    r = ref.tf32_round(x)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert ref.tf32_round(torch.tensor([1.0 + 2 ** -11]))[0] == 1.0
    assert ref.tf32_round(torch.tensor([1.0 + 3 * 2 ** -11]))[0] == \
        1.0 + 2 ** -9


def test_edge_sum_gradient():
    t = torch.randn(6, 4, dtype=torch.float64, requires_grad=True)
    c = torch.randn(9, 2, dtype=torch.float64, requires_grad=True)
    src = torch.tensor([0, 1, 2, 3, 4, 5, 0, 1, 2])
    dst = torch.tensor([0, 0, 1, 1, 2, 2, 3, 3, 3])
    torch.autograd.gradcheck(
        lambda t, c: ref.edge_sum(t, c, src, dst, 4, heads=2), (t, c))


def _sample_layers():
    # K = 3: bottom destinations 1, 2, 3, 0 with their kept sources; top:
    # the seed 1 keeps 3 of its 4 in-edges
    bottom = {"dst": torch.tensor([1, 2, 3, 0]),
              "nbr": torch.tensor([[0, 2, -1], [4, 0, 2], [2, 3, -1],
                                   [1, 0, -1]])}
    top = {"dst": torch.tensor([1]), "nbr": torch.tensor([[0, 2, 3]])}
    return [bottom, top]


def test_check_sample_counts_planted_violations():
    src = torch.tensor([s for s, _ in EDGES])
    dst = torch.tensor([d for _, d in EDGES])
    train = torch.ones(V, dtype=torch.bool)
    layers = _sample_layers()
    bad = ref.check_sample(layers, src, dst, V, train)
    assert sum(bad.values()) == 0, bad
    planted = _sample_layers()
    planted[0]["nbr"][0, 0] = 4          # 4 -> 1 is no edge
    planted[0]["nbr"][1, 0] = -1         # 2 keeps 2 of its 3 in-edges
    planted[1]["nbr"][0, 2] = 4          # no edge, and no bottom row
    bad = ref.check_sample(planted, src, dst, V, train)
    assert bad["not_edges"] == 2 and bad["row_counts"] == 1
    assert bad["layer_links"] == 1
    too_many = _sample_layers()
    too_many[0]["nbr"][3] = torch.tensor([1, 0, 0])   # 0 -> 0 held once
    assert ref.check_sample(too_many, src, dst, V, train)["not_edges"] == 1
    repeated = _sample_layers()
    repeated[0]["dst"][3] = 1
    assert ref.check_sample(repeated, src, dst, V, train)[
        "repeated_dst"] == 1
    assert ref.check_sample(layers, src, dst, V, ~train)[
        "seeds_not_train"] == 1
