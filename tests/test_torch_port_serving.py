"""Port parity, exact serving: sgnn_tpu_torch's InferenceServer,
layerwise_inference and exact_accuracy against sgnn_tpu's, on `tiny_ds` and
on Cora, for GCN and GraphSAGE with batch norm off and on.  The weights are
made once by the JAX package's `init_model` and carried across with
`params_from_numpy`; the port runs on the CPU (its plain PyTorch versions).
The query fanout draws are numpy on both sides, so they are the same edges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.graph.adjacency import Adjacency as JAdjacency
from sgnn_tpu.models.gnn import init_model as j_init_model
from sgnn_tpu.sampler.blocks import WeightKind as JWeightKind
from sgnn_tpu.train.inference import (
    InferenceServer as JServer, exact_accuracy as j_exact_accuracy,
    layerwise_inference as j_layerwise,
)

from sgnn_tpu_torch.graph.adjacency import Adjacency
from sgnn_tpu_torch.models.gnn import init_model, params_from_numpy
from sgnn_tpu_torch.sampler.blocks import WeightKind
from sgnn_tpu_torch.train.inference import (
    InferenceServer, exact_accuracy, layerwise_inference,
)

# f32 on both sides, the same edge order and arithmetic: only the summation
# order inside numpy/XLA/torch kernels differs
F32 = dict(rtol=1e-5, atol=1e-5)
# bf16: the two packages round at different points — JAX casts the edge
# weights to bf16 and keeps bf16 partial sums, the port keeps f32 weights and
# an f32 sum rounded once — so each sits ~2^-8 relative from the exact value
# per rounding; over the feature cast, two products, two aggregations and the
# relu that compounds to about 1e-2 of activations whose log-probs are O(1).
# 0.05 absolute is that with margin; measured ≤ 0.01 on these graphs.
BF16_ATOL = 0.05

CASES = [(fam, bn) for fam in ("gcn", "sage") for bn in (False, True)]


@pytest.fixture(scope="module", params=["tiny", "cora"])
def setup(request, tiny_ds, cora):
    ds = tiny_ds if request.param == "tiny" else cora
    sizes = [32, 16, 5] if request.param == "tiny" else [1433, 32, 7]
    return (ds, JAdjacency.from_edges(ds.edges, ds.num_vertices),
            Adjacency.from_edges(ds.edges, ds.num_vertices), sizes)


def _params(family, sizes, seed=21):
    jp = j_init_model(jax.random.PRNGKey(seed), family, sizes)
    return jp, params_from_numpy([np.asarray(w) for w in jp.weights],
                                 device="cpu")


def _servers(setup, family, batch_norm, **kw):
    ds, ja, ta, sizes = setup
    jp, tp = _params(family, sizes)
    js = JServer(jp, family, ja, ds.features, batch_norm=batch_norm,
                 **{k: v[0] for k, v in kw.items()})
    ts = InferenceServer(tp, family, ta, ds.features, batch_norm=batch_norm,
                         device="cpu", **{k: v[1] for k, v in kw.items()})
    return js, ts


@pytest.mark.parametrize("family,batch_norm", CASES)
def test_logprobs_match_jax(setup, family, batch_norm):
    js, ts = _servers(setup, family, batch_norm)
    got = ts.logprobs()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, js.logprobs(), **F32)
    np.testing.assert_array_equal(ts.predict(), np.argmax(got, -1))


@pytest.mark.parametrize("family,batch_norm", CASES)
def test_logprobs_bf16_match_jax(setup, family, batch_norm):
    js, ts = _servers(setup, family, batch_norm,
                      dtype=(jnp.bfloat16, torch.bfloat16))
    got, ref = ts.logprobs(), js.logprobs()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= BF16_ATOL


@pytest.mark.parametrize("family", ["gcn", "sage"])
def test_query_matches_jax(setup, family):
    js, ts = _servers(setup, family, False)
    full = ts.logprobs()
    rng = np.random.default_rng(0)
    v = setup[0].num_vertices
    for nids in (np.array([7]), rng.integers(0, v, 33)):  # dups, unordered
        got = ts.query(nids)
        np.testing.assert_allclose(got, js.query(nids), **F32)
        np.testing.assert_allclose(got, full[nids], **F32)
        for s in (0, 5):
            np.testing.assert_allclose(
                ts.query(nids, fanout=[5, 3], seed=s),
                js.query(nids, fanout=[5, 3], seed=s), **F32)


def test_query_fanout_stream_matches_jax(setup):
    """Without a seed both servers draw from their own default_rng(0)
    stream: successive calls stay in step."""
    js, ts = _servers(setup, "sage", False)
    nids = np.arange(0, 60, 3)
    for fan in (2, [4, 1]):
        np.testing.assert_allclose(ts.query(nids, fanout=fan),
                                   js.query(nids, fanout=fan), **F32)
    with pytest.raises(ValueError, match="fanout needs 2"):
        ts.query(nids, fanout=[1, 2, 3])


def test_query_under_batch_norm_is_whole_graph_rows(setup):
    js, ts = _servers(setup, "gcn", True)
    nids = np.array([3, 1, 3])
    np.testing.assert_allclose(ts.query(nids), js.query(nids), **F32)


@pytest.mark.parametrize("family,wk", [("gcn", WeightKind.GCN),
                                       ("sage", WeightKind.MEAN)])
def test_query_zero_in_degree_vertex(family, wk):
    """Counterpart of tests/test_inference.py:228: vertex 0 only sends
    edges, so it aggregates to zeros, with no NaN, in both packages."""
    rng = np.random.default_rng(5)
    v = 64
    src = rng.integers(0, v, 400)
    dst = rng.integers(1, v, 400)  # nothing ever points at vertex 0
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    feats = rng.standard_normal((v, 16)).astype(np.float32)
    jp, tp = _params(family, [16, 8, 3], seed=22)
    js = JServer(jp, family, JAdjacency.from_edges(edges, v), feats,
                 weight_kind=getattr(JWeightKind, wk.name))
    ts = InferenceServer(tp, family, Adjacency.from_edges(edges, v), feats,
                         weight_kind=wk, device="cpu")
    got = ts.query(np.array([0]))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0], ts.logprobs()[0], **F32)
    np.testing.assert_allclose(got, js.query(np.array([0])), **F32)


@pytest.mark.parametrize("mean_style", ["plain", "fullbatch"])
def test_layerwise_inference_matches_jax(setup, mean_style):
    ds, ja, ta, sizes = setup
    jp, tp = _params("sage", sizes)
    got = layerwise_inference(tp, "sage", ta, ds.features,
                              mean_style=mean_style, device="cpu")
    ref = j_layerwise(jp, "sage", ja, ds.features, mean_style=mean_style,
                      whole_graph=True)
    np.testing.assert_allclose(got, ref, **F32)


@pytest.mark.parametrize("family,batch_norm", CASES)
def test_exact_accuracy_equal(setup, family, batch_norm):
    ds, ja, ta, sizes = setup
    jp, tp = _params(family, sizes)
    nids = ds.nids_with_mask(0)
    got = exact_accuracy(tp, family, ta, ds.features, ds.labels, nids,
                         batch_norm=batch_norm, device="cpu")
    ref = j_exact_accuracy(jp, family, ja, ds.features, ds.labels, nids,
                           batch_norm=batch_norm)
    assert got == ref
    assert exact_accuracy(tp, family, ta, ds.features, ds.labels,
                          np.array([], np.int32), device="cpu") == 0.0


def test_update_params_and_warmup(setup):
    js, ts = _servers(setup, "gcn", False)
    ds, _, _, sizes = setup
    jp2, tp2 = _params("gcn", sizes, seed=99)
    ts.update_params(tp2)
    js.update_params(jp2)
    np.testing.assert_allclose(ts.logprobs(), js.logprobs(), **F32)
    assert ts.warmup(sizes=(1, 4), reps=2) >= 1
    assert ts.warmup(sizes=(), reps=2) == 0


def test_not_ported_features_raise(tiny_ds):
    adj = Adjacency.from_edges(tiny_ds.edges, tiny_ds.num_vertices)
    p = init_model(0, "gcn", [32, 16, 5], device="cpu")
    g = init_model(0, "gat", [32, 16, 5], device="cpu")
    f = tiny_ds.features
    # GAT serves now (single- and multi-head; parity in
    # test_torch_port_gat.py); GCN/SAGE ignore `heads`, as in JAX
    for heads in (1, 4):
        logp = InferenceServer(g, "gat", adj, f, heads=heads,
                               device="cpu").logprobs()
        assert logp.shape == (tiny_ds.num_vertices, 5)
        assert np.isfinite(logp).all()
    np.testing.assert_array_equal(
        InferenceServer(p, "gcn", adj, f, heads=2, device="cpu").logprobs(),
        InferenceServer(p, "gcn", adj, f, device="cpu").logprobs())
    # min/max serve now (parity in test_torch_port_fullbatch.py)
    for family, agg in (("gcn", "max"), ("gcn", "min"), ("sage", "max")):
        logp = InferenceServer(p, family, adj, f, aggregator=agg,
                               device="cpu").logprobs()
        assert logp.shape == (tiny_ds.num_vertices, 5)
        assert np.isfinite(logp).all()
    cases = [
        lambda: InferenceServer(p, "gcn", adj, f, dtype="int8",
                                device="cpu"),
        lambda: InferenceServer(p, "gcn", adj, f, dtype=np.int8,
                                device="cpu"),
        lambda: InferenceServer(g, "gat", adj, f, dtype="int8",
                                device="cpu"),
        lambda: layerwise_inference(p, "gcn", adj, f, whole_graph=False,
                                    device="cpu"),
    ]
    for make in cases:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            make()
    with pytest.raises(ValueError):
        InferenceServer(p, "gin", adj, f, device="cpu")
    with pytest.raises(ValueError, match="aggregator"):
        InferenceServer(p, "gcn", adj, f, aggregator="mean", device="cpu")
    with pytest.raises(ValueError):
        InferenceServer(p, "gcn", adj, f, dtype=np.float16, device="cpu")
    with pytest.raises(ValueError):
        InferenceServer(p, "gcn", adj, f[:10], device="cpu")
    srv = InferenceServer(p, "gcn", adj, f, dtype="bfloat16", device="cpu")
    assert srv.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="query ids"):
        srv.query(np.array([tiny_ds.num_vertices]))
