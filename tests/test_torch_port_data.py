"""Port parity, host data layer: sgnn_tpu_torch's config, loaders,
synthetic generators, adjacency and parameter carry-across against
sgnn_tpu's, on the same files and seeds.  Host arrays are numpy in both
packages, so everything here is held to bit equality except where a float
formula is recomputed (stated at the assert)."""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

from sgnn_tpu import config as jcfg
from sgnn_tpu.data import nts_format as jnts
from sgnn_tpu.data import synthetic as jsyn
from sgnn_tpu.graph.adjacency import Adjacency as JAdjacency
from sgnn_tpu.models.gnn import init_model as j_init_model
from sgnn_tpu.sampler.blocks import WeightKind as JWeightKind
from sgnn_tpu.train.fullbatch import build_coo as j_build_coo
from sgnn_tpu.train.inference import _serving_coo as j_serving_coo

import sgnn_tpu_torch
from sgnn_tpu_torch import config as tcfg
from sgnn_tpu_torch.data import nts_format as tnts
from sgnn_tpu_torch.data import synthetic as tsyn
from sgnn_tpu_torch.graph.adjacency import Adjacency as TAdjacency
from sgnn_tpu_torch.models.gnn import init_model, params_from_numpy
from sgnn_tpu_torch.sampler.blocks import WeightKind, pad_to
from sgnn_tpu_torch.train.fullbatch import build_coo
from sgnn_tpu_torch.train.inference import _serving_coo as serving_coo

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.cfg")))


# RunConfig keys the port has and the JAX package has not (the pyg GAT's
# variant, Adam's epsilon), at their defaults in any .cfg without them
PORT_ONLY = {"gat_variant": "", "adam_epsilon": 1e-9}


def _cfg_equal(a, b):
    """The JAX package's RunConfig `a` and the port's `b` hold the same
    fields, the port's own at their defaults."""
    mine = dataclasses.asdict(b)
    assert {k: mine.pop(k) for k in PORT_ONLY} == PORT_ONLY
    assert dataclasses.asdict(a) == mine


def _ds_equal(a, b):
    assert a.num_vertices == b.num_vertices and a.name == b.name
    for f in ("edges", "features", "labels", "masks"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("path", CFGS, ids=os.path.basename)
def test_load_cfg_equal(path):
    a, b = jcfg.load_cfg(path), tcfg.load_cfg(path)
    _cfg_equal(a, b)
    assert (a.num_layers, a.num_classes) == (b.num_layers, b.num_classes)


def test_parse_cfg_text_equal():
    text = ("ALGORITHM:GSSAMPLEALLGPU\nLAYERS:602-128-41\nFANOUT:25-10\n"
            "BATCH_NORM:1  # comment\nDTYPE:bfloat16\nUNKNOWN_KEY:7\n")
    _cfg_equal(jcfg.parse_cfg_text(text), tcfg.parse_cfg_text(text))


def test_cora_arrays_identical(cora):
    cfg = tcfg.load_cfg(os.path.join(ROOT, "configs", "gcn_cora_sample.cfg"))
    port = tnts.load_from_config(cfg)
    ref = jnts.load_from_config(jcfg.load_cfg(
        os.path.join(ROOT, "configs", "gcn_cora_sample.cfg")))
    _ds_equal(ref, port)
    for f in ("edges", "features", "labels", "masks"):  # the conftest loader
        np.testing.assert_array_equal(getattr(cora, f), getattr(port, f))


@pytest.mark.parametrize("v,deg,feat,cls,seed", [
    (500, 8, 32, 5, 7), (1000, 3, 16, 4, 1)])
def test_random_graph_dataset_identical(v, deg, feat, cls, seed):
    _ds_equal(jsyn.random_graph_dataset(v, deg, feat, cls, seed=seed),
              tsyn.random_graph_dataset(v, deg, feat, cls, seed=seed))


@pytest.mark.parametrize("fn", ["reddit_like_dataset",
                                "calibrated_reddit_like_dataset"])
def test_reddit_like_identical(fn):
    _ds_equal(getattr(jsyn, fn)(seed=3, scale=0.005),
              getattr(tsyn, fn)(seed=3, scale=0.005))


@pytest.fixture(scope="module", params=["tiny", "cora"])
def graph_pair(request, tiny_ds, cora):
    ds = tiny_ds if request.param == "tiny" else cora
    return (JAdjacency.from_edges(ds.edges, ds.num_vertices),
            TAdjacency.from_edges(ds.edges, ds.num_vertices))


def _adj_equal(a, b):
    assert a.num_vertices == b.num_vertices and a.num_edges == b.num_edges
    for f in ("indptr", "indices", "in_degree", "out_degree"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_adjacency_equal(graph_pair):
    _adj_equal(*graph_pair)


def test_adjacency_transpose_equal(graph_pair):
    _adj_equal(graph_pair[0].transpose(), graph_pair[1].transpose())


def test_gcn_edge_weight_matches(graph_pair):
    ja, ta = graph_pair
    rng = np.random.default_rng(0)
    src = rng.integers(0, ja.num_vertices, 300)
    dst = rng.integers(0, ja.num_vertices, 300)
    # the same f32 formula in both packages; 1e-6 leaves room for numpy
    # picking another sqrt/divide kernel, nothing more
    np.testing.assert_allclose(ta.gcn_edge_weight(src, dst),
                               ja.gcn_edge_weight(src, dst), rtol=1e-6)


@pytest.mark.parametrize("kind", ["GCN", "MEAN", "NONE"])
def test_build_coo_is_unpadded_prefix(graph_pair, kind):
    ja, ta = graph_pair
    js, jd, jw = j_build_coo(ja, getattr(JWeightKind, kind))
    ts, td, tw = build_coo(ta, getattr(WeightKind, kind))
    e = ta.num_edges
    assert ts.size == td.size == tw.size == e
    np.testing.assert_array_equal(ts, js[:e])
    np.testing.assert_array_equal(td, jd[:e])
    np.testing.assert_allclose(tw, jw[:e], rtol=1e-6)  # same f32 formula
    assert not np.any(jw[e:])  # JAX's 512-padding carries weight 0 only


@pytest.mark.parametrize("kind,mean_style", [
    ("GCN", "plain"), ("MEAN", "plain"), ("MEAN", "fullbatch"),
    ("NONE", "plain")])
def test_serving_coo_matches(graph_pair, kind, mean_style):
    ja, ta = graph_pair
    js, _, jw = j_serving_coo(ja, getattr(JWeightKind, kind), mean_style)
    ts, tw = serving_coo(ta, getattr(WeightKind, kind), mean_style)
    assert ts.dtype == js.dtype and tw.dtype == jw.dtype == np.float32
    np.testing.assert_array_equal(ts, js)
    # the same numpy formulas on the same arrays, per edge or per vertex
    # then repeated: equal, up to numpy's choice of divide/sqrt kernel
    np.testing.assert_allclose(tw, jw, rtol=1e-6)


def test_pad_to():
    assert [pad_to(n, 8) for n in (0, 1, 8, 9)] == [8, 8, 8, 16]


def test_init_model_xavier_and_gat_zeros():
    p = init_model(0, "gat", [20, 12, 3], device="cpu")
    q = init_model(0, "gat", [20, 12, 3], device="cpu")
    assert [tuple(w.shape) for w in p.weights] == [(20, 12), (12, 3)]
    assert [tuple(a.shape) for a in p.attn] == [(24, 1), (6, 1)]
    for w, (fi, fo) in zip(p.weights, [(20, 12), (12, 3)]):
        assert w.abs().max() <= np.sqrt(6.0 / (fi + fo))
    assert all(bool((a == 0).all()) for a in p.attn)
    assert all(torch.equal(a, b) for a, b in zip(p.weights, q.weights))
    assert init_model(1, "gcn", [20, 12, 3], device="cpu").attn == ()


def test_params_from_numpy_carries_jax_params():
    jp = j_init_model(jax.random.PRNGKey(3), "gat", [16, 8, 3])
    tp = params_from_numpy([np.asarray(w) for w in jp.weights],
                           [np.asarray(a) for a in jp.attn], device="cpu")
    for j, t in zip(jp.weights + jp.attn, tp.weights + tp.attn):
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_resolve_device():
    assert sgnn_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        sgnn_tpu_torch.resolve_device("meta")
