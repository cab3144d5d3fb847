"""Port parity: the remainder of the JAX package, on the CPU.

Each module against its `sgnn_tpu` counterpart on the same numpy inputs:
- the native `stable_argsort` and `transpose_csc` (sampler/native) on the
  fuzz cases of tests/test_graph.py:67 and tests/test_sampler.py:276,
  `ops/segment.csr_transpose`, `Adjacency.transpose`, `neighbors` and
  `to_padded_device_csc`: bit-identical;
- `graph/reorder.py`'s `vertex_order` (none, degree, bfs) and
  `apply_vertex_order` on tiny, Cora and a power-law graph: bit-identical;
- `run_engine` under REORDER degree and bfs: GCNFULLBATCH at drop 0 from
  the JAX initial parameters (carried across by patching each package's
  `init_model` in the trainer module: RNG does not cross frameworks), the
  first epoch's loss at 1e-5 and the second at the whole-graph
  trajectory's 1e-3 (tests/test_torch_port_fullbatch.py), and a sampled
  engine; `report.vertex_order` equal to JAX's;
- the data layer: `powerlaw_graph_dataset`, `write_edge_binary` and
  `export_nts_format` byte for byte, `load_ogb_dir` on a gzip-CSV
  directory written here, `load_ogb` without a directory;
- the helpers: `Counters`, `Timer`, `load_npy`, `Dense`, `gather_min` /
  `gather_max` / `edge_view` with their gradients (rtol 1e-5), and
  `FeatureCache.gather_host_cold` / `hit_rate`; `log_memory`.
"""

import gzip
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.cache.feature_cache import FeatureCache as JFeatureCache
from sgnn_tpu.config import RunConfig as JRunConfig
from sgnn_tpu.data import nts_format as jnts
from sgnn_tpu.data import ogb as jogb
from sgnn_tpu.data import synthetic as jsyn
from sgnn_tpu.graph import reorder as jreorder
from sgnn_tpu.graph.adjacency import Adjacency as JAdjacency
from sgnn_tpu.models.gnn import init_model as j_init_model
from sgnn_tpu.nn.layers import Dense as JDense
from sgnn_tpu.ops import reductions as jred
from sgnn_tpu.sampler.native import stable_argsort as j_stable_argsort
from sgnn_tpu.train import engines as jengines
from sgnn_tpu.utils import io as jio
from sgnn_tpu.utils import timing as jtiming

from sgnn_tpu_torch.cache.feature_cache import FeatureCache
from sgnn_tpu_torch.config import RunConfig
from sgnn_tpu_torch.data import load_ogb, load_ogb_dir
from sgnn_tpu_torch.data import nts_format as tnts
from sgnn_tpu_torch.data import ogb as togb
from sgnn_tpu_torch.data import synthetic as tsyn
from sgnn_tpu_torch.graph import apply_vertex_order, vertex_order
from sgnn_tpu_torch.graph.adjacency import Adjacency
from sgnn_tpu_torch.models.gnn import params_from_numpy
from sgnn_tpu_torch.nn import Dense
from sgnn_tpu_torch.ops import reductions as tred
from sgnn_tpu_torch.ops.segment import csr_transpose
from sgnn_tpu_torch.sampler.native import stable_argsort, transpose_csc
from sgnn_tpu_torch.train import engines as tengines
from sgnn_tpu_torch.utils import io as tio
from sgnn_tpu_torch.utils.profiling import Counters, log_memory
from sgnn_tpu_torch.utils.timing import Timer

RTOL = 1e-5


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


# ----------------------------------------------------- native sort, transpose
def _argsort_cases():
    rng = np.random.default_rng(3)
    return [
        (np.zeros(0, np.int32), 1),
        (np.zeros(17, np.int32), 1),          # all-equal keys
        (np.full(5, 6, np.int32), 7),         # the largest key value
        (rng.integers(0, 3, 1000).astype(np.int32), 3),
        (rng.integers(0, 100000, 50000).astype(np.int32), 100000),
    ]


@pytest.mark.parametrize("case", range(5))
def test_stable_argsort_matches_numpy_and_jax(case):
    keys, hi = _argsort_cases()[case]
    got = stable_argsort(keys, hi)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(got, j_stable_argsort(keys, hi))


def test_stable_argsort_rejects_out_of_range_keys():
    with pytest.raises(ValueError, match="out of range"):
        stable_argsort(np.array([0, 3], np.int32), 3)


@pytest.mark.parametrize("v,e", [(9, 1), (101, 2048), (40, 30000)])
def test_transpose_csc_and_adjacency_match_jax(v, e):
    rng = np.random.default_rng(5)
    edges = np.stack([rng.integers(0, v, size=e),
                      rng.integers(0, v, size=e)], 1).astype(np.int32)
    adj, jadj = Adjacency.from_edges(edges, v), JAdjacency.from_edges(edges, v)
    got, want = adj.transpose(), jadj.transpose()
    for name in ("indptr", "indices", "in_degree", "out_degree"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ip, ix = transpose_csc(adj.indptr, adj.indices, v)
    np.testing.assert_array_equal(ip, want.indptr)
    np.testing.assert_array_equal(ix, want.indices)
    # the whole-graph build's transposed CSR: the same edges keyed by source
    w = rng.random(e).astype(np.float32)
    rowptr_t, col_t, w_t = csr_transpose(adj.indptr, adj.indices, w, v)
    np.testing.assert_array_equal(rowptr_t, want.indptr)
    np.testing.assert_array_equal(col_t, want.indices)
    perm = np.argsort(adj.indices, kind="stable")
    np.testing.assert_array_equal(w_t, w[perm])
    # involution
    tt = got.transpose()
    np.testing.assert_array_equal(tt.indptr, adj.indptr)
    np.testing.assert_array_equal(np.sort(tt.indices), np.sort(adj.indices))


def test_neighbors_and_padded_csc_match_jax(tiny_ds, cora):
    for ds in (tiny_ds, cora):
        adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
        jadj = JAdjacency.from_edges(ds.edges, ds.num_vertices)
        for v in (0, 7, ds.num_vertices - 1):
            np.testing.assert_array_equal(adj.neighbors(v), jadj.neighbors(v))
        for mult in (128, 1000, 1):
            for a, b in zip(adj.to_padded_device_csc(mult),
                            jadj.to_padded_device_csc(mult)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    empty = Adjacency.from_edges(np.zeros((0, 2), np.int32), 5)
    t = empty.transpose()
    np.testing.assert_array_equal(t.indptr, np.zeros(6, np.int64))
    assert t.num_edges == 0


# -------------------------------------------------------------- reordering
@pytest.fixture(scope="module")
def graphs(tiny_ds, cora):
    return {"tiny": tiny_ds, "cora": cora,
            "powerlaw": tsyn.powerlaw_graph_dataset(3000, 6, 8, 4, seed=2)}


@pytest.mark.parametrize("mode", ["none", "degree", "bfs"])
@pytest.mark.parametrize("name", ["tiny", "cora", "powerlaw"])
def test_vertex_order_and_apply_match_jax(graphs, name, mode):
    ds = graphs[name]
    order = vertex_order(ds, mode)
    want = jreorder.vertex_order(ds, mode)
    assert order.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(order, want)
    np.testing.assert_array_equal(np.sort(order), np.arange(ds.num_vertices))
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    np.testing.assert_array_equal(vertex_order(adj, mode), order)
    got, o2n = apply_vertex_order(ds, order)
    ref, j_o2n = jreorder.apply_vertex_order(ds, want)
    np.testing.assert_array_equal(o2n, j_o2n)
    assert got.name == ref.name and got.num_vertices == ref.num_vertices
    for field in ("edges", "features", "labels", "masks"):
        a, b = getattr(got, field), getattr(ref, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_vertex_order_rejects_an_unknown_mode(tiny_ds):
    with pytest.raises(ValueError, match="unknown vertex order"):
        vertex_order(tiny_ds, "random")


@pytest.fixture
def carried_init(monkeypatch):
    """The port's trainers start from the JAX package's initial
    parameters: its trainer modules' `init_model` returns them."""
    import sgnn_tpu_torch.train.fullbatch as tfb
    import sgnn_tpu_torch.train.trainer as ttr

    def torch_init(seed, family, layer_sizes, device=None, **_):
        p = j_init_model(jax.random.PRNGKey(seed), family, layer_sizes)
        return params_from_numpy([np.asarray(w) for w in p.weights],
                                 [np.asarray(a) for a in p.attn],
                                 device=device)

    monkeypatch.setattr(tfb, "init_model", torch_init)
    monkeypatch.setattr(ttr, "init_model", torch_init)


@pytest.mark.parametrize("mode", ["degree", "bfs"])
def test_run_engine_reorder_fullbatch_matches_jax(tiny_ds, carried_init,
                                                  mode):
    kw = dict(algorithm="GCNFULLBATCH", layer_sizes=[32, 16, 5], epochs=2,
              drop_rate=0.0, learn_rate=0.01, vertices=tiny_ds.num_vertices,
              reorder=mode)
    got = tengines.run_engine(RunConfig(**kw), tiny_ds, device="cpu")
    want = jengines.run_engine(JRunConfig(**kw), tiny_ds)
    np.testing.assert_array_equal(got.vertex_order, want.vertex_order)
    np.testing.assert_array_equal(got.vertex_order,
                                  vertex_order(tiny_ds, mode))
    assert abs(got.losses[0] - want.losses[0]) <= RTOL * abs(want.losses[0])
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)
    # a renumbering only reorders the sums: the same first loss as none's
    plain = tengines.run_engine(RunConfig(**dict(kw, reorder="none")),
                                tiny_ds, device="cpu")
    assert plain.vertex_order is None
    assert abs(got.losses[0] - plain.losses[0]) <= RTOL * plain.losses[0]


@pytest.mark.parametrize("algo", ["GCNSAMPLEGPU", "GSSAMPLEALLGPU"])
def test_run_engine_reorder_sampled(tiny_ds, carried_init, algo):
    kw = dict(algorithm=algo, layer_sizes=[32, 16, 5], fanout=[4, 3],
              batch_size=64, epochs=2, drop_rate=0.0,
              vertices=tiny_ds.num_vertices, reorder="bfs")
    got = tengines.run_engine(RunConfig(**kw), tiny_ds, device="cpu")
    want = jengines.run_engine(JRunConfig(**kw), tiny_ds)
    np.testing.assert_array_equal(got.vertex_order, want.vertex_order)
    assert len(got.losses) == 2 and np.isfinite(got.losses).all()
    assert got.edges_per_epoch[0] > 0


# ------------------------------------------------------------------- data
def test_powerlaw_graph_dataset_identical():
    for args in ((3000, 6, 8, 4), (500, 3, 16, 7)):
        for seed in (0, 5):
            a = tsyn.powerlaw_graph_dataset(*args, seed=seed)
            b = jsyn.powerlaw_graph_dataset(*args, seed=seed)
            assert a.name == b.name
            for f in ("edges", "features", "labels", "masks"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_write_edge_binary_and_export_byte_for_byte(tmp_path, tiny_ds):
    tnts.write_edge_binary(str(tmp_path / "a.bin"), tiny_ds.edges)
    jnts.write_edge_binary(str(tmp_path / "b.bin"), tiny_ds.edges)
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()
    np.testing.assert_array_equal(
        tnts.read_edge_binary(str(tmp_path / "a.bin")), tiny_ds.edges)
    ours = togb.export_nts_format(tiny_ds, str(tmp_path / "t"), "x")
    theirs = jogb.export_nts_format(tiny_ds, str(tmp_path / "j"), "x")
    suffixes = (f".{tiny_ds.num_vertices}.edge.self", ".featuretable",
                ".labeltable", ".mask")
    for suf in suffixes:
        with open(ours + suf, "rb") as a, open(theirs + suf, "rb") as b:
            assert a.read() == b.read(), suf
    back = tnts.load_nts_dataset(*(ours + s for s in suffixes),
                                 num_vertices=tiny_ds.num_vertices,
                                 feature_dim=tiny_ds.feature_dim)
    for f in ("edges", "features", "labels", "masks"):
        np.testing.assert_array_equal(getattr(back, f), getattr(tiny_ds, f))


def _write_ogb_dir(root, ds):
    """An OGB node-property directory (gzip CSVs) of `ds` without its
    self-loops, with a split directory."""
    def csv(path, rows, fmt):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with gzip.open(path, "wt") as f:
            np.savetxt(f, rows, delimiter=",", fmt=fmt)

    edges = ds.edges[ds.edges[:, 0] != ds.edges[:, 1]]
    csv(os.path.join(root, "raw", "edge.csv.gz"), edges, "%d")
    csv(os.path.join(root, "raw", "node-feat.csv.gz"), ds.features, "%.9g")
    csv(os.path.join(root, "raw", "node-label.csv.gz"), ds.labels[:, None],
        "%d")
    for name, code in (("train", 0), ("valid", 1), ("test", 2)):
        ids = np.nonzero(ds.masks == code)[0]
        csv(os.path.join(root, "split", "random", f"{name}.csv.gz"),
            ids[:, None], "%d")


def test_load_ogb_dir_matches_jax(tmp_path, tiny_ds):
    _write_ogb_dir(str(tmp_path), tiny_ds)
    got = load_ogb_dir(str(tmp_path), "ogbn-tiny")
    want = jogb.load_ogb_dir(str(tmp_path), "ogbn-tiny")
    assert got.name == want.name == "ogbn-tiny"
    assert got.num_vertices == want.num_vertices == tiny_ds.num_vertices
    for f in ("edges", "features", "labels", "masks"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.features, tiny_ds.features)
    np.testing.assert_array_equal(got.masks, tiny_ds.masks)
    # load_ogb reads the same directory; without one it says what it needs
    same = load_ogb("ogbn-tiny", root=str(tmp_path))
    np.testing.assert_array_equal(same.edges, got.edges)
    with pytest.raises(RuntimeError, match="local OGB directory"):
        load_ogb("ogbn-arxiv")


# ---------------------------------------------------------------- helpers
def test_counters_and_timer():
    c = Counters()
    c.add("sampled", 100)
    c.add("hits", 25)
    c.add("hits")
    assert c.get("hits") == 26 and c.ratio("hits", "sampled") == 0.26
    assert c.ratio("hits", "nothing") == 0.0
    assert "hits=26" in c.summary()
    t = Timer()
    assert t.elapsed() >= 0.0
    first = t.reset()
    assert first >= 0.0 and t.elapsed() <= first + 60
    assert [m for m in dir(jtiming.Timer) if not m.startswith("_")] == [
        m for m in dir(Timer) if not m.startswith("_")]


def test_log_memory(caplog):
    with caplog.at_level(logging.INFO, logger="sgnn.prof"):
        log_memory("cpu: ", device="cpu")   # nothing to log on the CPU
    assert not caplog.records
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            log_memory()


@pytest.mark.parametrize("arr", [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.asfortranarray(np.arange(12, dtype=np.int64).reshape(3, 4)),
    np.zeros((0, 5), np.int8), np.array(3.5)], ids=["c", "f", "empty",
                                                    "scalar"])
def test_load_npy_matches_jax(tmp_path, arr):
    path = str(tmp_path / "a.npy")
    np.save(path, arr)
    got, want = tio.load_npy(path), jio.load_npy(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    got[...] = 0   # writable
    tio.save_npy(path, arr)
    np.testing.assert_array_equal(tio.load_npy(path), arr)


def test_dense_matches_jax():
    jd = JDense.init(jax.random.PRNGKey(0), 7, 5)
    d = Dense(w=torch.from_numpy(np.array(jd.w)))
    x = np.random.default_rng(0).standard_normal((9, 7)).astype(np.float32)
    assert _rel(d(torch.from_numpy(x)).numpy(), jd(jnp.asarray(x))) <= RTOL
    g = torch.Generator().manual_seed(0)
    fresh = Dense.init(g, 7, 5)
    a = np.sqrt(6.0 / 12)
    assert fresh.w.shape == (7, 5) and float(fresh.w.abs().max()) <= a
    assert d(torch.from_numpy(x).to(torch.float64)).dtype == torch.float64


@pytest.mark.parametrize("kind", ["min", "max"])
def test_gather_min_max_and_edge_view_match_jax(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((40, 6)).astype(np.float32)
    x[3] = x[4]                      # tied rows: the gradient is shared
    nbr = rng.integers(0, 40, (25, 5)).astype(np.int32)
    nbr[0] = [3, 4, 3, 4, 1]
    mask = rng.random((25, 5)) > 0.3
    mask[1] = False                  # a row with no valid slot
    mask[0] = True
    c = rng.standard_normal((25, 6)).astype(np.float32)
    tf = tred.gather_min if kind == "min" else tred.gather_max
    jf = jred.gather_min if kind == "min" else jred.gather_max
    xt = torch.from_numpy(x).requires_grad_()
    out = tf(xt, torch.from_numpy(nbr), torch.from_numpy(mask))
    (out * torch.from_numpy(c)).sum().backward()

    def jloss(xx):
        return (jf(xx, jnp.asarray(nbr), jnp.asarray(mask)) * c).sum()

    want = jf(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(mask))
    assert _rel(out.detach().numpy(), want) <= RTOL
    assert _rel(xt.grad.numpy(), jax.grad(jloss)(jnp.asarray(x))) <= RTOL
    assert not out[1].any()
    np.testing.assert_array_equal(
        tred.edge_view(torch.from_numpy(x), torch.from_numpy(nbr)).numpy(),
        np.asarray(jred.edge_view(jnp.asarray(x), jnp.asarray(nbr))))


def test_feature_cache_host_cold_and_hit_rate(tiny_ds):
    feats = tiny_ds.features
    hot = np.arange(0, tiny_ds.num_vertices, 3, dtype=np.int32)
    fc = FeatureCache.build(feats, hot, upload=False, device="cpu")
    jfc = JFeatureCache.build(feats, hot, device=False)
    assert fc.hit_rate == jfc.hit_rate == 0.0
    rng = np.random.default_rng(4)
    for _ in range(3):
        srcs = rng.integers(-1, tiny_ds.num_vertices, 64).astype(np.int32)
        valid = srcs >= 0
        (x0, cold), (jx0, jcold) = (c.gather_host_cold(feats, srcs, valid)
                                    for c in (fc, jfc))
        np.testing.assert_array_equal(x0, jx0)
        np.testing.assert_array_equal(cold, jcold)
    assert (fc.hits, fc.misses) == (jfc.hits, jfc.misses)
    assert fc.hit_rate == jfc.hit_rate and 0 < fc.hit_rate < 1
    # the device merge restores every valid row
    fc.upload(feats)
    merged = fc.merge_device(torch.from_numpy(x0), torch.from_numpy(
        np.maximum(srcs, 0)), torch.from_numpy(valid))
    np.testing.assert_array_equal(merged.numpy()[valid], feats[srcs[valid]])
