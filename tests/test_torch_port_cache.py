"""Port parity, the cache modules: sgnn_tpu_torch/cache/ against sgnn_tpu/cache/
on the same numpy inputs, on the CPU.

- hotness: scores, hot ids and per-super-batch plans identical, the
  persisted `.bin` read across packages and regenerated when the rate grows
  (tests/test_cache.py:368); `super_batch_stable_shuffle` identical from
  equal generators;
- the embedding cache: the slot map and the hot CSR identical to the JAX
  COO's unpadded prefix under the GCN, hybrid-mean, plain-mean and GAT
  rules (the mean styles as tests/test_cache.py:384); the PushDown
  aggregate (K2's plain version over resident f32 and int8 rows, and the
  host numpy path) and the refresh within 1e-5 relative of the JAX
  package's — only the f32 summation order differs;
- cache-omitting sampling: the host sampler's blocks (numpy and native)
  identical to the JAX sampler's; the device sampler samples nothing at a
  cached destination, leaves the upper hop untouched, and sets
  `cache_mask`/`cache_slot` from the map;
- `model_forward` with `cache_emb` for GCN, SAGE and GAT on the same
  batch: log-probs at 1e-5, gradients at 1e-4 of max |g| (the repo's f32
  rules, test_torch_port_model.py); the cached rows take no gradient;
- the feature cache: `gather_cold_compact`'s rows, positions, buckets and
  byte counters identical; the scatter plus merge equal to the full
  gather; the capacity probe and the degree ranking identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.cache import feature_cache as jfc
from sgnn_tpu.cache import hotness as jhot
from sgnn_tpu.cache.embedding_cache import EmbeddingCache as JEmbeddingCache
from sgnn_tpu.data.quant import quantize_columns as j_quantize
from sgnn_tpu.graph.adjacency import Adjacency as JAdjacency
from sgnn_tpu.models.gnn import init_model as j_init_model
from sgnn_tpu.models.gnn import model_forward as j_model_forward
from sgnn_tpu.nn.functional import nll_loss_masked as j_nll
from sgnn_tpu.sampler.blocks import WeightKind as JWeightKind
from sgnn_tpu.sampler.host import HostSampler as JHostSampler
from sgnn_tpu.train.trainer import host_batch_to_device as j_to_device

from sgnn_tpu_torch.cache import embedding_cache as tec
from sgnn_tpu_torch.cache import feature_cache as tfc
from sgnn_tpu_torch.cache import hotness as thot
from sgnn_tpu_torch.cache.embedding_cache import (
    EmbeddingCache, StalenessQueue, hot_csr,
)
from sgnn_tpu_torch.graph.adjacency import Adjacency
from sgnn_tpu_torch.models.gnn import params_from_numpy
from sgnn_tpu_torch.sampler.blocks import WeightKind
from sgnn_tpu_torch.sampler.device import device_sample_batch
from sgnn_tpu_torch.sampler.host import HostSampler
from sgnn_tpu_torch.train.trainer import host_batch_to_device, loss_and_grads
from sgnn_tpu_torch.utils.profiling import device_memory_stats

RTOL = 1e-5          # f32: only summation orders differ
GRAD_MAX_REL = 1e-4  # max |Δg| / max |g| per weight
FIELDS = ("nbr", "weight", "srcs", "seeds", "seed_in_src", "dst_valid",
          "src_valid", "num_dst", "num_src")


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module", params=["tiny", "cora"])
def graphs(request, tiny_ds, cora):
    ds = tiny_ds if request.param == "tiny" else cora
    return (ds, JAdjacency.from_edges(ds.edges, ds.num_vertices),
            Adjacency.from_edges(ds.edges, ds.num_vertices))


# ------------------------------------------------------------- hotness -----
def test_hotness_and_plans_identical(graphs):
    ds, ja, ta = graphs
    train = ds.nids_with_mask(0)
    np.testing.assert_array_equal(
        thot.hotness_scores(ta, train, [5, 3]),
        jhot.hotness_scores(ja, train, [5, 3]))
    np.testing.assert_array_equal(
        thot.presample_hotness(ta, train, [5, 3], 0.15),
        jhot.presample_hotness(ja, train, [5, 3], 0.15))
    sb = max(len(train) // 3, 1)
    per = thot.presample_hotness_per_sb(ta, train, [5, 3], 0.15, sb)
    assert per.shape[0] >= 3
    np.testing.assert_array_equal(
        per, jhot.presample_hotness_per_sb(ja, train, [5, 3], 0.15, sb))


def test_presampled_files_cross_packages(tmp_path, graphs):
    ds, ja, ta = graphs
    train = ds.nids_with_mask(0)
    jfile, tfile = str(tmp_path / "j.edge"), str(tmp_path / "t.edge")
    # each package reads the file the other wrote ...
    j_ids = jhot.presample_hotness(ja, train, [4, 3], 0.1, jfile, 32)
    np.testing.assert_array_equal(
        thot.presample_hotness(ta, train, [4, 3], 0.1, jfile, 32), j_ids)
    t_per = thot.presample_hotness_per_sb(ta, train, [4, 3], 0.1, 64,
                                          tfile, 32)
    np.testing.assert_array_equal(
        jhot.presample_hotness_per_sb(ja, train, [4, 3], 0.1, 64, tfile, 32),
        t_per)
    assert not list(tmp_path.glob("*.tmp"))   # no temporary file left
    # ... and, the name omitting the rate, regenerates for a larger one
    small = thot.presample_hotness(ta, train, [4, 3], 0.05, tfile, 32)
    big = thot.presample_hotness(ta, train, [4, 3], 0.2, tfile, 32)
    assert big.size == int(ds.num_vertices * 0.2) > small.size
    np.testing.assert_array_equal(big[:small.size], small)
    np.testing.assert_array_equal(
        jhot.presample_hotness(ja, train, [4, 3], 0.2, tfile, 32), big)
    per_big = thot.presample_hotness_per_sb(ta, train, [4, 3], 0.2, 64,
                                            tfile, 32)
    assert per_big.shape[1] > t_per.shape[1]
    np.testing.assert_array_equal(per_big[:, : t_per.shape[1]], t_per)


def test_super_batch_stable_shuffle_identical():
    nids = np.arange(1000, dtype=np.int32) * 3
    got = thot.super_batch_stable_shuffle(nids, 96, np.random.default_rng(4))
    ref = jhot.super_batch_stable_shuffle(nids, 96, np.random.default_rng(4))
    np.testing.assert_array_equal(got, ref)
    for s in range(0, 1000, 96):
        np.testing.assert_array_equal(np.sort(got[s:s + 96]), nids[s:s + 96])


# ----------------------------------------------------- embedding cache -----
RULES = [("gcn", "hybrid"), ("mean", "hybrid"), ("mean", "plain"),
         ("none", "hybrid")]


def _hot_ids(ds, ta):
    return thot.presample_hotness(ta, ds.nids_with_mask(0), [5, 3], 0.2)


@pytest.mark.parametrize("kind,style", RULES)
def test_hot_csr_equals_jax_coo(graphs, kind, style):
    ds, ja, ta = graphs
    ids = _hot_ids(ds, ta)
    jc = JEmbeddingCache.build(ja, ids, JWeightKind(kind), mean_style=style)
    tc = EmbeddingCache.build(ta, ids, WeightKind(kind), mean_style=style,
                              device="cpu")
    np.testing.assert_array_equal(tc.cache_map_host, jc.cache_map_host)
    np.testing.assert_array_equal(tc.cache_map.numpy(), jc.cache_map_host)
    e = tc.col.size
    np.testing.assert_array_equal(tc.col, np.asarray(jc.coo_src)[:e])
    np.testing.assert_array_equal(
        np.repeat(np.arange(ids.size), np.diff(tc.rowptr)),
        np.asarray(jc.coo_slot)[:e])
    np.testing.assert_array_equal(tc.w, np.asarray(jc.coo_w)[:e])
    assert not np.asarray(jc.coo_w)[e:].any()   # the rest is padding


def test_mean_styles_match_the_samplers(graphs):
    """Global-degree samplers take the plain mean, whose full-neighbourhood
    limit is 1/indeg; the hybrid differs."""
    ds, _, ta = graphs
    ids = _hot_ids(ds, ta)[:5]
    rowptr, _, w_p = hot_csr(ta, ids, WeightKind.MEAN, "plain")
    _, _, w_h = hot_csr(ta, ids, WeightKind.MEAN, "hybrid")
    for s, vid in enumerate(ids):
        np.testing.assert_allclose(w_p[rowptr[s]:rowptr[s + 1]],
                                   1.0 / max(int(ta.in_degree[vid]), 1),
                                   rtol=1e-6)
    assert not np.allclose(w_p, w_h)


@pytest.mark.parametrize("kind,style", RULES)
@pytest.mark.parametrize("source", ["device", "host", "int8"])
def test_aggregate_and_refresh_match_jax(graphs, kind, style, source,
                                         monkeypatch):
    ds, ja, ta = graphs
    ids = _hot_ids(ds, ta)
    jc = JEmbeddingCache.build(ja, ids, JWeightKind(kind), mean_style=style)
    tc = EmbeddingCache.build(ta, ids, WeightKind(kind), mean_style=style,
                              device="cpu")
    feats, scale = ds.features, None
    if source == "int8":
        feats, scale = j_quantize(ds.features)
        # blocks of a few rows, so the int8 path stages many
        monkeypatch.setattr(tec, "INT8_AGG_EDGES", 64)
    if source == "host":
        jc.precompute_aggregate(np.asarray(feats))
        tc.precompute_aggregate(np.asarray(feats))
    else:
        jc.precompute_aggregate(jnp.asarray(feats),
                                None if scale is None else jnp.asarray(scale))
        tc.precompute_aggregate(torch.from_numpy(feats), scale)
    assert tc.cache_agg.dtype == torch.float32
    assert _rel(tc.cache_agg.numpy(), np.asarray(jc.cache_agg)) <= RTOL
    w0 = np.random.default_rng(1).standard_normal(
        (feats.shape[1], 16)).astype(np.float32)
    jc.refresh(jnp.asarray(w0), 3)
    tc.refresh(torch.from_numpy(w0).requires_grad_(), 3)
    assert tc.version == 3 and not tc.cache_emb.requires_grad
    assert _rel(tc.cache_emb.numpy(), np.asarray(jc.cache_emb)) <= RTOL


def test_staleness_queue():
    q = StalenessQueue()
    with pytest.raises(RuntimeError, match="no W version"):
        q.get()
    w = torch.ones(2, 2, requires_grad=True)
    q.push(w)
    got, version = q.get()
    assert version == 0 and not got.requires_grad
    q.push(torch.zeros(2, 2))
    assert q.get()[1] == 1


# ------------------------------------------------------- omit sampling -----
def _omit_map(v, every=3):
    omit = np.full(v, -1, np.int32)
    hot = np.arange(0, v, every, dtype=np.int32)
    omit[hot] = np.arange(hot.size, dtype=np.int32)
    return omit


@pytest.mark.parametrize("use_native", [False, True])
def test_host_omit_blocks_identical(graphs, use_native):
    ds, ja, ta = graphs
    kw = dict(fanouts=[6, 4], batch_size=64, degree_mode="global", seed=3,
              use_native=use_native)
    js = JHostSampler(ja, weight_kind=JWeightKind.GCN, **kw)
    ts = HostSampler(ta, weight_kind=WeightKind.GCN, **kw)
    omit = _omit_map(ds.num_vertices)
    seeds = np.arange(0, ds.num_vertices, 5, dtype=np.int32)[:64]
    jh = js.sample(seeds, omit_map=omit)
    th = ts.sample(seeds, omit_map=omit)
    for jblk, tblk in zip(jh.blocks, th.blocks, strict=True):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(tblk, f),
                                          getattr(jblk, f), err_msg=f)
    b0 = th.blocks[0]
    cached = (omit[b0.seeds] >= 0) & b0.dst_valid
    assert cached.any() and not b0.weight[cached].any()


def test_device_omit_map(graphs):
    ds, _, ta = graphs
    v = ds.num_vertices
    indptr = torch.from_numpy(ta.indptr)
    indices = torch.from_numpy(ta.indices)
    omit = torch.from_numpy(_omit_map(v))
    seeds = torch.arange(0, 128, dtype=torch.int32) * 2
    valid = torch.ones(128, dtype=torch.bool)
    valid[-5:] = False
    args = (seeds, valid, indptr, indices,
            torch.from_numpy(ta.in_degree), torch.from_numpy(ta.out_degree),
            torch.from_numpy(ds.features), torch.from_numpy(
                ds.labels.astype(np.int64)), (6, 4), (1024, v),
            WeightKind.GCN)
    plain = device_sample_batch(torch.Generator().manual_seed(7), *args,
                                degree_mode="global")
    cut = device_sample_batch(torch.Generator().manual_seed(7), *args,
                              degree_mode="global", omit_map=omit)
    assert plain.cache_mask is None
    top_p, top_c = plain.blocks[-1], cut.blocks[-1]
    for f in ("nbr", "weight", "srcs", "seeds", "seed_in_src"):
        assert torch.equal(getattr(top_c, f), getattr(top_p, f)), f
    b0, p0 = cut.blocks[0], plain.blocks[0]
    slots = omit[b0.seeds.long()]
    assert torch.equal(cut.cache_mask, (slots >= 0) & b0.dst_valid)
    assert torch.equal(cut.cache_slot, slots.clamp_min(0).to(torch.int32))
    mask = cut.cache_mask
    assert mask.any() and not b0.weight[mask].any()
    # an uncached destination keeps the sources and weights it drew
    for d in torch.nonzero(~mask & b0.dst_valid)[:40, 0].tolist():
        kept = b0.weight[d] != 0
        assert torch.equal(b0.srcs[b0.nbr[d][kept].long()],
                           p0.srcs[p0.nbr[d][p0.weight[d] != 0].long()])
        assert torch.equal(b0.weight[d][kept], p0.weight[d][p0.weight[d]
                                                            != 0])


# ------------------------------------------------------- model merge -------
@pytest.fixture(scope="module")
def cached_batches(tiny_ds):
    adj = JAdjacency.from_edges(tiny_ds.edges, tiny_ds.num_vertices)
    out = {}
    for kind in ("gcn", "none"):
        sampler = JHostSampler(adj, fanouts=[6, 4], batch_size=96,
                               weight_kind=JWeightKind(kind), seed=5,
                               use_native=False)
        omit = _omit_map(tiny_ds.num_vertices, every=4)
        hb = sampler.sample(np.arange(0, 400, 4, dtype=np.int32),
                            omit_map=omit)
        payload = hb.payload(tiny_ds.features, tiny_ds.labels)
        b0 = hb.blocks[0]
        slots = omit[np.maximum(b0.seeds, 0)]
        mask = (slots >= 0) & b0.dst_valid
        slot = np.maximum(slots, 0).astype(np.int32)
        jb = dataclasses.replace(j_to_device(hb, *payload),
                                 cache_mask=jnp.asarray(mask),
                                 cache_slot=jnp.asarray(slot))
        tb = dataclasses.replace(
            host_batch_to_device(hb, *payload, device="cpu"),
            cache_mask=torch.from_numpy(mask),
            cache_slot=torch.from_numpy(slot))
        assert mask.sum() > 10
        out[kind] = (jb, tb, int((omit >= 0).sum()))
    return out


@pytest.mark.parametrize("family,heads", [("gcn", 1), ("sage", 1),
                                          ("gat", 1), ("gat", 4)])
def test_forward_with_cache_matches_jax(cached_batches, family, heads):
    jb, tb, n_cached = cached_batches["none" if family == "gat" else "gcn"]
    jp = j_init_model(jax.random.PRNGKey(3), family, [32, 16, 5])
    rng = np.random.default_rng(3)
    attn = [(rng.standard_normal(a.shape)).astype(np.float32)
            for a in jp.attn]
    jp = jp._replace(attn=tuple(jnp.asarray(a) for a in attn))
    tp = params_from_numpy([np.asarray(w) for w in jp.weights], attn,
                           device="cpu")
    emb = rng.standard_normal((n_cached, 16)).astype(np.float32)

    def j_loss(p):
        logp = j_model_forward(p, family, jb, cache_emb=jnp.asarray(emb),
                               heads=heads)
        return j_nll(logp, jb.labels, jb.label_valid), logp

    (jl, jlogp), jg = jax.value_and_grad(j_loss, has_aux=True)(jp)
    t_emb = torch.from_numpy(emb).requires_grad_()
    out = loss_and_grads(tp, family, tb, heads=heads, cache_emb=t_emb)
    assert t_emb.grad is None           # cached rows take no gradient
    np.testing.assert_allclose(out.logp.numpy(), np.asarray(jlogp),
                               rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(out.loss.item(), float(jl), rtol=RTOL)
    for g, ref in zip(out.grads, [*jg.weights, *jg.attn], strict=True):
        ref = np.asarray(ref)
        assert np.abs(g.numpy() - ref).max() <= GRAD_MAX_REL * np.abs(
            ref).max()
    # the cache changed the result: without it the loss differs
    plain = loss_and_grads(tp, family, tb, heads=heads)
    assert abs(plain.loss.item() - out.loss.item()) > 1e-4


# -------------------------------------------------------- feature cache ----
def test_feature_cache_compact_path_identical(tiny_ds):
    ds = tiny_ds
    ta = Adjacency.from_edges(ds.edges, ds.num_vertices)
    hot = tfc.degree_ranked_hot_ids(ta, 120)
    np.testing.assert_array_equal(
        hot, jfc.degree_ranked_hot_ids(
            JAdjacency.from_edges(ds.edges, ds.num_vertices), 120))
    jc = jfc.FeatureCache.build(ds.features, hot)
    tc = tfc.FeatureCache.build(ds.features, hot, device="cpu")
    rng = np.random.default_rng(2)
    for n_src in (0, 100, 300, 500):
        srcs = np.zeros(512, np.int32)
        srcs[:n_src] = np.sort(rng.choice(ds.num_vertices, n_src,
                                          replace=False))
        valid = np.arange(512) < n_src
        jx, jpos = jc.gather_cold_compact(ds.features, srcs, valid)
        tx, tpos = tc.gather_cold_compact(ds.features, srcs, valid)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tpos, jpos)
        tfc.check_cold_pos(tpos, 512)
        x0 = tfc.scatter_cold_rows(torch.from_numpy(tx),
                                   torch.from_numpy(tpos), 512)
        x0 = tc.merge_device(x0, torch.from_numpy(srcs),
                             torch.from_numpy(valid))
        full = np.where(valid[:, None], ds.features[srcs], 0.0)
        np.testing.assert_array_equal(x0.numpy(), full)
    for f in ("hits", "misses", "bytes_shipped", "bytes_full"):
        assert getattr(tc, f) == getattr(jc, f), f
    for n, cap in ((0, 512), (129, 512), (300, 512), (600, 512), (5, 64)):
        assert tfc._cold_bucket(n, cap) == jfc._cold_bucket(n, cap)
    with pytest.raises(ValueError, match="cold_pos"):
        tfc.check_cold_pos(np.array([0, 513], np.int32), 512)


def test_feature_cache_capacity_and_upload(tiny_ds):
    for budget in (10_000, 1 << 20):
        assert (tfc.hbm_feature_capacity(602, 4, budget, device="cpu")
                == jfc.hbm_feature_capacity(602, 4, budget))
    # no statistics on the CPU: the JAX package's 1 GiB
    assert device_memory_stats(torch.device("cpu")) is None
    assert tfc.hbm_feature_capacity(602, 4, device="cpu") == (1 << 30) // (
        602 * 4)
    hot = np.array([3, 1, 4], np.int32)
    fc = tfc.FeatureCache.build(tiny_ds.features, hot, dtype=torch.bfloat16,
                                upload=False, device="cpu")
    assert fc.dev_hot is None
    fc.upload(tiny_ds.features, torch.bfloat16)
    assert fc.dev_hot.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        fc.dev_hot.float().numpy(),
        torch.from_numpy(tiny_ds.features[hot]).bfloat16().float().numpy())
    empty = tfc.FeatureCache.build(tiny_ds.features, np.zeros(0, np.int32),
                                   device="cpu")
    x = torch.ones(4, tiny_ds.features.shape[1])
    assert torch.equal(empty.merge_device(
        x, torch.arange(4, dtype=torch.int32), torch.ones(4, dtype=bool)), x)
