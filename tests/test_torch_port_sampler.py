"""Port parity, samplers.

The host sampler: sgnn_tpu_torch's HostSampler against sgnn_tpu's for the
same graph and seed, drawing from the same `np.random.default_rng` in the
same order — every block field bit-identical, for GCN/MEAN/NONE weights
under global and sampled degrees, on the numpy path (approximate and exact
draws) and the native C++ path (both packages build their own copy of the
same source with the same flags), and the feature payload.

The device sampler draws from a torch.Generator, not jax.random, so it is
held to invariants: each kept slot is a real in-edge of its seed, no
duplicate in a row, small rows taken whole, sorted unique source sets that
cover the seeds, `seed_in_src` right, `nbr < num_src_pad`, the overflow
count 0 at exact pads and > 0 under a tiny SRC_PAD_FACTOR, and the
identity bottom hop.  Its source set (a sorted search of the presence
map's prefix sum) is held bit for bit to the rank scatter it replaced,
kept in tests/_rank_scatter.py as the plain reference, and
`sampler.rank_hops` counts the hops that build one.
"""

import shutil

import numpy as np
import pytest
from _rank_scatter import assert_same_blocks, both_ways

from sgnn_tpu.graph.adjacency import Adjacency as JAdjacency
from sgnn_tpu.sampler.blocks import WeightKind as JWeightKind
from sgnn_tpu.sampler.host import HostSampler as JHostSampler

from sgnn_tpu_torch.config import RunConfig
from sgnn_tpu_torch.data.synthetic import random_graph_dataset
from sgnn_tpu_torch.graph.adjacency import Adjacency
from sgnn_tpu_torch.sampler import native
from sgnn_tpu_torch.sampler.blocks import WeightKind
from sgnn_tpu_torch.sampler.host import HostSampler
from sgnn_tpu_torch.train.device_trainer import DeviceSampleTrainer
from sgnn_tpu_torch.utils import timing

FIELDS = ("nbr", "weight", "srcs", "seeds", "seed_in_src", "dst_valid",
          "src_valid", "num_dst", "num_src")


@pytest.fixture(scope="module")
def graphs(tiny_ds):
    return (tiny_ds, JAdjacency.from_edges(tiny_ds.edges,
                                           tiny_ds.num_vertices),
            Adjacency.from_edges(tiny_ds.edges, tiny_ds.num_vertices))


@pytest.mark.parametrize("use_native,exact", [(False, False), (False, True),
                                              (True, False)])
@pytest.mark.parametrize("degree_mode", ["global", "sampled"])
@pytest.mark.parametrize("kind", ["gcn", "mean", "none"])
def test_host_blocks_bit_identical(graphs, kind, degree_mode, use_native,
                                   exact):
    if use_native and shutil.which("g++") is None:
        pytest.skip("the native sampler builds with g++, which is missing")
    ds, jadj, tadj = graphs
    kw = dict(fanouts=[5, 3], batch_size=64, degree_mode=degree_mode,
              exact=exact, seed=3, use_native=use_native)
    js = JHostSampler(jadj, weight_kind=JWeightKind(kind), **kw)
    ts = HostSampler(tadj, weight_kind=WeightKind(kind), **kw)
    assert js.use_native == use_native   # the JAX package built its copy
    nids = np.arange(0, ds.num_vertices, 3)
    jb = list(js.epoch_seed_batches(nids))[:3]
    tb = list(ts.epoch_seed_batches(nids))[:3]
    for jseeds, tseeds in zip(jb, tb):
        np.testing.assert_array_equal(jseeds, tseeds)
        jh, th = js.sample(jseeds), ts.sample(tseeds)
        assert jh.num_seeds == th.num_seeds
        for jblk, tblk in zip(jh.blocks, th.blocks, strict=True):
            for f in FIELDS:
                np.testing.assert_array_equal(getattr(tblk, f),
                                              getattr(jblk, f), err_msg=f)
    for a, b in zip(th.payload(ds.features, ds.labels),
                    jh.payload(ds.features, ds.labels), strict=True):
        np.testing.assert_array_equal(a, b)


def test_native_raises_instead_of_switching(monkeypatch, graphs):
    """use_native=True never falls back to numpy, which draws otherwise."""
    def fail():
        raise RuntimeError("g++ failed to build the native sampler")

    monkeypatch.setattr(native, "load_library", fail)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        HostSampler(graphs[2], fanouts=[5, 3], batch_size=64)


def test_native_gather_rows_and_bounds():
    feats = np.arange(40, dtype=np.float32).reshape(10, 4)
    idx = np.array([3, 0, 9, -1], np.int32)
    valid = np.array([1, 1, 1, 0], bool)
    out = native.gather_rows(feats, idx, valid=valid)
    np.testing.assert_array_equal(out[:3], feats[[3, 0, 9]])
    assert not out[3].any()
    with pytest.raises(ValueError, match="out of range"):
        native.gather_rows(feats, np.array([10], np.int32))
    with pytest.raises(ValueError, match="out of range"):
        native.build_csc(np.array([[0, 5]]), 5)


# ------------------------------------------------------ device sampler ----
@pytest.fixture(scope="module")
def mid_ds():
    # 5,000 vertices: with batch 64 and fanout 5-3 the bottom hop's bound
    # (3,072) is below V, so both hops dedup and reindex
    return random_graph_dataset(5000, 8, 16, 5, seed=11)


def _device_trainer(ds, **kw):
    cfg = RunConfig(algorithm="GCNSAMPLEALLGPU", layer_sizes=[16, 8, 5],
                    fanout=[5, 3], batch_size=64, drop_rate=0.0,
                    vertices=ds.num_vertices, **kw)
    return DeviceSampleTrainer(cfg, ds, family="gcn",
                               weight_kind=WeightKind.GCN, device="cpu")


def _check_invariants(tr, batch):
    adj = tr.adj
    for blk, fanout in zip(batch.blocks, reversed(tr.cfg.fanout)):
        nbr, w = blk.nbr.numpy(), blk.weight.numpy()
        srcs, seeds = blk.srcs.numpy(), blk.seeds.numpy()
        src_valid, dst_valid = blk.src_valid.numpy(), blk.dst_valid.numpy()
        assert nbr.dtype == np.int32 and 0 <= nbr.min()
        assert nbr.max() < blk.num_src_pad
        real = srcs[src_valid]
        assert np.all(np.diff(real) > 0)            # sorted and unique
        assert np.isin(seeds[dst_valid], real).all()  # cover the seeds
        sis = blk.seed_in_src.numpy()[dst_valid]
        np.testing.assert_array_equal(srcs[sis], seeds[dst_valid])
        for d in np.nonzero(dst_valid)[0]:
            kept = srcs[nbr[d][w[d] != 0]]
            lo, hi = adj.indptr[seeds[d]], adj.indptr[seeds[d] + 1]
            in_edges = adj.indices[lo:hi]
            assert np.isin(kept, in_edges).all()    # real in-edges
            if hi - lo <= fanout:                   # small rows whole
                assert sorted(kept) == sorted(in_edges)
            elif np.unique(in_edges).size == hi - lo:
                assert np.unique(kept).size == kept.size   # no duplicates
        assert not w[~dst_valid].any()


def test_device_sampler_invariants(mid_ds):
    tr = _device_trainer(mid_ds)
    assert tr.src_pads[-1] < tr.dev_indptr.shape[0] - 1   # not identity
    for seeds, valid in tr._seed_batches(tr.train_nids, True):
        batch = tr.sample(seeds, valid)
        assert int(batch.overflow) == 0
        _check_invariants(tr, batch)
        break


def test_device_sampler_overflow_counted(mid_ds):
    tr = _device_trainer(mid_ds, src_pad_factor=0.05)
    seeds, valid = next(tr._seed_batches(tr.train_nids, True))
    batch = tr.sample(seeds, valid)
    assert int(batch.overflow) > 0
    for blk in batch.blocks:   # dropped edges never point past the pad
        assert int(blk.nbr.max()) < blk.num_src_pad


def test_device_sampler_identity_bottom_hop(tiny_ds):
    tr = _device_trainer(tiny_ds)
    v_pad = tr.dev_indptr.shape[0] - 1
    assert tr.src_pads[-1] == v_pad                 # the bound is all of V
    seeds, valid = next(tr._seed_batches(tr.train_nids, True))
    batch = tr.sample(seeds, valid)
    b0 = batch.blocks[0]
    np.testing.assert_array_equal(b0.srcs.numpy(), np.arange(v_pad))
    assert bool(b0.src_valid.all())
    assert batch.x0.data_ptr() == tr.dev_features.data_ptr()  # no re-gather
    _check_invariants(tr, batch)


@pytest.mark.parametrize("pad_factor", [0.0, 0.05])
def test_device_source_set_matches_rank_scatter(mid_ds, monkeypatch,
                                                pad_factor):
    """The blocks and the overflow count of a `sample` call are those of
    the rank scatter for the same draws: at exact pads and at pads so
    tight that the rank space overflows, on a full batch and on the
    epoch's last, whose padded seeds are invalid."""
    tr = _device_trainer(mid_ds, src_pad_factor=pad_factor)
    batches = list(tr._seed_batches(tr.train_nids, True))
    assert not bool(batches[-1][1].all())       # a partial last batch
    for seeds, valid in (batches[0], batches[-1]):
        own, ref = both_ways(monkeypatch, tr.sample_generator,
                             lambda: tr.sample(seeds, valid))
        assert int(own.overflow) == int(ref.overflow)
        assert (int(own.overflow) > 0) == (pad_factor > 0)
        assert_same_blocks(own.blocks, ref.blocks)
        np.testing.assert_array_equal(own.x0.numpy(), ref.x0.numpy())


@pytest.mark.parametrize("ds_name,rank_hops", [("mid_ds", 2), ("tiny_ds", 1)])
def test_device_sampler_counts_rank_hops(request, ds_name, rank_hops):
    """`sampler.rank_hops` counts each hop that builds a source set: both
    hops on `mid_ds`, the seed hop alone on `tiny_ds`, whose bottom hop
    is the identity hop."""
    tr = _device_trainer(request.getfixturevalue(ds_name))
    seeds, valid = next(tr._seed_batches(tr.train_nids, True))
    counters = timing.RECORDER.counters
    before = counters.get("sampler.rank_hops")
    tr.sample(seeds, valid)
    assert counters.get("sampler.rank_hops") - before == rank_hops
