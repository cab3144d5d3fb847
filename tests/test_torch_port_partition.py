"""Port parity, vertex-partitioned whole-graph training on the CPU.

The port's graph partitioning, halo plans, exchanges and sharded
`FullBatchTrainer` against the JAX package on the same numpy inputs.  JAX
runs on the conftest's virtual CPU devices on a `make_mesh(data=1,
graph=n)` mesh; the port runs n gloo ranks, one process each
(tests/_torch_dp_worker.py, `run_ranks`), with `device="cpu"`.

- `degree_balanced_ranges` / `partition_graph`, `shard_graph` and
  `build_targeted_halo` at n = 2 and 4 under both balances: offsets, slots
  and send plans exact, and each shard's CSR holds exactly the JAX shard's
  real edges in the same order.
- The exchanges and the shard-local layers at n = 2 and 4: the exchange
  delivers what its one-process reference gives; the all_gather and
  targeted GCN aggregations and the GAT layer (heads 2, both halos),
  forward and gradients, against the JAX `shard_map` at the f32 op
  tolerance (rtol 1e-5, tests/test_ops.py:47), as max |Δ| / max |ref|.
- `FullBatchTrainer` on 2 ranks against the JAX trainer on a graph = 2 mesh
  from the same parameters at drop 0 for 2 epochs (RNG does not cross
  frameworks): losses and every parameter within 1e-5 (GCN all_gather and
  targeted, GAT heads 2 targeted, BATCH_NORM, AGGREGATOR max,
  FEATURE_DTYPE:int8, equal and degree balance); `predict()` against the
  JAX sharded predict on the same parameters.
- At drop 0.5, 2 ranks against the port's single-device trainer (the
  layout-invariant dropout; GAT under OPTIMIZER sgd: the destination half
  of its attention vector has gradients of ~1e-10, the softmax being
  shift-invariant but for leaky_relu's kink, whose sign the ranks' other
  summation order flips there, and Adam (epsilon 1e-9) turns a flipped
  sign into a step of ±lr, 3e-5 on the second loss — the amplification
  tests/test_fullbatch.py:52-55 describes); the exchanges' backward and a
  whole run repeated bit for bit (no float atomics); a one-rank group bit
  for bit as the single-device program; `FullBatchEngine`'s routing under
  2 ranks and 1.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import shard_map
from jax.sharding import PartitionSpec as P

from sgnn_tpu.config import RunConfig as JRunConfig
from sgnn_tpu.graph.adjacency import Adjacency as JAdjacency
from sgnn_tpu.graph.partition import (
    degree_balanced_ranges as j_ranges, partition_graph as j_partition,
)
from sgnn_tpu.parallel import halo as jhalo
from sgnn_tpu.parallel.mesh import make_mesh
from sgnn_tpu.sampler.blocks import WeightKind as JWeightKind
from sgnn_tpu.train.fullbatch import FullBatchTrainer as JFullBatchTrainer
from sgnn_tpu.train.fullbatch import build_coo as j_build_coo

from sgnn_tpu_torch.config import RunConfig
from sgnn_tpu_torch.graph import (
    Adjacency, degree_balanced_ranges, partition_graph,
)
from sgnn_tpu_torch.parallel.halo import build_targeted_halo, shard_graph
from sgnn_tpu_torch.parallel.mesh import (
    DataGroup, check_graph_axis, make_group,
)
from sgnn_tpu_torch.sampler.blocks import WeightKind
from sgnn_tpu_torch.train import build_trainer
from sgnn_tpu_torch.train.engines import FullBatchEngine
from sgnn_tpu_torch.train.fullbatch import FullBatchTrainer, build_coo

from _torch_dp_worker import run_ranks, warm_cpu_exp

RTOL = 1e-5
GAT_HEADS = 2


@pytest.fixture(autouse=True, scope="module")
def _warm_exp():
    """This process's single-device GAT references start from a warm exp,
    as the ranks do (`warm_cpu_exp`)."""
    warm_cpu_exp()


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _mesh(n):
    return make_mesh(data=1, graph=n, devices=jax.devices()[:n])


def _adjs(ds):
    return (Adjacency.from_edges(ds.edges, ds.num_vertices),
            JAdjacency.from_edges(ds.edges, ds.num_vertices))


# ------------------------------------------------------------ host plans --
@pytest.mark.parametrize("n", [2, 4])
def test_partition_matches_jax(tiny_ds, cora, n):
    for ds in (tiny_ds, cora):
        adj, jadj = _adjs(ds)
        np.testing.assert_array_equal(
            degree_balanced_ranges(adj.in_degree, n),
            j_ranges(jadj.in_degree, n))
        got, want = partition_graph(adj, n), j_partition(jadj, n)
        assert len(got) == len(want) == n
        for a, b in zip(got, want):
            assert (a.part_id, a.start, a.end, a.num_owned) == (
                b.part_id, b.start, b.end, b.num_owned)
            np.testing.assert_array_equal(a.halo, b.halo)
            np.testing.assert_array_equal(a.halo_owner, b.halo_owner)


def _shard_rows(rowptr):
    return np.repeat(np.arange(rowptr.size - 1), np.diff(rowptr))


@pytest.mark.parametrize("balance", ["equal", "degree"])
@pytest.mark.parametrize("n", [2, 4])
def test_shard_plans_match_jax(cora, n, balance):
    """Cora's skewed degrees make the degree-balanced ranges ragged."""
    adj, jadj = _adjs(cora)
    _, _, w = build_coo(adj, WeightKind.GCN)
    _, _, jw = j_build_coo(jadj, JWeightKind.GCN)
    np.testing.assert_array_equal(w, jw[: adj.num_edges])
    sg = shard_graph(adj, n, w, balance=balance)
    jsg = jhalo.shard_graph(jadj, n, w, balance=balance)
    np.testing.assert_array_equal(sg.offsets, jsg.offsets)
    np.testing.assert_array_equal(sg.slot_of_vertex, jsg.slot_of_vertex)
    np.testing.assert_array_equal(sg.shard_meta, jsg.shard_meta)
    assert sg.rows_per_shard == jsg.rows_per_shard
    th = build_targeted_halo(adj, n, w, balance=balance)
    jth = jhalo.build_targeted_halo(jadj, n, w, balance=balance)
    np.testing.assert_array_equal(th.send_idx, np.asarray(jth.send_idx))
    assert (th.halo_pad, th.rows_per_shard) == (jth.halo_pad,
                                               jth.rows_per_shard)
    for p in range(n):
        real = np.asarray(jsg.weight[p]) != 0
        e_p = int(real.sum())
        # the JAX shard's real edges, in the same (CSC) order
        assert real[:e_p].all() and sg.src[p].size == e_p
        dst = _shard_rows(sg.rowptr[p])
        np.testing.assert_array_equal(dst, np.asarray(jsg.dst_local[p])[:e_p])
        np.testing.assert_array_equal(sg.src[p], np.asarray(jsg.src[p])[:e_p])
        np.testing.assert_array_equal(sg.weight[p],
                                      np.asarray(jsg.weight[p])[:e_p])
        np.testing.assert_array_equal(th.rowptr[p], sg.rowptr[p])
        np.testing.assert_array_equal(th.src_local[p],
                                      np.asarray(jth.src_local[p])[:e_p])
        assert sg.rowptr[p].size == sg.rows_per_shard + 1
        assert int(sg.src[p].max()) < sg.num_src
        assert int(th.src_local[p].max()) < th.num_src
        # only the real rows of each pair are counted
        for q in range(n):
            cnt = int(th.send_cnt[p, q])
            assert not th.send_idx[p, q, cnt:].any()
            assert np.unique(th.send_idx[p, q, :cnt]).size == cnt


# ------------------------------------------------------ exchanges, layers --
@pytest.fixture(scope="module", params=[2, 4], ids=["n2", "n4"])
def layers(request, tiny_ds, tmp_path_factory):
    """One launch of n port ranks over carried slot tables (the worker's
    graph is tiny_ds), and the JAX plans of the same graph."""
    n = request.param
    jadj = JAdjacency.from_edges(tiny_ds.edges, tiny_ds.num_vertices)
    rows = jhalo.shard_graph(jadj, n, np.ones(jadj.num_edges, np.float32),
                             balance="degree").rows_per_shard
    rng = np.random.default_rng(n)
    inp = {"x": rng.standard_normal((n * rows, 8)).astype(np.float32),
           "c": rng.standard_normal((n * rows, 8)).astype(np.float32),
           "h": rng.standard_normal((n * rows, 12)).astype(np.float32),
           "wl": (rng.standard_normal((12, 8)) * 0.3).astype(np.float32),
           "attn": (rng.standard_normal((16, 1)) * 0.3).astype(np.float32),
           "c_gat": rng.standard_normal((n * rows, 8)).astype(np.float32),
           "heads": GAT_HEADS}
    outs = run_ranks("partition_layers", inp,
                     str(tmp_path_factory.mktemp(f"layers{n}")), world=n)
    return n, jadj, inp, outs


def _jax_plan(jadj, n, halo, wk):
    _, _, w = j_build_coo(jadj, wk)
    w = w[: jadj.num_edges]
    if halo == "targeted":
        t = jhalo.build_targeted_halo(jadj, n, w, balance="degree")
        return t.send_idx, t.src_local, t.dst_local, t.weight
    s = jhalo.shard_graph(jadj, n, w, balance="degree")
    return None, s.src, s.dst_local, s.weight


def _cat(outs, key):
    return np.concatenate([o[key] for o in outs])


def test_exchange_delivers_the_reference(layers):
    _, _, _, outs = layers
    for o in outs:
        assert o["all_gather_GCN_exchange_equal"]
        assert o["targeted_GCN_exchange_equal"]


def test_exchange_backward_repeats_bit_for_bit(layers):
    """The reduce_scatter and the targeted halo's in-order adds: the input
    gradient of a second run is bit-identical (at n = 4 rows go to several
    ranks)."""
    n, _, _, outs = layers
    for o in outs:
        assert o["all_gather_GCN_repeat_equal"]
        assert o["targeted_GCN_repeat_equal"]


@pytest.mark.parametrize("halo", ["all_gather", "targeted"])
def test_sharded_aggregate_matches_jax(layers, halo):
    n, jadj, inp, outs = layers
    sidx, src, dst, w = _jax_plan(jadj, n, halo, JWeightKind.GCN)
    spec = P("graph")

    @jax.jit
    def loss(x):
        if sidx is None:
            f = shard_map(lambda xs, s, d, ww: jhalo.sharded_aggregate(
                xs, s[0], d[0], ww[0]), mesh=_mesh(n),
                in_specs=(spec,) * 4, out_specs=spec)
            y = f(x, src, dst, w)
        else:
            f = shard_map(lambda xs, si, s, d, ww:
                          jhalo.sharded_aggregate_targeted(
                              xs, si[0], s[0], d[0], ww[0]), mesh=_mesh(n),
                          in_specs=(spec,) * 5, out_specs=spec)
            y = f(x, sidx, src, dst, w)
        return jnp.sum(y * inp["c"]), y

    (_, y), dx = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(inp["x"]))
    assert _rel(_cat(outs, f"{halo}_GCN_out"), y) <= RTOL
    assert _rel(_cat(outs, f"{halo}_GCN_dx"), dx) <= RTOL


@pytest.mark.parametrize("halo", ["all_gather", "targeted"])
def test_sharded_gat_layer_matches_jax(layers, halo):
    n, jadj, inp, outs = layers
    sidx, src, dst, w = _jax_plan(jadj, n, halo, JWeightKind.NONE)
    spec = P("graph")
    if sidx is None:
        sidx = jnp.zeros((n, 1, 1), jnp.int32)

    @jax.jit
    def loss(h, wl, attn):
        def body(hs, si, s, d, ww):
            return jhalo.sharded_gat_layer(
                hs, wl, attn, s[0], d[0], ww[0] != 0,
                send_idx=si[0] if halo == "targeted" else None,
                heads=GAT_HEADS)

        y = shard_map(body, mesh=_mesh(n), in_specs=(spec,) * 5,
                      out_specs=spec)(h, sidx, src, dst, w)
        return jnp.sum(y * inp["c_gat"]), y

    (_, y), (dh, dw, da) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(inp[k]) for k in ("h", "wl", "attn")))
    assert _rel(_cat(outs, f"{halo}_NONE_out"), y) <= RTOL
    assert _rel(_cat(outs, f"{halo}_NONE_dh"), dh) <= RTOL
    # the replicated W and attention: each rank's partial, summed
    assert _rel(sum(o[f"{halo}_NONE_dw"] for o in outs), dw) <= RTOL
    assert _rel(sum(o[f"{halo}_NONE_da"] for o in outs), da) <= RTOL


# ------------------------------------------------------------ the trainer --
def _cfg(**kw):
    base = dict(layer_sizes=[32, 16, 5], learn_rate=0.02, drop_rate=0.0,
                vertices=500, seed=3, partition_balance="degree")
    return dict(base, **kw)


# id: (family, weight kind, halo, cfg changes); drop 0 against JAX
JAX_CASES = {
    "gcn-all_gather": ("gcn", "GCN", "all_gather", {}),
    "gcn-targeted": ("gcn", "GCN", "targeted", {}),
    "gcn-equal": ("gcn", "GCN", "targeted", dict(partition_balance="equal")),
    "gcn-bn": ("gcn", "GCN", "all_gather", dict(batch_norm=True)),
    "sage-max": ("sage", "MEAN", "targeted", dict(aggregator="max")),
    "gcn-int8": ("gcn", "GCN", "all_gather", dict(feature_dtype="int8")),
    "gat-h2-targeted": ("gat", "NONE", "targeted", dict(heads=GAT_HEADS)),
    "gat-h2-equal": ("gat", "NONE", "all_gather",
                     dict(heads=GAT_HEADS, partition_balance="equal")),
}
# drop 0.5 against the port's single-device trainer
DROP_CASES = {
    "drop-gcn-targeted": ("gcn", "GCN", "targeted", dict(drop_rate=0.5)),
    "drop-sage-all_gather": ("sage", "MEAN", "all_gather",
                             dict(drop_rate=0.5, batch_norm=True)),
    "drop-gat-h2": ("gat", "NONE", "all_gather",
                    dict(drop_rate=0.5, heads=GAT_HEADS, optimizer="sgd")),
}
EPOCHS = 2


@pytest.fixture(scope="module")
def train2(tiny_ds, tmp_path_factory):
    """The JAX trainers on a graph = 2 mesh (GAT attention drawn nonzero)
    and one launch of 2 port ranks training every case."""
    jax_trainers, inputs, configs = {}, {}, []
    for cid, (family, wk, halo, change) in JAX_CASES.items():
        cfg = _cfg(**change)
        jt = JFullBatchTrainer(JRunConfig(**cfg), tiny_ds, family=family,
                               weight_kind=JWeightKind[wk], mesh=_mesh(2),
                               halo=halo)
        if family == "gat":
            rng = np.random.default_rng(3)
            jt.params = jt.params._replace(attn=tuple(
                jnp.asarray(rng.standard_normal(a.shape) * 0.5, jnp.float32)
                for a in jt.params.attn))
        leaves = [np.asarray(a) for a in (*jt.params.weights,
                                          *jt.params.attn)]
        inputs[f"{cid}_w_n"] = len(leaves)
        inputs.update({f"{cid}_w{i}": a for i, a in enumerate(leaves)})
        jax_trainers[cid] = jt
        configs.append(dict(id=cid, cfg=cfg, family=family, weight_kind=wk,
                            halo=halo, epochs=EPOCHS,
                            repeat=cid == "gcn-targeted"))
    for cid, (family, wk, halo, change) in DROP_CASES.items():
        configs.append(dict(id=cid, cfg=_cfg(**change), family=family,
                            weight_kind=wk, halo=halo, epochs=EPOCHS,
                            repeat=cid == "drop-gat-h2"))
    inputs["configs"] = json.dumps(configs)
    outs = run_ranks("partition_train", inputs,
                     str(tmp_path_factory.mktemp("train2")), world=2)
    return jax_trainers, outs


def _port_params(out, cid):
    n = sum(k.startswith(f"{cid}_p") and k[len(cid) + 2:].isdigit()
            for k in out)
    return [out[f"{cid}_p{i}"] for i in range(n)]


@pytest.mark.parametrize("cid", sorted(JAX_CASES))
def test_two_ranks_train_as_the_jax_mesh(train2, cid):
    jax_trainers, outs = train2
    jt = jax_trainers[cid]
    want = np.array([jt.train_epoch() for _ in range(EPOCHS)])
    for o in outs:   # every rank reports the same run
        got = o[f"{cid}_rows"]
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL)
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=0.01)
        ref = [np.asarray(a) for a in (*jt.params.weights, *jt.params.attn)]
        mine = _port_params(o, cid)
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            assert _rel(a, b) <= RTOL, cid
    for a, b in zip(_port_params(outs[0], cid), _port_params(outs[1], cid)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cid", ["gcn-bn", "gat-h2-targeted"])
def test_predict_matches_the_jax_sharded_predict(train2, cid):
    """The port's predict() after training against the JAX sharded predict
    program on the port's final parameters."""
    jax_trainers, outs = train2
    jt = jax_trainers[cid]
    leaves = [jnp.asarray(a) for a in _port_params(outs[0], cid)]
    nw = len(jt.params.weights)
    jt.params = jt.params._replace(weights=tuple(leaves[:nw]),
                                   attn=tuple(leaves[nw:]))
    want = jt.predict()
    for o in outs:
        assert o[f"{cid}_pred"].shape == want.shape == (500, 5)
        assert _rel(o[f"{cid}_pred"], want) <= RTOL


@pytest.mark.parametrize("cid", sorted(DROP_CASES))
def test_two_ranks_drop_as_one_device(tiny_ds, train2, cid):
    """Every rank draws the whole dropout mask as the single-device trainer
    does: 2 ranks train as one device at drop 0.5."""
    _, outs = train2
    family, wk, halo, change = DROP_CASES[cid]
    single = FullBatchTrainer(RunConfig(**_cfg(**change)), tiny_ds,
                              family=family, weight_kind=WeightKind[wk],
                              device="cpu")
    want = np.array([single.train_epoch() for _ in range(EPOCHS)])
    got = outs[0][f"{cid}_rows"]
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], atol=0.01)
    for a, b in zip(_port_params(outs[0], cid), single.params.leaves()):
        assert _rel(a, b.numpy()) <= RTOL
    assert _rel(outs[0][f"{cid}_pred"], single.predict()) <= RTOL


def test_repeated_runs_are_bit_identical(train2):
    """The targeted backward's in-order adds and the reduce_scatter: no
    float atomics, the same parameters on a second run."""
    _, outs = train2
    for o in outs:
        assert o["gcn-targeted_repeat_equal"]
        assert o["drop-gat-h2_repeat_equal"]


def test_engine_shards_over_the_ranks(train2):
    """PARTITION_GRAPH:1 under 2 ranks: the engine's trainer on a graph
    group of both, with HALO and PARTITION_BALANCE."""
    _, outs = train2
    for r, o in enumerate(outs):
        eng = json.loads(str(o["engine"]))
        assert eng == {"type": "FullBatchEngine", "world": 2, "graph": 2,
                       "rows": 256, "targeted": True,
                       "offsets": [0, 256, 500]}


# ------------------------------------------------------------- one rank --
@pytest.fixture
def one_rank():
    group = make_group("cpu")
    yield group
    dist.destroy_process_group()


@pytest.mark.parametrize("family,halo,aggregator", [
    ("gcn", "targeted", "sum"), ("gat", "all_gather", "sum"),
    ("sage", "all_gather", "max")])
def test_one_rank_group_is_the_single_device_program(tiny_ds, one_rank,
                                                     family, halo,
                                                     aggregator):
    """The sharded program with n = 1 against the single-device one at drop
    0.5: the same draws, and every product and sum over the same rows (a
    rank keeps only its real rows between layers; the shard's CSR adds 4
    empty rows), so bit for bit."""
    cfg = RunConfig(**_cfg(drop_rate=0.5, heads=GAT_HEADS,
                           aggregator=aggregator))
    wk = WeightKind.MEAN if family == "sage" else WeightKind.GCN
    single = FullBatchTrainer(cfg, tiny_ds, family=family, weight_kind=wk,
                              device="cpu")
    sharded = FullBatchTrainer(cfg, tiny_ds, family=family, weight_kind=wk,
                               mesh=one_rank, halo=halo, device="cpu")
    assert sharded.shard.rows == 504 and sharded.group is one_rank
    for _ in range(EPOCHS):
        assert sharded.train_epoch() == single.train_epoch()
    for a, b in zip(sharded.params.leaves(), single.params.leaves()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(sharded.predict(), single.predict())
    state = sharded.checkpoint_state()
    assert set(state) == {"params", "opt_state", "dropout_rng"}
    sharded.load_checkpoint_state(state)


def test_one_rank_engine_runs_the_single_device_program(tiny_ds):
    """PARTITION_GRAPH:1 with one rank: the JAX engine's warning and the
    single-device trainer (no group is joined)."""
    cfg = RunConfig(**_cfg(algorithm="GCNFULLBATCH", partition_graph=True))
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("sgnn.engine")
    log.addHandler(handler)
    try:
        eng = build_trainer(cfg, tiny_ds, device="cpu")
    finally:
        log.removeHandler(handler)
    assert isinstance(eng, FullBatchEngine) and eng.base.group is None
    assert not hasattr(eng, "group") and not dist.is_initialized()
    assert any("only one device is visible" in r.getMessage()
               for r in records)


def test_graph_axis_checks(tiny_ds):
    """A graph group must hold every rank: a count that does not divide the
    group is a ValueError, a mixed data × graph layout not ported (the JAX
    trainer has none); the trainer takes only a graph group."""
    check_graph_axis(4, 4)
    with pytest.raises(ValueError, match="graph=3"):
        check_graph_axis(3, 4)
    with pytest.raises(ValueError, match="graph=2"):
        check_graph_axis(2, 1)
    with pytest.raises(NotImplementedError, match="mixed layout"):
        check_graph_axis(2, 4)
    data = DataGroup(rank=0, world_size=2, device=torch.device("cpu"),
                     backend="gloo")
    cfg = RunConfig(**_cfg())
    with pytest.raises(ValueError, match="graph axis"):
        FullBatchTrainer(cfg, tiny_ds, mesh=data, device="cpu")
    with pytest.raises(TypeError, match="graph group"):
        FullBatchTrainer(cfg, tiny_ds, mesh=object(), device="cpu")
