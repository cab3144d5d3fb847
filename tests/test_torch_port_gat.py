"""Port parity, GAT: sgnn_tpu_torch against sgnn_tpu on the CPU.

* K3's function: `gat_aggregate_plain` against the JAX package's windowed
  f32 composition (`attention_exp` + `spmm_coo` + a `segment_sum` divide,
  as tests/test_mxu_gat.py:78-107) and against the Pallas kernel
  `mxu_gat_aggregate` in interpret mode; `pack_score_tables` against JAX's.
* Serving: `InferenceServer(family="gat")`, `layerwise_inference`,
  `exact_accuracy` and `query` against the JAX package's on `tiny_ds` and
  Cora, heads 1 and 4, with nonzero attention vectors (`init_model`'s
  zeros would give uniform attention and leave the scores untested).
* Sampled GAT: `model_forward("gat")` log-probs and gradients on the same
  host-sampled blocks, the edge ops, the trainers and GATSAMPLEALLGPU.

Inputs are made with numpy from a seed; weights cross by
`params_from_numpy(weights, attn)`.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.graph.adjacency import Adjacency as JAdjacency
from sgnn_tpu.models.gnn import init_model as j_init_model
from sgnn_tpu.models.gnn import model_forward as j_model_forward
from sgnn_tpu.nn.functional import nll_loss_masked as j_nll
from sgnn_tpu.ops import aggregate as jagg
from sgnn_tpu.ops.pallas.mxu_gat import (
    build_mxu_gat_plan, mxu_gat_aggregate,
    pack_score_tables as j_pack_score_tables,
)
from sgnn_tpu.ops.segment import attention_exp, spmm_coo
from sgnn_tpu.sampler.blocks import WeightKind as JWeightKind
from sgnn_tpu.sampler.host import HostSampler as JHostSampler
from sgnn_tpu.train.inference import (
    InferenceServer as JServer, exact_accuracy as j_exact_accuracy,
    layerwise_inference as j_layerwise,
)
from sgnn_tpu.train.trainer import SampleTrainer as JSampleTrainer
from sgnn_tpu.train.trainer import host_batch_to_device as j_to_device

from sgnn_tpu_torch.config import load_cfg
from sgnn_tpu_torch.graph.adjacency import Adjacency
from sgnn_tpu_torch.models.gnn import model_forward, params_from_numpy
from sgnn_tpu_torch.ops import aggregate as tagg
from sgnn_tpu_torch.ops.gat import (
    ATT_CLIP, gat_aggregate, gat_aggregate_plain, pack_score_tables,
)
from sgnn_tpu_torch.sampler.blocks import WeightKind
from sgnn_tpu_torch.train import build_trainer, run_engine
from sgnn_tpu_torch.train.device_trainer import DeviceSampleTrainer
from sgnn_tpu_torch.train.inference import (
    InferenceServer, exact_accuracy, layerwise_inference,
)
from sgnn_tpu_torch.train.trainer import (
    SampleTrainer, host_batch_to_device, loss_and_grads,
)

CFG = os.path.join(os.path.dirname(__file__), "..", "configs",
                   "gcn_cora_sample.cfg")
# the repo's f32 op tolerance (tests/test_ops.py:47): f32 on both sides,
# only the summation order differs
RTOL = 1e-5
# the Pallas kernel's bf16 bound (tests/test_mxu_gat.py:75)
BF16_KERNEL = 3e-2
# whole-graph GAT log-probs, absolute: JAX's fast path broadcasts each
# destination's score half through an f32 cumsum over all edges
# (sgnn_tpu/ops/segment.py:759-765, broadcast_dst_sorted), whose roundoff
# (up to ~6e-5 by its own account) reaches the scores through leaky_relu's
# slope change; the port reads td[d] directly
SERVE_ATOL = 1e-4
# bf16 residency against JAX's bf16 server: the two round at other points
# (JAX scores and attention in bf16, the port's tables and sums in f32),
# the GCN/SAGE serving tests' bf16 bound (tests/test_torch_port_serving.py)
BF16_ATOL = 0.05
# queries: JAX's query takes the max-shifted softmax, the port the clipped
# max-free one; equal while |score| < 60, so only rounding differs
QUERY = dict(rtol=1e-5, atol=1e-5)
LOGP = dict(rtol=1e-5, atol=1e-5)
GRAD_MAX_REL = 1e-4   # max |Δg| / max |g| per weight and attention vector


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


# ------------------------------------------------------------ kernel -----
def _skewed_graph(rng, v_dst, v_src, e, empty=(1, 2, 5)):
    """dst-sorted edges: zipf-skewed destinations (hub rows), some rows
    with no edges; src drawn from [0, v_src)."""
    dst = (rng.zipf(1.5, e) % v_dst).astype(np.int32)
    dst = np.sort(dst[~np.isin(dst, empty)], kind="stable")
    src = rng.integers(0, v_src, dst.size).astype(np.int32)
    rowptr = np.zeros(v_dst + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=v_dst), out=rowptr[1:])
    return src, dst, rowptr


def _tables(rng, v_src, v_dst, f, heads, a_scale):
    ht = (rng.standard_normal((v_src, f)) * 0.5).astype(np.float32)
    ht_dst = (rng.standard_normal((v_dst, f)) * 0.5).astype(np.float32)
    a_src = (rng.standard_normal(f) * a_scale).astype(np.float32)
    a_dst = (rng.standard_normal(f) * a_scale).astype(np.float32)
    ts, _ = pack_score_tables(torch.from_numpy(ht), torch.from_numpy(a_src),
                              torch.from_numpy(a_dst), heads)
    _, td = pack_score_tables(torch.from_numpy(ht_dst),
                              torch.from_numpy(a_src),
                              torch.from_numpy(a_dst), heads)
    return ht, ts.numpy(), td.numpy()


def _jax_windowed(ht, ts, td, src, dst, v_dst, heads):
    """The JAX package's windowed f32 composition, per head: scores,
    attention_exp, spmm_coo of the head's block, segment_sum z, divide."""
    fh = ht.shape[1] // heads
    srcj, dstj = jnp.asarray(src), jnp.asarray(dst)
    outs, zs = [], []
    for h in range(heads):
        score = jax.nn.leaky_relu(jnp.asarray(ts[:, h])[srcj]
                                  + jnp.asarray(td[:, h])[dstj], 0.2)
        u = attention_exp(score, jnp.ones(src.size, bool))
        agg = spmm_coo(jnp.asarray(ht[:, h * fh:(h + 1) * fh]), srcj, dstj,
                       u, v_dst)
        z = jax.ops.segment_sum(u, dstj, num_segments=v_dst)
        outs.append(np.asarray(agg)
                    / np.maximum(np.asarray(z), np.finfo(np.float32).tiny)
                    [:, None])
        zs.append(np.asarray(z))
    return np.concatenate(outs, 1), np.stack(zs, 1)


@pytest.mark.parametrize("heads,f", [(1, 24), (2, 32), (4, 64)])
def test_plain_matches_jax_windowed(heads, f):
    rng = np.random.default_rng(10 + heads)
    v_dst, v_src = 700, 900                # sources != destinations
    src, dst, rowptr = _skewed_graph(rng, v_dst, v_src, 6000)
    # attention scale so that scores pass ±60: the clip is exercised
    ht, ts, td = _tables(rng, v_src, v_dst, f, heads, a_scale=12.0)
    raw = ts[src] + td[dst]
    assert (raw > ATT_CLIP).any() and (np.abs(raw) < ATT_CLIP).mean() > 0.5
    h, z = gat_aggregate(torch.from_numpy(ht), torch.from_numpy(ts),
                         torch.from_numpy(td), torch.from_numpy(rowptr),
                         torch.from_numpy(src), heads)
    assert h.dtype == torch.float32 and z.shape == (v_dst, heads)
    ref_h, ref_z = _jax_windowed(ht, ts, td, src, dst, v_dst, heads)
    np.testing.assert_allclose(h.numpy(), ref_h, rtol=RTOL,
                               atol=RTOL * np.abs(ref_h).max())
    np.testing.assert_allclose(z.numpy(), ref_z, rtol=RTOL)
    assert (h.numpy()[[1, 2, 5]] == 0).all() and (z.numpy()[[1, 2, 5]] == 0).all()
    assert np.diff(rowptr).max() > 200     # a hub row


@pytest.mark.parametrize("heads,f", [(1, 48), (2, 32), (4, 64)])
def test_plain_matches_pallas_kernel_interpret(heads, f):
    """The same function as the Pallas kernel, on its own quantized inputs:
    the kernel rounds ht and the score tables to bf16, so the plain
    version is given those rounded tables (it takes the tables as they
    are) and held at the kernel's bf16 bound."""
    rng = np.random.default_rng(5)
    v = 1100
    src, dst, rowptr = _skewed_graph(rng, v, v, 5000)
    plan = build_mxu_gat_plan(src, dst, v, v, s_blk=256, d_blk=512,
                              w_win=128, e_sub=64, e_t=256,
                              max_pad_ratio=50.0, chunk_steps=7)
    assert plan is not None
    ht = (rng.standard_normal((v, f)) * 0.5).astype(np.float32)
    a_src = (rng.standard_normal(f) * 0.2).astype(np.float32)
    a_dst = (rng.standard_normal(f) * 0.2).astype(np.float32)
    out = np.asarray(mxu_gat_aggregate(
        jnp.asarray(ht), jnp.asarray(a_src), jnp.asarray(a_dst),
        *plan.operands, plan.static, heads=heads))

    def bf16(a):
        return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)

    htb = bf16(ht)
    ts, td = pack_score_tables(torch.from_numpy(htb), torch.from_numpy(a_src),
                               torch.from_numpy(a_dst), heads)
    h, _ = gat_aggregate_plain(
        torch.from_numpy(htb), torch.from_numpy(bf16(ts.numpy())),
        torch.from_numpy(bf16(td.numpy())), torch.from_numpy(rowptr),
        torch.from_numpy(src), heads)
    assert _rel(h.numpy(), out) < BF16_KERNEL
    # rows with no edges: zeros on both sides
    assert (out[[1, 2, 5]] == 0).all() and (h.numpy()[[1, 2, 5]] == 0).all()


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_pack_score_tables_match_jax(heads):
    rng = np.random.default_rng(heads)
    f = 32
    ht = rng.standard_normal((300, f)).astype(np.float32)
    a_src = rng.standard_normal(f).astype(np.float32)
    a_dst = rng.standard_normal(f).astype(np.float32)
    ts, td = pack_score_tables(torch.from_numpy(ht), torch.from_numpy(a_src),
                               torch.from_numpy(a_dst), heads)
    jts, jtd = j_pack_score_tables(jnp.asarray(ht), jnp.asarray(a_src),
                                   jnp.asarray(a_dst), heads)
    assert ts.shape == td.shape == (300, heads)   # no padding to 8 columns
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts)[:, :heads],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jtd)[:, :heads],
                               rtol=1e-6, atol=1e-6)


def test_gat_aggregate_rejects_bad_args():
    ht = torch.ones(4, 6)
    rowptr = torch.tensor([0, 1, 2], dtype=torch.int64)
    col = torch.tensor([0, 3], dtype=torch.int32)
    ts, td = torch.zeros(4, 2), torch.zeros(2, 2)
    h, z = gat_aggregate(ht, ts, td, rowptr, col, 2)
    assert h.shape == (2, 6) and torch.equal(z, torch.ones(2, 2))
    for bad in (
            lambda: gat_aggregate(ht, ts, td, rowptr, col, 4),   # 4 ∤ 6
            lambda: gat_aggregate(ht.double(), ts, td, rowptr, col, 2),
            lambda: gat_aggregate(ht, ts.double(), td, rowptr, col, 2),
            lambda: gat_aggregate(ht, ts, torch.zeros(3, 2), rowptr, col, 2),
            lambda: gat_aggregate(ht, ts, td, rowptr, col.long(), 2)):
        with pytest.raises(ValueError):
            bad()


# ----------------------------------------------------------- serving -----
@pytest.fixture(scope="module", params=["tiny", "cora"])
def setup(request, tiny_ds, cora):
    ds = tiny_ds if request.param == "tiny" else cora
    sizes = [32, 16, 5] if request.param == "tiny" else [1433, 32, 7]
    # attention scale: scores of O(1) on each dataset's activations
    scale = 1.0 if request.param == "tiny" else 8.0
    return (ds, JAdjacency.from_edges(ds.edges, ds.num_vertices),
            Adjacency.from_edges(ds.edges, ds.num_vertices), sizes, scale)


def _gat_params(sizes, scale, seed=21):
    jp = j_init_model(jax.random.PRNGKey(seed), "gat", sizes)
    rng = np.random.default_rng(seed)
    attn = [(rng.standard_normal(a.shape) * scale).astype(np.float32)
            for a in jp.attn]
    jp = jp._replace(attn=tuple(jnp.asarray(a) for a in attn))
    return jp, params_from_numpy([np.asarray(w) for w in jp.weights], attn,
                                 device="cpu")


def _servers(setup, heads, batch_norm=False, **kw):
    ds, ja, ta, sizes, scale = setup
    jp, tp = _gat_params(sizes, scale)
    js = JServer(jp, "gat", ja, ds.features, heads=heads,
                 batch_norm=batch_norm, **{k: v[0] for k, v in kw.items()})
    ts = InferenceServer(tp, "gat", ta, ds.features, heads=heads,
                         batch_norm=batch_norm, device="cpu",
                         **{k: v[1] for k, v in kw.items()})
    return js, ts


@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("heads", [1, 4])
def test_gat_logprobs_match_jax(setup, heads, batch_norm):
    js, ts = _servers(setup, heads, batch_norm)
    got = ts.logprobs()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - js.logprobs()).max() <= SERVE_ATOL
    np.testing.assert_array_equal(ts.predict(), np.argmax(got, -1))


@pytest.mark.parametrize("heads", [1, 4])
def test_gat_logprobs_bf16_match_jax(setup, heads):
    js, ts = _servers(setup, heads, dtype=(jnp.bfloat16, torch.bfloat16))
    got = ts.logprobs()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - js.logprobs()).max() <= BF16_ATOL


@pytest.mark.parametrize("heads", [1, 4])
def test_gat_query_matches_jax(setup, heads):
    js, ts = _servers(setup, heads)
    full = ts.logprobs()
    v = setup[0].num_vertices
    rng = np.random.default_rng(1)
    for nids in (np.array([7]), rng.integers(0, v, 33)):  # dups, unordered
        got = ts.query(nids)
        np.testing.assert_allclose(got, js.query(nids), **QUERY)
        np.testing.assert_allclose(got, full[nids], **QUERY)
        np.testing.assert_allclose(ts.query(nids, fanout=[5, 3], seed=3),
                                   js.query(nids, fanout=[5, 3], seed=3),
                                   **QUERY)
    # without a seed both servers draw from their own default_rng(0)
    for fan in (2, [4, 1]):
        np.testing.assert_allclose(ts.query(nids, fanout=fan),
                                   js.query(nids, fanout=fan), **QUERY)


@pytest.mark.parametrize("heads", [1, 4])
def test_gat_layerwise_and_exact_accuracy_equal(setup, heads):
    ds, ja, ta, sizes, scale = setup
    jp, tp = _gat_params(sizes, scale)
    got = layerwise_inference(tp, "gat", ta, ds.features, heads=heads,
                              device="cpu")
    ref = j_layerwise(jp, "gat", ja, ds.features, heads=heads,
                      whole_graph=True)
    assert np.abs(got - ref).max() <= SERVE_ATOL
    nids = ds.nids_with_mask(0)
    assert exact_accuracy(tp, "gat", ta, ds.features, ds.labels, nids,
                          heads=heads, device="cpu") == j_exact_accuracy(
        jp, "gat", ja, ds.features, ds.labels, nids, heads=heads)


def test_gat_update_params_warmup_and_checks(setup):
    ds, ja, ta, sizes, scale = setup
    js, ts = _servers(setup, 4)
    jp2, tp2 = _gat_params(sizes, scale, seed=99)
    ts.update_params(tp2)
    js.update_params(jp2)
    assert np.abs(ts.logprobs() - js.logprobs()).max() <= SERVE_ATOL
    assert ts.warmup(sizes=(1, 4), reps=2) >= 1
    # heads must divide the hidden width; GAT params need their attention
    with pytest.raises(ValueError, match="heads=3"):
        InferenceServer(tp2, "gat", ta, ds.features, heads=3, device="cpu")
    with pytest.raises(ValueError, match="attention vector"):
        InferenceServer(tp2._replace(attn=()), "gat", ta, ds.features,
                        device="cpu")
    # GAT ignores the aggregator, as the JAX package does
    srv = InferenceServer(tp2, "gat", ta, ds.features, heads=4,
                          aggregator="max", device="cpu")
    np.testing.assert_array_equal(srv.logprobs(), ts.logprobs())


# ------------------------------------------------------- sampled GAT -----
@pytest.fixture(scope="module")
def gat_batch(tiny_ds):
    adj = JAdjacency.from_edges(tiny_ds.edges, tiny_ds.num_vertices)
    sampler = JHostSampler(adj, fanouts=[6, 4], batch_size=96,
                           weight_kind=JWeightKind.NONE, seed=5,
                           use_native=False)
    hb = sampler.sample(np.arange(0, 400, 4, dtype=np.int32))
    payload = hb.payload(tiny_ds.features, tiny_ds.labels)
    return j_to_device(hb, *payload), host_batch_to_device(hb, *payload,
                                                           device="cpu")


@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("heads", [1, 4])
def test_sampled_gat_forward_and_grads_match_jax(gat_batch, heads,
                                                 batch_norm):
    jbatch, tbatch = gat_batch
    assert not bool(np.asarray(jbatch.blocks[0].weight != 0).all())  # padding
    jp, tp = _gat_params([32, 16, 5], 1.0, seed=9)

    def j_loss(p):
        logp = j_model_forward(p, "gat", jbatch, heads=heads,
                               batch_norm=batch_norm)
        return j_nll(logp, jbatch.labels, jbatch.label_valid), logp

    (jl, jlogp), jg = jax.value_and_grad(j_loss, has_aux=True)(jp)
    out = loss_and_grads(tp, "gat", tbatch, heads=heads,
                         batch_norm=batch_norm)
    np.testing.assert_allclose(out.logp.numpy(), np.asarray(jlogp), **LOGP)
    np.testing.assert_allclose(out.loss.item(), float(jl), rtol=1e-5)
    refs = [*jg.weights, *jg.attn]
    assert len(out.grads) == len(refs) == 4
    for g, ref in zip(out.grads, refs, strict=True):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        assert np.abs(g.numpy() - ref).max() <= GRAD_MAX_REL * np.abs(
            ref).max()


def test_sampled_gat_draws_no_dropout_and_remat_is_exact(gat_batch):
    tbatch = gat_batch[1]
    _, tp = _gat_params([32, 16, 5], 1.0, seed=4)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    a = loss_and_grads(tp, "gat", tbatch, heads=4, drop_rate=0.5,
                       generator=gen)
    assert torch.equal(gen.get_state(), state)   # nothing drawn
    b = loss_and_grads(tp, "gat", tbatch, heads=4, remat=True)
    assert torch.equal(a.logp, b.logp)
    for x, y in zip(a.grads, b.grads):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="heads=3"):
        model_forward(tp, "gat", tbatch, heads=3)


def test_edge_ops_match_jax():
    rng = np.random.default_rng(2)
    d, k, s, heads, fh = 40, 6, 50, 3, 4
    x = rng.standard_normal((s, heads * fh)).astype(np.float32)
    nbr = rng.integers(0, s, (d, k)).astype(np.int32)
    mask = rng.random((d, k)) < 0.7
    mask[3] = False                              # a row with no valid slot
    sc2 = rng.standard_normal((d, k)).astype(np.float32) * 3
    sc3 = rng.standard_normal((d, k, heads)).astype(np.float32) * 3
    g3 = rng.standard_normal((d, k, heads)).astype(np.float32)

    src_e = tagg.scatter_src_to_edges(torch.from_numpy(x),
                                      torch.from_numpy(nbr))
    np.testing.assert_array_equal(src_e.numpy(), np.asarray(
        jagg.scatter_src_to_edges(jnp.asarray(x), jnp.asarray(nbr))))
    np.testing.assert_array_equal(
        tagg.scatter_dst_to_edges(torch.from_numpy(x[:d]), k).numpy(),
        np.asarray(jagg.scatter_dst_to_edges(jnp.asarray(x[:d]), k)))
    for sc in (sc2, sc3):
        got = tagg.edge_softmax(torch.from_numpy(sc), torch.from_numpy(mask))
        ref = np.asarray(jagg.edge_softmax(jnp.asarray(sc), jnp.asarray(mask)))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
        assert (got.numpy()[3] == 0).all()
    # gradient of the softmax, the empty row included (finite, zero)
    t = torch.from_numpy(sc3).requires_grad_()
    (tagg.edge_softmax(t, torch.from_numpy(mask))
     * torch.from_numpy(g3)).sum().backward()
    jgrad = jax.grad(lambda s_: jnp.sum(jagg.edge_softmax(
        s_, jnp.asarray(mask)) * jnp.asarray(g3)))(jnp.asarray(sc3))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(t.grad.numpy()).all() and (t.grad.numpy()[3] == 0).all()
    att = rng.random((d, k)).astype(np.float32)
    msg = src_e.numpy()
    np.testing.assert_allclose(
        tagg.aggregate_edges_to_dst(torch.from_numpy(msg),
                                    torch.from_numpy(att)).numpy(),
        np.asarray(jagg.aggregate_edges_to_dst(jnp.asarray(msg),
                                               jnp.asarray(att))),
        rtol=1e-5, atol=1e-6)
    att3 = rng.random((d, k, heads)).astype(np.float32)
    msg4 = msg.reshape(d, k, heads, fh)
    np.testing.assert_allclose(
        tagg.aggregate_edges_to_dst(torch.from_numpy(msg4),
                                    torch.from_numpy(att3)).numpy(),
        np.asarray(jagg.aggregate_edges_to_dst(jnp.asarray(msg4),
                                               jnp.asarray(att3))),
        rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- training -----
def _cfg(**kw):
    return dataclasses.replace(load_cfg(CFG), **kw)


def test_gat_trainer_losses_match_jax(cora):
    """GAT heads 4 through the host sampler, 2 epochs at drop 0: the same
    blocks on both sides; losses within 1e-3 relative for the reason
    tests/test_torch_port_train.py:1-18 gives (Adam amplifies a sign flip
    of a near-zero gradient element under another summation order)."""
    cfg = _cfg(algorithm="GCNSAMPLEGPU", drop_rate=0.0, epochs=2, heads=4)
    jt = JSampleTrainer(cfg, cora, family="gat", weight_kind=JWeightKind.GCN,
                        degree_mode="global", bias_correction=True)
    tt = SampleTrainer(cfg, cora, family="gat", weight_kind=WeightKind.GCN,
                       bias_correction=True, device="cpu")
    assert tt.sampler.weight_kind == WeightKind.NONE   # forced for GAT
    tt.params = params_from_numpy([np.asarray(w) for w in jt.params.weights],
                                  [np.asarray(a) for a in jt.params.attn],
                                  device="cpu")
    for _ in range(2):
        jl, jacc, jedges = jt.train_epoch()
        tl, tacc, tedges = tt.train_epoch()
        assert tedges == jedges            # the same blocks
        np.testing.assert_allclose(tl, jl, rtol=1e-3)
        assert abs(tacc - jacc) <= 0.02


def test_gat_allgpu_reaches_the_engine_floor(cora):
    """GATSAMPLEALLGPU from the Cora cfg with only the ALGORITHM changed
    (heads 1): the JAX engine matrix's floor, 0.80 best train accuracy in
    8 epochs (tests/test_train.py:252)."""
    cfg = _cfg(algorithm="GATSAMPLEALLGPU", epochs=8)
    tr = build_trainer(cfg, cora, device="cpu")
    assert isinstance(tr, DeviceSampleTrainer)
    assert tr.family == "gat" and tr.weight_kind == WeightKind.NONE
    assert tr.optimizer.bias_correction
    report = run_engine(cfg, cora, device="cpu")
    assert max(report.train_acc) >= 0.80, report.train_acc
    assert np.isfinite(report.losses).all()
    assert report.losses[-1] < report.losses[0]
