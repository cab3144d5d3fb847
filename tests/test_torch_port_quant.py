"""Port parity, int8 feature residency (FEATURE_DTYPE:int8).

sgnn_tpu_torch's `quantize_columns`, int8 `InferenceServer`,
`full_forward(x_scale=...)`, int8 sampled trainers and int8
`FullBatchTrainer` against sgnn_tpu's on the same numpy inputs (`tiny_ds`,
Cora), the port on the CPU (its plain PyTorch versions).  Weights are made
by the JAX package and carried across with `params_from_numpy`; the host
sampler's numpy draws are the same on both sides.

Tolerances: int8 against the JAX package's int8 path is the f32 rule
(rtol 1e-5, atol 1e-5): both fold the same scales into W0 (or dequantize
the same gathered rows) in f32, only summation orders differ.  int8
against the port over the dequantized matrix is tests/test_quant.py's
rtol 2e-4 / atol 2e-5: folding the scales into W0 rounds other products
than scaling the rows does.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.config import RunConfig as JRunConfig
from sgnn_tpu.data.quant import quantize_columns as j_quantize
from sgnn_tpu.graph.adjacency import Adjacency as JAdjacency
from sgnn_tpu.models.gnn import init_model as j_init_model
from sgnn_tpu.sampler.blocks import WeightKind as JWeightKind
from sgnn_tpu.train.device_trainer import (
    DeviceSampleTrainer as JDeviceSampleTrainer,
)
from sgnn_tpu.train.fullbatch import FullBatchTrainer as JFullBatchTrainer
from sgnn_tpu.train.fullbatch import build_coo as j_build_coo
from sgnn_tpu.train.fullbatch import full_forward as j_full_forward
from sgnn_tpu.train.inference import InferenceServer as JServer
from sgnn_tpu.train.trainer import SampleTrainer as JSampleTrainer

from sgnn_tpu_torch.config import RunConfig
from sgnn_tpu_torch.data.quant import dequantize, quantize_columns
from sgnn_tpu_torch.graph.adjacency import Adjacency
from sgnn_tpu_torch.models.gnn import params_from_numpy
from sgnn_tpu_torch.ops.segment import csr_from_numpy
from sgnn_tpu_torch.sampler.blocks import WeightKind
from sgnn_tpu_torch.train import build_trainer
from sgnn_tpu_torch.train.device_trainer import DeviceSampleTrainer
from sgnn_tpu_torch.train.fullbatch import (
    FullBatchTrainer, build_coo, full_forward,
)
from sgnn_tpu_torch.train.inference import InferenceServer
from sgnn_tpu_torch.train.trainer import SampleTrainer, loss_and_grads

F32 = dict(rtol=1e-5, atol=1e-5)
DEQUANT = dict(rtol=2e-4, atol=2e-5)     # tests/test_quant.py:200

# tests/test_quant.py:185-191: transform-first, agg-first (in < out), GAT
# with 1 and 4 heads, the min/max aggregator
CASES = {
    "gcn-transform-first": ("gcn", [32, 16, 5], 1, "sum"),
    "gcn-agg-first": ("gcn", [32, 64, 5], 1, "sum"),
    "gat": ("gat", [32, 16, 5], 1, "sum"),
    "gat-h4": ("gat", [32, 16, 5], 4, "sum"),
    "sage-max": ("sage", [32, 16, 5], 1, "max"),
}


def _params(family, sizes, seed=3):
    """JAX parameters (GAT attention drawn nonzero, scores within ±60)
    and the port's copy."""
    jp = j_init_model(jax.random.PRNGKey(seed), family, sizes)
    if family == "gat":
        rng = np.random.default_rng(seed)
        jp = jp._replace(attn=tuple(
            jnp.asarray(rng.standard_normal(a.shape) * 0.5, jnp.float32)
            for a in jp.attn))
    return jp, params_from_numpy([np.asarray(w) for w in jp.weights],
                                 [np.asarray(a) for a in jp.attn],
                                 device="cpu")


@pytest.mark.parametrize("kind", ["tiny", "normal", "zero-column",
                                  "binary"])
def test_quantize_columns_bit_identical(tiny_ds, kind):
    rng = np.random.default_rng(0)
    x = {"tiny": tiny_ds.features,
         "normal": rng.standard_normal((300, 17)).astype(np.float32) * 9,
         "zero-column": np.concatenate(
             [np.zeros((40, 1), np.float32),
              rng.standard_normal((40, 5)).astype(np.float32)], axis=1),
         "binary": (rng.random((64, 16)) > 0.7).astype(np.float32)}[kind]
    q, scale = quantize_columns(x)
    jq, jscale = j_quantize(x)
    assert q.dtype == np.int8 and scale.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    assert scale.tobytes() == jscale.tobytes()
    err = np.abs(dequantize(q, scale) - x)
    assert np.all(err <= scale[None, :] * 0.5 + 1e-7)
    if kind == "binary":
        np.testing.assert_array_equal(dequantize(q, scale), x)


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_server_matches_jax(tiny_ds, case):
    family, sizes, heads, agg = CASES[case]
    jp, tp = _params(family, sizes)
    ja = JAdjacency.from_edges(tiny_ds.edges, tiny_ds.num_vertices)
    ta = Adjacency.from_edges(tiny_ds.edges, tiny_ds.num_vertices)
    f = tiny_ds.features
    js = JServer(jp, family, ja, f, heads=heads, aggregator=agg,
                 dtype="int8")
    ts = InferenceServer(tp, family, ta, f, heads=heads, aggregator=agg,
                         dtype="int8", device="cpu")
    assert ts.dtype == torch.int8 and ts.feature_bytes == f.size
    got = ts.logprobs()
    np.testing.assert_allclose(got, js.logprobs(), **F32)
    q, scale = quantize_columns(f)
    deq = InferenceServer(tp, family, ta, dequantize(q, scale), heads=heads,
                          aggregator=agg, device="cpu").logprobs()
    np.testing.assert_allclose(got, deq, **DEQUANT)
    f32 = InferenceServer(tp, family, ta, f, heads=heads, aggregator=agg,
                          device="cpu").logprobs()
    assert np.mean(got.argmax(1) == f32.argmax(1)) > 0.97   # test_quant:241
    nids = np.array([0, 3, 17, 255, 499, 3])
    np.testing.assert_allclose(ts.query(nids), js.query(nids), **F32)
    np.testing.assert_allclose(ts.query(nids), got[nids], **F32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_full_forward_int8_matches_jax(tiny_ds, case):
    family, sizes, heads, agg = CASES[case]
    jp, tp = _params(family, sizes, seed=4)
    v = tiny_ds.num_vertices
    q, scale = quantize_columns(tiny_ds.features)
    wk = WeightKind.NONE if family == "gat" else WeightKind.GCN
    jadj = JAdjacency.from_edges(tiny_ds.edges, v)
    src, dst, w = j_build_coo(jadj, JWeightKind[wk.name])
    ref = j_full_forward(jp, family, jnp.asarray(q), jnp.asarray(src),
                         jnp.asarray(dst), jnp.asarray(w), v,
                         aggregator=agg, heads=heads,
                         x_scale=jnp.asarray(scale))
    adj = Adjacency.from_edges(tiny_ds.edges, v)
    tsrc, _, tw = build_coo(adj, wk)
    csr = csr_from_numpy(adj.indptr, tsrc, tw, v, "cpu")
    got = full_forward(tp, family, torch.from_numpy(q), csr, aggregator=agg,
                       heads=heads, x_scale=torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)
    deq = full_forward(tp, family, torch.from_numpy(dequantize(q, scale)),
                       csr, aggregator=agg, heads=heads)
    np.testing.assert_allclose(got.numpy(), deq.numpy(), **DEQUANT)
    with pytest.raises(ValueError, match="x_scale"):
        full_forward(tp, family, torch.from_numpy(q), csr, heads=heads)


def test_int8_rows_convert_in_blocks(tiny_ds, monkeypatch):
    """Past INT8_BLOCK_ROWS rows the layer-0 product converts the int8
    levels block by block; the result is the one-block result."""
    from sgnn_tpu_torch.train import fullbatch

    jp, tp = _params("gcn", [32, 16, 5])
    adj = Adjacency.from_edges(tiny_ds.edges, tiny_ds.num_vertices)
    srv = InferenceServer(tp, "gcn", adj, tiny_ds.features, dtype="int8",
                          device="cpu")
    whole = srv.logprobs()
    monkeypatch.setattr(fullbatch, "INT8_BLOCK_ROWS", 64)
    np.testing.assert_allclose(srv.logprobs(), whole, **F32)


def test_int8_block_product_gradient(tiny_ds, monkeypatch):
    """The block-wise int8 product's backward (w's gradient, the blocks
    converted again) against autograd over the converted matrix, with a
    ragged last block."""
    from sgnn_tpu_torch.train import fullbatch

    monkeypatch.setattr(fullbatch, "INT8_BLOCK_ROWS", 64)
    q, scale = quantize_columns(tiny_ds.features)
    assert q.shape[0] % 64
    x = torch.from_numpy(q)
    w0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (q.shape[1], 16)).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (q.shape[0], 16)).astype(np.float32))
    res = []
    for product in (fullbatch._RowsMatmul.apply,
                    lambda a, b: torch.matmul(a.float(), b)):
        w = (w0 * torch.from_numpy(scale)[:, None]).requires_grad_()
        out = product(x, w)
        out.backward(g)
        res.append((out.detach().numpy(), w.grad.numpy()))
    (out, gw), (ref_out, ref_gw) = res
    np.testing.assert_allclose(out, ref_out, **F32)
    # the gradient sums over the vertices in another order (block sums,
    # then across blocks): the relative max-abs rule of the gradients
    assert np.abs(gw - ref_gw).max() <= 1e-5 * np.abs(ref_gw).max()


def _sample_cfg(ds, **kw):
    return dict(dict(layer_sizes=[32, 16, 5], fanout=[4, 3], batch_size=64,
                     epochs=2, drop_rate=0.0, vertices=ds.num_vertices,
                     feature_dtype="int8"), **kw)


def test_int8_host_sampled_first_batch_matches_jax(tiny_ds):
    """GCNSAMPLEGPU with int8 features on the device: the same numpy draws
    give the same blocks, the same int8 rows dequantized the same way, and
    the first batch's loss agrees at the f32 rule.  Host mode (features
    off the device) ships the int8 rows and dequantizes them after the
    upload: the same batch, the same loss."""
    kw = _sample_cfg(tiny_ds)
    jt = JSampleTrainer(JRunConfig(**kw), tiny_ds, family="gcn")
    tt = SampleTrainer(RunConfig(**kw), tiny_ds, family="gcn", device="cpu")
    th = SampleTrainer(RunConfig(**kw), tiny_ds, family="gcn",
                       features_on_device=False, device="cpu")
    assert tt.feature_int8 and tt.dev_features.dtype == torch.int8
    assert th._host_q.dtype == np.int8 and th.dev_features is None
    tt.params = th.params = params_from_numpy(
        [np.asarray(w) for w in jt.params.weights], device="cpu")
    order = jt._epoch_order(jt.train_nids)
    np.testing.assert_array_equal(tt._epoch_order(tt.train_nids), order)
    np.testing.assert_array_equal(th._epoch_order(th.train_nids), order)
    seeds = order[:64]
    jbatch, jedges = jt._make_batch(seeds)
    _, _, jloss, _ = jt._step_fn(jt.params, jt.opt_state, jbatch,
                                 jax.random.PRNGKey(0), jt.dev_features,
                                 jt.dev_labels)
    losses = []
    for tr in (tt, th):
        item = tr._make_batch(seeds)
        if tr is th:
            assert item.x0.dtype == np.int8   # 1 byte an element shipped
        batch, edges = tr._upload(item)
        assert edges == jedges and batch.x0.dtype == torch.float32
        losses.append(loss_and_grads(tr.params, "gcn", batch).loss.item())
    np.testing.assert_allclose(losses[0], float(jloss), rtol=1e-5)
    assert losses[1] == losses[0]


def test_int8_device_trainer_matches_jax_and_learns(tiny_ds):
    """GSSAMPLEALLGPU with int8 storage: the identity bottom hop is off
    (as in the JAX package), gathered rows are dequantized, the loss
    falls; the JAX device trainer makes the same residency choice."""
    kw = _sample_cfg(tiny_ds, epochs=3, fanout=[25, 10], batch_size=256)
    jt = JDeviceSampleTrainer(JRunConfig(**kw), tiny_ds, family="sage")
    tt = DeviceSampleTrainer(RunConfig(**kw), tiny_ds, family="sage",
                             device="cpu")
    assert jt.dev_features.dtype == np.int8
    assert tt.dev_features.dtype == torch.int8
    assert tt.src_pads[-1] == tt.dev_features.shape[0]   # identity-sized
    seeds = torch.zeros(tt.seed_pad, dtype=torch.int32)
    seeds[:64] = torch.from_numpy(tt.train_nids[:64].astype(np.int32))
    batch = tt.sample(seeds, torch.arange(tt.seed_pad) < 64)
    assert not torch.equal(batch.blocks[0].srcs,
                           torch.arange(batch.blocks[0].srcs.numel(),
                                        dtype=torch.int32))
    b0 = batch.blocks[0]
    want = torch.from_numpy(dequantize(*quantize_columns(
        tiny_ds.features)))[b0.srcs.long()] * b0.src_valid[:, None]
    torch.testing.assert_close(batch.x0, want, rtol=0, atol=0)
    losses = [tt.train_epoch()[0] for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_device_trainer_switches_to_int8_under_a_small_budget(tiny_ds,
                                                               caplog):
    """Features that miss the budget at f32 but fit at int8 switch to int8
    with a warning (sgnn_tpu/train/device_trainer.py:72-104), as the JAX
    trainer does under the same budget; features that miss even at int8
    raise FeaturesExceedHbm and the engine falls back to host sampling."""
    from sgnn_tpu_torch.train.device_trainer import FeaturesExceedHbm

    v, f = tiny_ds.features.shape
    budget = v * f * 2          # f32 misses, int8 fits
    kw = _sample_cfg(tiny_ds, feature_dtype="")
    jt = JDeviceSampleTrainer(JRunConfig(**kw), tiny_ds, family="sage",
                              hbm_budget_bytes=budget)
    log = logging.getLogger("sgnn.dev")
    log.addHandler(caplog.handler)
    try:
        tt = DeviceSampleTrainer(RunConfig(**kw), tiny_ds, family="sage",
                                 hbm_budget_bytes=budget, device="cpu")
    finally:
        log.removeHandler(caplog.handler)
    assert any("auto-switching FEATURE_DTYPE to int8" in r.getMessage()
               for r in caplog.records)
    assert jt.feature_int8 and tt.feature_int8
    assert tt.dev_features.dtype == torch.int8
    assert np.isfinite(tt.train_epoch()[0])
    with pytest.raises(FeaturesExceedHbm, match="even at int8"):
        DeviceSampleTrainer(RunConfig(**kw), tiny_ds, family="sage",
                            hbm_budget_bytes=v * f // 2, device="cpu")
    tr = build_trainer(RunConfig(algorithm="GSSAMPLEALLGPU",
                                 hbm_budget=v * f // 2, **kw), tiny_ds,
                       device="cpu")
    assert type(tr) is SampleTrainer and not tr.features_on_device


@pytest.mark.parametrize("ds_name", ["tiny", "cora"])
def test_int8_fullbatch_losses_match_jax(tiny_ds, cora, ds_name):
    """GCNFULLBATCH with FEATURE_DTYPE:int8, 5 epochs at drop 0 from the
    same parameters: the losses agree within 1e-4 relative."""
    ds = tiny_ds if ds_name == "tiny" else cora
    sizes = [32, 16, 5] if ds_name == "tiny" else [1433, 16, 7]
    kw = dict(layer_sizes=sizes, epochs=5, learn_rate=0.01, drop_rate=0.0,
              vertices=ds.num_vertices, feature_dtype="int8")
    jt = JFullBatchTrainer(JRunConfig(**kw), ds, family="gcn")
    tt = FullBatchTrainer(RunConfig(**kw), ds, family="gcn", device="cpu")
    assert tt.x.dtype == torch.int8 and tt.x_scale.dtype == torch.float32
    tt.params = params_from_numpy([np.asarray(w) for w in jt.params.weights],
                                  device="cpu")
    jl = [jt.train_epoch()[0] for _ in range(5)]
    tl = [tt.train_epoch()[0] for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    f32 = FullBatchTrainer(RunConfig(**dict(kw, feature_dtype="")), ds,
                           family="gcn", device="cpu")
    f32.params = tt.params
    assert np.mean(tt.predict().argmax(1) == f32.predict().argmax(1)) > 0.97


def test_bad_feature_dtype_rejected(tiny_ds):
    with pytest.raises(ValueError, match="FEATURE_DTYPE"):
        SampleTrainer(RunConfig(**_sample_cfg(tiny_ds, feature_dtype="fp4")),
                      tiny_ds, device="cpu")
    # int8 rows in the partial feature cache waited for item 5: they stage
    # as int8 now (half the 500 vertices, within the CPU's 1 GiB)
    cfg = dataclasses.replace(RunConfig(**_sample_cfg(tiny_ds)),
                              feature_cache_rate=0.5)
    tr = SampleTrainer(cfg, tiny_ds, features_on_device=False, device="cpu")
    assert tr.feat_cache.dev_hot.dtype == torch.int8
    assert tr.feat_cache.hot_ids.size == tiny_ds.num_vertices // 2
