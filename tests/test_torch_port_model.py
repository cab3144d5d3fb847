"""Port parity, model and optimizer: sgnn_tpu_torch's `model_forward` (GCN
and SAGE, batch norm off and on, both transform orders) against sgnn_tpu's
on the same host-sampled batch — log-probs, the masked NLL and every
weight's gradient under `jax.value_and_grad` — with the JAX package's
parameters carried across by `params_from_numpy`; then the reference Adam
(with and without bias correction, with lr decay) and SGD over five
updates from identical gradients.  The port runs on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.graph.adjacency import Adjacency as JAdjacency
from sgnn_tpu.models.gnn import init_model as j_init_model
from sgnn_tpu.models.gnn import model_forward as j_model_forward
from sgnn_tpu.nn.functional import masked_accuracy as j_masked_accuracy
from sgnn_tpu.nn.functional import nll_loss_masked as j_nll
from sgnn_tpu.nn.optim import ReferenceAdam as JAdam, ReferenceSGD as JSGD
from sgnn_tpu.sampler.blocks import WeightKind as JWeightKind
from sgnn_tpu.sampler.host import HostSampler as JHostSampler
from sgnn_tpu.train.trainer import host_batch_to_device as j_to_device

from sgnn_tpu_torch.models.gnn import model_forward, params_from_numpy
from sgnn_tpu_torch.nn.functional import (
    dropout, masked_accuracy, nll_loss_masked,
)
from sgnn_tpu_torch.nn.optim import ReferenceAdam, ReferenceSGD
from sgnn_tpu_torch.train.trainer import host_batch_to_device, loss_and_grads

# f32 on both sides, identical blocks and weights: only summation orders
# differ (XLA's and torch's CPU kernels); the repo's f32 op tolerance
LOGP = dict(rtol=1e-5, atol=1e-5)
GRAD_MAX_REL = 1e-4   # max |Δg| / max |g| per weight


@pytest.fixture(scope="module")
def batch_pair(tiny_ds):
    adj = JAdjacency.from_edges(tiny_ds.edges, tiny_ds.num_vertices)
    sampler = JHostSampler(adj, fanouts=[6, 4], batch_size=96,
                           weight_kind=JWeightKind.MEAN, seed=5,
                           use_native=False)
    hb = sampler.sample(np.arange(0, 400, 4, dtype=np.int32))
    payload = hb.payload(tiny_ds.features, tiny_ds.labels)
    return j_to_device(hb, *payload), host_batch_to_device(hb, *payload,
                                                           device="cpu")


# layer sizes: [32, 16, 5] transforms first in both layers (in > out);
# [32, 48, 5] aggregates first in layer 0
@pytest.mark.parametrize("sizes", [[32, 16, 5], [32, 48, 5]])
@pytest.mark.parametrize("batch_norm", [False, True])
@pytest.mark.parametrize("family", ["gcn", "sage"])
def test_forward_and_grads_match_jax(batch_pair, family, batch_norm, sizes):
    jbatch, tbatch = batch_pair
    jp = j_init_model(jax.random.PRNGKey(9), family, sizes)
    tp = params_from_numpy([np.asarray(w) for w in jp.weights], device="cpu")

    def j_loss(p):
        logp = j_model_forward(p, family, jbatch, batch_norm=batch_norm)
        return j_nll(logp, jbatch.labels, jbatch.label_valid), logp

    (jl, jlogp), jg = jax.value_and_grad(j_loss, has_aux=True)(jp)
    out = loss_and_grads(tp, family, tbatch, batch_norm=batch_norm)
    np.testing.assert_allclose(out.logp.numpy(), np.asarray(jlogp), **LOGP)
    np.testing.assert_allclose(out.loss.item(), float(jl), rtol=1e-5)
    for g, ref in zip(out.grads, jg.weights, strict=True):
        ref = np.asarray(ref)
        assert np.abs(g.numpy() - ref).max() <= GRAD_MAX_REL * np.abs(
            ref).max()
    np.testing.assert_array_equal(
        masked_accuracy(out.logp, tbatch.labels, tbatch.label_valid).numpy(),
        np.asarray(j_masked_accuracy(jlogp, jbatch.labels,
                                     jbatch.label_valid)))


def test_remat_changes_nothing(batch_pair):
    tp = params_from_numpy([np.asarray(w) for w in j_init_model(
        jax.random.PRNGKey(2), "sage", [32, 16, 5]).weights], device="cpu")
    a = loss_and_grads(tp, "sage", batch_pair[1], batch_norm=True)
    b = loss_and_grads(tp, "sage", batch_pair[1], batch_norm=True,
                       remat=True)
    assert torch.equal(a.logp, b.logp)
    for x, y in zip(a.grads, b.grads):
        assert torch.equal(x, y)


def test_gat_and_cache_wait_for_their_slices(batch_pair):
    # GAT is ported (tests/test_torch_port_gat.py); the cache still waits
    tp = params_from_numpy([np.ones((32, 16), np.float32),
                            np.ones((16, 5), np.float32)], device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        model_forward(tp, "gcn", batch_pair[1], cache_emb=torch.zeros(1, 16))


def test_nll_masked_matches_jax():
    rng = np.random.default_rng(0)
    logp = np.log(rng.dirichlet(np.ones(7), 50)).astype(np.float32)
    labels = rng.integers(0, 7, 50).astype(np.int32)
    valid = rng.random(50) < 0.7
    got = nll_loss_masked(torch.from_numpy(logp), torch.from_numpy(labels),
                          torch.from_numpy(valid)).item()
    ref = float(j_nll(jnp.asarray(logp), jnp.asarray(labels),
                      jnp.asarray(valid)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_dropout_is_inverted_and_seeded():
    x = torch.ones(200, 100)
    a = dropout(torch.Generator().manual_seed(3), x, 0.5, True)
    b = dropout(torch.Generator().manual_seed(3), x, 0.5, True)
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}   # kept values × 1/(1-p)
    assert abs((a != 0).float().mean().item() - 0.5) < 0.02
    assert dropout(None, x, 0.5, False) is x


OPTIMIZERS = [
    ("adam", dict(learn_rate=0.01, weight_decay=1e-4)),
    ("adam", dict(learn_rate=0.01, weight_decay=1e-4, bias_correction=True)),
    ("adam", dict(learn_rate=0.01, weight_decay=1e-4, decay_rate=0.5,
                  decay_epoch=2)),
    ("sgd", dict(learn_rate=0.05, weight_decay=1e-3)),
]


@pytest.mark.parametrize("kind,kw", OPTIMIZERS,
                         ids=["adam", "adam-bias", "adam-decay", "sgd"])
def test_optimizer_five_updates_match_jax(kind, kw):
    rng = np.random.default_rng(1)
    shapes = [(6, 4), (4, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jopt = (JAdam if kind == "adam" else JSGD)(**kw)
    topt = (ReferenceAdam if kind == "adam" else ReferenceSGD)(**kw)
    jp = tuple(jnp.asarray(p) for p in params)
    tp = [torch.from_numpy(p.copy()) for p in params]
    jst, tst = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        jp, jst = jopt.update(tuple(jnp.asarray(g) for g in grads), jst, jp)
        tp, tst = topt.update([torch.from_numpy(g) for g in grads], tst, tp)
    for a, b in zip(tp, jp):
        # the same f32 rule; only the rounding of the f32 scalar constants
        # differs (torch multiplies by Python floats)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert tst.step == int(jst.step) == 5
