"""Port parity, whole-graph training: sgnn_tpu_torch against sgnn_tpu on
the CPU.

* K2's backward: `SpmmCsr`'s gradient (the SpMM over `csr_transpose`'s
  CSR) against `jax.grad` through the Pallas `mxu_spmm` in interpret mode
  and through the JAX windowed path.
* K4: `GatAggregate`'s backward (B1 and B2's plain versions) against torch
  autograd through `gat_aggregate_plain`, against `jax.grad` of the
  reference formulation (tests/test_mxu_gat.py:172-183) and against the
  Pallas `mxu_gat_train` in interpret mode.
* min/max (`ops/reductions.segment_extreme`) against `segment_min_coo` /
  `segment_max_coo`, ties and rows with no edges included.
* `full_forward`'s loss and gradients and `FullBatchTrainer`'s trajectories
  against the JAX `FullBatchTrainer` on the same parameters, the engines,
  Cora accuracy, bf16, and min/max serving.

Inputs are made with numpy from a seed; weights cross by
`params_from_numpy(weights, attn)`.
"""

import dataclasses
import importlib.util
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.config import RunConfig as JRunConfig
from sgnn_tpu.graph.adjacency import Adjacency as JAdjacency
from sgnn_tpu.models.gnn import init_model as j_init_model
from sgnn_tpu.nn.functional import nll_loss_masked as j_nll
from sgnn_tpu.ops.pallas.mxu_gat import build_mxu_gat_plan, mxu_gat_train
from sgnn_tpu.ops.pallas.mxu_spmm import build_mxu_spmm_pair
from sgnn_tpu.ops.reductions import segment_max_coo, segment_min_coo
from sgnn_tpu.ops.segment import SpmmPlanner, spmm_coo_csc
from sgnn_tpu.sampler.blocks import WeightKind as JWeightKind
from sgnn_tpu.train.fullbatch import FullBatchTrainer as JFullBatchTrainer
from sgnn_tpu.train.fullbatch import csr_order
from sgnn_tpu.train.fullbatch import full_forward as j_full_forward
from sgnn_tpu.train.inference import InferenceServer as JServer

from sgnn_tpu_torch.config import RunConfig, load_cfg
from sgnn_tpu_torch.graph.adjacency import Adjacency
from sgnn_tpu_torch.models.gnn import params_from_numpy
from sgnn_tpu_torch.nn.functional import nll_loss_masked
from sgnn_tpu_torch.ops.gat import (
    ATT_CLIP, GatAggregate, gat_aggregate_plain, gat_bwd_dst, gat_bwd_src,
    pack_score_tables,
)
from sgnn_tpu_torch.ops.reductions import segment_extreme
from sgnn_tpu_torch.parallel.mesh import make_group
from sgnn_tpu_torch.ops.segment import (
    PLAIN_F64_ROW_EDGES, SpmmCsr, csr_from_numpy, csr_transpose,
    spmm_csr_plain,
)
from sgnn_tpu_torch.sampler.blocks import WeightKind
from sgnn_tpu_torch.train import build_trainer, run_engine
from sgnn_tpu_torch.train.engines import FullBatchEngine
from sgnn_tpu_torch.train.fullbatch import FullBatchTrainer, full_forward
from sgnn_tpu_torch.train.inference import InferenceServer

CFG = os.path.join(os.path.dirname(__file__), "..", "configs",
                   "gcn_cora_sample.cfg")
# f32 on both sides, only the summation order differs: the repo's f32 op
# tolerance (tests/test_ops.py:47), as max |Δ| / max |ref|
RTOL = 1e-5
# whole-graph gradients through two layers, Adam-free: max |Δg| / max |g|
GRAD_MAX_REL = 1e-4
# K4's attention-vector gradients against JAX's autodiff, max |Δ| / max
# |ref|: da = Σ_v dts[v]·ht[v] sums q_e = u·lrelu'·(t_e − rz), whose two
# terms are each O(|G|·|h|) and cancel to a small difference, so f32
# rounding of t_e and rz (~1e-7 of them) grows by their ratio to q; measured
# 1.93e-5 at heads 4 here, 1e-4 the bound
K4_ATTN_RTOL = 1e-4
# the Pallas kernels' bf16 contract: K2 (tests/test_mxu_spmm.py:57-72) and
# K4 (tests/test_mxu_gat.py:188-197, with its cosine floor)
K2_BF16 = 5e-3
K4_BF16, K4_COS = 5e-2, 0.999
# the Pallas kernels' tiny geometry (tests/test_mxu_spmm.py:23)
KW = dict(s_blk=256, d_blk=512, w_win=128, e_sub=64, e_t=256,
          max_pad_ratio=50.0, chunk_steps=7)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _graph(rng, v, e, empty=()):
    """dst-sorted random edges (some destinations with no in-edges) as
    (src, dst, rowptr)."""
    dst = rng.integers(0, v, e).astype(np.int32)
    dst = np.sort(dst[~np.isin(dst, empty)], kind="stable")
    src = rng.integers(0, v, dst.size).astype(np.int32)
    rowptr = np.zeros(v + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=v), out=rowptr[1:])
    return src, dst, rowptr


# ------------------------------------------------------------ K2 bwd -----
def _spmm_grad(src, dst, rowptr, w, x, c, v):
    """The port's dx of sum(spmm(x) * c) through SpmmCsr."""
    csr = csr_from_numpy(rowptr, src, w, v, device="cpu")
    csr_t = csr_from_numpy(*csr_transpose(rowptr, src, w, v), v,
                           device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    (SpmmCsr.apply(xt, *csr, *csr_t) * torch.from_numpy(c)).sum().backward()
    return xt.grad.numpy()


def test_spmm_grad_matches_pallas_interpret():
    """The contract of tests/test_mxu_spmm.py:60-72: the kernel pair's
    gradient is the transposed SpMM, within the bf16 kernel's bound."""
    rng = np.random.default_rng(5)
    v = 900
    src, dst, rowptr = _graph(rng, v, 4000)
    w = rng.standard_normal(src.size).astype(np.float32)
    x = rng.standard_normal((v, 32)).astype(np.float32)
    c = rng.standard_normal((v, 32)).astype(np.float32)
    pair = build_mxu_spmm_pair(src, dst, w, v, v, **KW)
    assert pair is not None
    ref = jax.grad(lambda t: jnp.sum(pair(t) * c))(jnp.asarray(x))
    assert _rel(_spmm_grad(src, dst, rowptr, w, x, c, v), ref) < K2_BF16


def test_spmm_grad_matches_jax_windowed():
    """f32 against the JAX package's whole-graph path (spmm_coo_csc with
    its window plan, the CPU/GPU route of FullBatchTrainer)."""
    rng = np.random.default_rng(6)
    v = 700
    src, dst, rowptr = _graph(rng, v, 6000, empty=(3, 4))
    w = rng.standard_normal(src.size).astype(np.float32)
    x = rng.standard_normal((v, 24)).astype(np.float32)
    c = rng.standard_normal((v, 24)).astype(np.float32)
    perm, inv = csr_order(src)
    planner = SpmmPlanner(dst, src[perm], num_src=v, num_dst=v,
                          e_real=src.size)
    srcj, dstj, wj = jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)

    def j_loss(t):
        out = spmm_coo_csc(t, srcj, dstj, wj, jnp.asarray(perm),
                           jnp.asarray(inv), v, planner.plan(24))
        return jnp.sum(out * c)

    ref = np.asarray(jax.grad(j_loss)(jnp.asarray(x)))
    got = _spmm_grad(src, dst, rowptr, w, x, c, v)
    assert _rel(got, ref) <= RTOL


def test_csr_transpose_round_trips():
    rng = np.random.default_rng(7)
    v_dst, v_src = 300, 410          # rows != sources
    dst = np.sort(rng.integers(0, v_dst, 3000)).astype(np.int32)
    src = rng.integers(0, v_src, dst.size).astype(np.int32)
    order = np.lexsort((src, dst))   # ascending sources within each row
    src, dst = src[order], dst[order]
    w = rng.standard_normal(src.size).astype(np.float32)
    rowptr = np.zeros(v_dst + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=v_dst), out=rowptr[1:])
    rowptr_t, col_t, w_t = csr_transpose(rowptr, src, w, v_src)
    assert rowptr_t.shape == (v_src + 1,) and col_t.dtype == np.int32
    rows_t = np.repeat(np.arange(v_src), np.diff(rowptr_t))
    # each source's edges keep ascending destination order (stable sort)
    assert (np.diff(col_t)[np.diff(rows_t) == 0] >= 0).all()
    back = csr_transpose(rowptr_t, col_t, w_t, v_dst)
    for a, b in zip(back, (rowptr, src, w)):
        np.testing.assert_array_equal(a, b)
    # the transposed SpMM is Aᵀ·g
    g = rng.standard_normal((v_dst, 5)).astype(np.float32)
    dense = np.zeros((v_dst, v_src), np.float64)
    np.add.at(dense, (dst, src), w)
    out = spmm_csr_plain(torch.from_numpy(g), torch.from_numpy(rowptr_t),
                         torch.from_numpy(col_t), torch.from_numpy(w_t))
    np.testing.assert_allclose(out.numpy(), dense.T @ g, rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------- K4 -----
def _k4_case(heads, clip, seed=11, v=600, e=5000, f=None):
    """A whole-graph GAT layer's inputs: ht [V, F], attention halves, and
    the CSR / transposed CSR; `clip` sets every 37th row of ht along
    a_src so that its source score half is 80 in every head, past the
    +60 clip."""
    rng = np.random.default_rng(seed + heads)
    f = f or 16 * heads
    src, dst, rowptr = _graph(rng, v, e, empty=(2, 9))
    ht = (rng.standard_normal((v, f)) * 0.5).astype(np.float32)
    a_src = (rng.standard_normal(f) * 0.3).astype(np.float32)
    a_dst = (rng.standard_normal(f) * 0.3).astype(np.float32)
    if clip:
        a3 = a_src.reshape(heads, -1)
        ht[::37] = (80.0 * a3 / (a3 ** 2).sum(1, keepdims=True)).reshape(f)
    cot = rng.standard_normal((v, f)).astype(np.float32)
    w = np.ones(src.size, np.float32)
    rowptr_t, col_t, _ = csr_transpose(rowptr, src, w, v)
    return dict(src=src, dst=dst, rowptr=rowptr, rowptr_t=rowptr_t,
                col_t=col_t, ht=ht, a_src=a_src, a_dst=a_dst, cot=cot, v=v)


def _port_k4_grads(c, heads):
    """(dht, da_src, da_dst) of sum(h * cot) through GatAggregate, or of
    sum(h * cos(h)) where the case has no cotangent."""
    ht, a_s, a_d = (torch.from_numpy(c[k]).requires_grad_()
                    for k in ("ht", "a_src", "a_dst"))
    ts, td = pack_score_tables(ht, a_s, a_d, heads)
    h = GatAggregate.apply(ht, ts, td, torch.from_numpy(c["rowptr"]),
                           torch.from_numpy(c["src"]),
                           torch.from_numpy(c["rowptr_t"]),
                           torch.from_numpy(c["col_t"]), heads)
    cot = torch.cos(h) if c["cot"] is None else torch.from_numpy(c["cot"])
    (h * cot).sum().backward()
    return ht.grad.numpy(), a_s.grad.numpy(), a_d.grad.numpy()


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_k4_plain_matches_torch_autograd(heads):
    """B1 and B2 against torch autograd through K3's plain version, on the
    score tables themselves, with clipped scores."""
    c = _k4_case(heads, clip=True)
    ht = torch.from_numpy(c["ht"])
    ts0, td0 = pack_score_tables(ht, torch.from_numpy(c["a_src"]),
                                 torch.from_numpy(c["a_dst"]), heads)
    raw = ts0.numpy()[c["src"]] + td0.numpy()[c["dst"]]
    assert (raw > ATT_CLIP).any() and (np.abs(raw) < ATT_CLIP).mean() > 0.5
    rowptr, col = torch.from_numpy(c["rowptr"]), torch.from_numpy(c["src"])
    cot = torch.from_numpy(c["cot"])
    leaves = [t.clone().requires_grad_() for t in (ht, ts0, td0)]
    h, _ = gat_aggregate_plain(*leaves, rowptr, col, heads)
    (h * cot).sum().backward()
    mine = [t.clone().requires_grad_() for t in (ht, ts0, td0)]
    (GatAggregate.apply(*mine, rowptr, col, torch.from_numpy(c["rowptr_t"]),
                        torch.from_numpy(c["col_t"]), heads)
     * cot).sum().backward()
    for name, a, b in zip(("dht", "dts", "dtd"), mine, leaves):
        assert _rel(a.grad, b.grad) <= RTOL, name
    # rows with no in-edges pass nothing back through their destination half
    assert (mine[2].grad.numpy()[[2, 9]] == 0).all()


@pytest.mark.parametrize("heads", [1, 2, 4])
def test_k4_matches_jax_reference(heads):
    """dht, da_src, da_dst against jax.grad of the reference formulation
    (tests/test_mxu_gat.py:172-183) on the same parameters, clip
    included."""
    c = _k4_case(heads, clip=True, seed=3)
    v, f = c["v"], c["ht"].shape[1]
    fh = f // heads
    srcj, dstj = jnp.asarray(c["src"]), jnp.asarray(c["dst"])

    def loss_ref(ht, a_s, a_d):
        h3 = ht.reshape(v, heads, fh)
        ts = jnp.einsum("vhf,hf->vh", h3, a_s.reshape(heads, fh))
        td = jnp.einsum("vhf,hf->vh", h3, a_d.reshape(heads, fh))
        sc = jax.nn.leaky_relu(ts[srcj] + td[dstj], 0.2)
        u = jnp.exp(jnp.clip(sc, -60.0, 60.0))
        z = jax.ops.segment_sum(u, dstj, num_segments=v)
        agg = jax.ops.segment_sum(h3[srcj] * u[:, :, None], dstj,
                                  num_segments=v)
        h = (agg / jnp.maximum(z, 1e-30)[:, :, None]).reshape(v, f)
        return jnp.sum(h * c["cot"])

    refs = jax.grad(loss_ref, argnums=(0, 1, 2))(
        jnp.asarray(c["ht"]), jnp.asarray(c["a_src"]),
        jnp.asarray(c["a_dst"]))
    for name, a, b, tol in zip(("dht", "da_src", "da_dst"),
                               _port_k4_grads(c, heads), refs,
                               (RTOL, K4_ATTN_RTOL, K4_ATTN_RTOL)):
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.parametrize("heads,f", [(1, 32), (2, 64)])
def test_k4_matches_pallas_interpret(heads, f):
    """The JAX kernel contract on its own inputs and loss
    (tests/test_mxu_gat.py:145-197: ht·0.5, a·0.2, sum(h·cos h); bf16
    operands, so max rel < 5e-2 and cosine > 0.999): scores inside the
    clip, where the Pallas kernel's missing clip indicator does not
    matter."""
    rng = np.random.default_rng(9)        # that test's draws, in order
    v, e = 700, 3500
    dst = rng.integers(0, v, e).astype(np.int32)
    src = rng.integers(0, v, e).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    rowptr = np.zeros(v + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=v), out=rowptr[1:])
    rowptr_t, col_t, _ = csr_transpose(rowptr, src,
                                       np.ones(src.size, np.float32), v)
    c = dict(src=src, rowptr=rowptr, rowptr_t=rowptr_t, col_t=col_t,
             ht=(rng.standard_normal((v, f)) * 0.5).astype(np.float32),
             a_src=(rng.standard_normal(f) * 0.2).astype(np.float32),
             a_dst=(rng.standard_normal(f) * 0.2).astype(np.float32),
             cot=None)
    fwd = build_mxu_gat_plan(src, dst, v, v, **KW)
    bwd = build_mxu_gat_plan(dst, src, v, v, **KW)
    assert fwd is not None and bwd is not None

    def loss_kernel(ht, a_s, a_d):
        h = mxu_gat_train(ht, a_s, a_d, *fwd.operands, *bwd.operands,
                          fwd.static, bwd.static, heads)
        return jnp.sum(h * jnp.cos(h))

    refs = jax.grad(loss_kernel, argnums=(0, 1, 2))(
        jnp.asarray(c["ht"]), jnp.asarray(c["a_src"]),
        jnp.asarray(c["a_dst"]))
    for name, a, b in zip(("dht", "da_src", "da_dst"),
                          _port_k4_grads(c, heads), refs):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert _rel(a, b) < K4_BF16, name
        cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos > K4_COS, (name, cos)


def _script(name):
    """scripts/<name>.py as a module: torch_b1_identity_error (the hub
    cases and B1's dts in the kernel's summation order) or
    torch_b2_identity_error (B2's operands and dtd in its order)."""
    path = os.path.join(os.path.dirname(__file__), "..", "scripts",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("heads", [1, 2])
def test_b1_dts_matches_jax_reference(heads):
    """B1's dts on a graph whose source 5 has 70,000 out-edges (past
    PLAIN_F64_ROW_EDGES), with clipped scores and Gz, rz from a cotangent.
    The algebra: the one-dot-product identity dts = <Σ c·Gz[d], ht[s]> −
    Σ c·rz[d] over whole pieces, in f64, against jax.grad of the reference
    formulation (as test_k4_matches_jax_reference) w.r.t. the score table
    ts, also in f64 (in f32 the reference's own 70,000-term sums stray
    past the bound on such a hub).  The kernel's arithmetic: its two f32 forms in the
    walk's order (pieces, then the fixed tree), a dot product an edge
    (scalar columns) and the identity over each 4 edges (vector columns),
    against the plain version on the same f32 inputs.  (In f32 the
    identity over whole pieces strays past 1e-5 on such graphs: the
    script's row_rel_err.)"""
    b1 = _script("torch_b1_identity_error")
    case = b1.hub_case(6, heads)
    ht, ts, td, rowptr, src, dst, cot = case
    v, f = ht.shape
    fh = f // heads
    assert (ts[src] + td[dst] > ATT_CLIP).any()

    def loss_ref(ht_, ts_, td_):
        h3 = ht_.reshape(v, heads, fh)
        sc = jax.nn.leaky_relu(ts_[src] + td_[dst], 0.2)
        u = jnp.exp(jnp.clip(sc, -60.0, 60.0))
        z = jax.ops.segment_sum(u, dst, num_segments=v)
        agg = jax.ops.segment_sum(h3[src] * u[:, :, None], dst,
                                  num_segments=v)
        h = (agg / jnp.maximum(z, 1e-30)[:, :, None]).reshape(v, f)
        return jnp.sum(h * cot)

    with jax.enable_x64(True):
        ref = np.asarray(jax.grad(loss_ref, argnums=1)(
            *(jnp.asarray(a, jnp.float64) for a in (ht, ts, td))))
    args64 = b1.b1_operands(*case, heads, dtype=torch.float64)
    assert int(args64[5].diff().max()) > PLAIN_F64_ROW_EDGES
    identity = b1.walk_order_dts(*args64, heads, form="row")
    assert _rel(identity, ref) <= RTOL
    args = b1.b1_operands(*case, heads)
    plain = gat_bwd_src(*args, heads)[1]
    for form in ("edge", "unroll"):
        got = b1.walk_order_dts(*args, heads, form=form)
        assert got.dtype == torch.float32
        assert _rel(got, plain) <= RTOL, form


@pytest.mark.parametrize("heads", [1, 2])
def test_b2_dtd_matches_jax_reference(heads):
    """B2's dtd on the B1 test's graph (source 5 holds 70,000 of the
    90,000 edges, so it dominates each destination's attention and t_e ~
    rz[d] on its edges), with clipped scores and Gz, rz from a cotangent.
    The algebra: the identity dtd = <Gz[d], Σ c·ht[s]> − rz[d]·Σ c over
    whole rows, in f64, against jax.grad of the reference formulation
    w.r.t. the score table td, also in f64.  The kernel's arithmetic: its
    f32 forms in a destination row's edge order, the identity over each 4
    edges (the kernel) and a dot product an edge, against the plain
    version on the same f32 inputs.  (In f32 the identity over whole rows
    strays up to 1.09e-5 on these graphs: the script's row_rel_err.)"""
    b2 = _script("torch_b2_identity_error")
    case = b2.hub_case(6, heads)
    ht, ts, td, rowptr, src, dst, cot = case
    v, f = ht.shape
    fh = f // heads
    assert (ts[src] + td[dst] > ATT_CLIP).any()

    def loss_ref(ht_, ts_, td_):
        h3 = ht_.reshape(v, heads, fh)
        sc = jax.nn.leaky_relu(ts_[src] + td_[dst], 0.2)
        u = jnp.exp(jnp.clip(sc, -60.0, 60.0))
        z = jax.ops.segment_sum(u, dst, num_segments=v)
        agg = jax.ops.segment_sum(h3[src] * u[:, :, None], dst,
                                  num_segments=v)
        h = (agg / jnp.maximum(z, 1e-30)[:, :, None]).reshape(v, f)
        return jnp.sum(h * cot)

    with jax.enable_x64(True):
        ref = np.asarray(jax.grad(loss_ref, argnums=2)(
            *(jnp.asarray(a, jnp.float64) for a in (ht, ts, td))))
    args64 = b2.b2_operands(*case, heads, dtype=torch.float64)
    assert float((args64[6] == 5).double().mean()) > 0.7
    identity = b2.row_order_dtd(*args64, heads, form="row")
    assert _rel(identity, ref) <= RTOL
    args = b2.b2_operands(*case, heads)
    plain = gat_bwd_dst(*args, heads)
    for form in ("unroll", "edge"):
        got = b2.row_order_dtd(*args, heads, form=form)
        assert got.dtype == torch.float32
        assert _rel(got, plain) <= RTOL, form


def test_k4_dispatch_rejects_bad_args():
    c = _k4_case(1, clip=False, v=50, e=200)
    ht = torch.from_numpy(c["ht"])
    ts, td = torch.zeros(50, 1), torch.zeros(50, 1)
    gz, rz = torch.zeros(50, ht.shape[1]), torch.zeros(50, 1)
    rowptr_t, col_t = (torch.from_numpy(c[k]) for k in ("rowptr_t", "col_t"))
    dht, dts = gat_bwd_src(ht, ts, gz, td, rz, rowptr_t, col_t, 1)
    assert dht.shape == ht.shape and dts.shape == (50, 1)
    assert (dht == 0).all()            # Gz = 0: nothing flows back
    for bad in (
            lambda: gat_bwd_src(ht, ts, gz, td, rz, rowptr_t, col_t.long(),
                                1),
            lambda: gat_bwd_src(ht, ts, gz.double(), td, rz, rowptr_t, col_t,
                                1),
            lambda: gat_bwd_dst(ht, ts, gz, td, rz[:10], rowptr_t, col_t, 1),
            lambda: gat_bwd_dst(ht, ts, gz, td, rz, rowptr_t[:20], col_t,
                                1)):
        with pytest.raises(ValueError):
            bad()


# ----------------------------------------------------------- min/max -----
@pytest.mark.parametrize("kind", ["min", "max"])
def test_segment_extreme_matches_jax(kind):
    """Forward and gradient against segment_{min,max}_coo, with ties
    (the cotangent is shared evenly among the tied edges, JAX's
    scatter-extremal rule) and rows with no in-edges (0, no gradient)."""
    rng = np.random.default_rng(2)
    v, f = 200, 6
    src, dst, rowptr = _graph(rng, v, 1500, empty=(0, 7, 199))
    # integer-valued features: many exact ties among a row's messages
    x = rng.integers(-3, 4, (v, f)).astype(np.float32)
    cot = rng.standard_normal((v, f)).astype(np.float32)
    red = segment_min_coo if kind == "min" else segment_max_coo

    def j_loss(t):
        out = red(t, jnp.asarray(src), jnp.asarray(dst),
                  jnp.ones(src.size, bool), v, indices_are_sorted=True)
        return jnp.sum(out * cot), out

    (_, j_out), j_grad = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = segment_extreme(xt, torch.from_numpy(rowptr),
                          torch.from_numpy(src), kind)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(j_out))
    assert (out.detach().numpy()[[0, 7, 199]] == 0).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_grad),
                               rtol=1e-6, atol=1e-6)
    shared = xt.grad.numpy()
    assert ((shared != 0) & (np.abs(shared - np.round(shared, 0)) > 0)).any()


# ---------------------------------------------- whole-graph training -----
_FAMILIES = {
    # id: (family, aggregator, heads, batch_norm)
    "gcn": ("gcn", "sum", 1, False),
    "sage": ("sage", "sum", 1, False),
    "gcn-bn": ("gcn", "sum", 1, True),
    "gat-h1": ("gat", "sum", 1, False),
    "gat-h4-bn": ("gat", "sum", 4, True),
    "min": ("gcn", "min", 1, False),
    "max-bn": ("sage", "max", 1, True),
}


def _trainers(ds, case, **kw):
    """The JAX and the port FullBatchTrainer on one config, the port's
    parameters carried across from the JAX one's (GAT attention drawn
    nonzero, so the scores are exercised)."""
    family, agg, heads, bn = _FAMILIES[case]
    kw = dict(dict(layer_sizes=[32, 16, 5], epochs=3, learn_rate=0.02,
                   drop_rate=0.0, vertices=ds.num_vertices, heads=heads,
                   aggregator=agg, batch_norm=bn), **kw)
    jwk = JWeightKind.MEAN if family == "sage" else JWeightKind.GCN
    jt = JFullBatchTrainer(JRunConfig(**kw), ds, family=family,
                           weight_kind=jwk)
    if family == "gat":
        rng = np.random.default_rng(3)
        jt.params = jt.params._replace(attn=tuple(
            jnp.asarray(rng.standard_normal(a.shape) * 0.5, jnp.float32)
            for a in jt.params.attn))
    tt = FullBatchTrainer(RunConfig(**kw), ds, family=family,
                          weight_kind=WeightKind[jwk.name], device="cpu")
    tt.params = params_from_numpy([np.asarray(w) for w in jt.params.weights],
                                  [np.asarray(a) for a in jt.params.attn],
                                  device="cpu")
    return jt, tt


@pytest.mark.parametrize("case", sorted(_FAMILIES))
def test_full_forward_loss_and_grads_match_jax(tiny_ds, case):
    family, agg, heads, bn = _FAMILIES[case]
    jt, tt = _trainers(tiny_ds, case)
    v = tiny_ds.num_vertices

    def j_loss(p):
        logp = j_full_forward(p, family, jt.x, jt.src, jt.dst, jt.w, v,
                              aggregator=agg, heads=heads, batch_norm=bn,
                              csr=(jt.perm, jt.inv_perm), planner=jt.planner)
        return j_nll(logp, jt.y, jt.train_mask)

    jl, jg = jax.value_and_grad(j_loss)(jt.params)
    leaves = [p.detach().requires_grad_() for p in tt.params.leaves()]
    logp = tt.forward(tt.params.replace_leaves(leaves), train=True)
    loss = nll_loss_masked(logp, tt.y, tt.masks[0])
    loss.backward()
    assert abs(loss.item() - float(jl)) <= RTOL * abs(float(jl))
    refs = [*jg.weights, *jg.attn]
    assert len(leaves) == len(refs) == (4 if family == "gat" else 2)
    for got, ref in zip(leaves, refs):
        assert _rel(got.grad, ref) <= GRAD_MAX_REL


@pytest.mark.parametrize("case", ["gcn", "sage", "gat-h4-bn", "max-bn"])
def test_trainer_trajectory_matches_jax(tiny_ds, case):
    """3 epochs at drop 0 from the same parameters: losses within 1e-3
    relative and accuracies within 0.02, the bounds and reason of
    tests/test_torch_port_gat.py:443-462 (Adam amplifies a sign flip of a
    near-zero gradient element under another summation order)."""
    jt, tt = _trainers(tiny_ds, case)
    for _ in range(3):
        jl, *jaccs = jt.train_epoch()
        tl, *taccs = tt.train_epoch()
        np.testing.assert_allclose(tl, jl, rtol=1e-3)
        for a, b in zip(taccs, jaccs):
            assert abs(a - b) <= 0.02


def _cfg(**kw):
    return dataclasses.replace(load_cfg(CFG), **kw)


@pytest.mark.parametrize("algo,family", [("GCNFULLBATCH", "gcn"),
                                         ("GSFULLBATCH", "sage"),
                                         ("GATFULLBATCH", "gat")])
def test_fullbatch_engines_build_and_run(tiny_ds, algo, family):
    cfg = RunConfig(algorithm=algo, layer_sizes=[32, 16, 5], epochs=2,
                    heads=2, vertices=tiny_ds.num_vertices)
    tr = build_trainer(cfg, tiny_ds, device="cpu")
    assert isinstance(tr, FullBatchEngine) and tr.family == family
    assert tr.base.optimizer.bias_correction
    report = run_engine(cfg, tiny_ds, device="cpu")
    assert len(report.losses) == 2 and np.isfinite(report.losses).all()
    assert report.edges_per_epoch == [tr.adj.num_edges] * 2
    assert 0.0 <= tr.evaluate(np.arange(10)) <= 1.0


@pytest.mark.parametrize("change", [dict(partition_graph=True),
                                    dict(halo="targeted")],
                         ids=["partition", "halo"])
def test_fullbatch_one_device_runs_the_single_device_program(tiny_ds, change):
    """PARTITION_GRAPH:1 and HALO:targeted on one device: the JAX package
    warns (PARTITION_GRAPH) and runs the single-device program
    (sgnn_tpu/train/engines.py:136-155; HALO is read only under a mesh),
    so the port gives the default run's losses, epoch for epoch."""
    kw = dict(algorithm="GCNFULLBATCH", layer_sizes=[32, 16, 5], epochs=2,
              vertices=tiny_ds.num_vertices)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("sgnn.engine")
    log.addHandler(handler)
    try:
        tr = build_trainer(RunConfig(**kw, **change), tiny_ds, device="cpu")
        report = tr.run()
    finally:
        log.removeHandler(handler)
    assert isinstance(tr, FullBatchEngine)
    assert tr.base.halo == change.get("halo", "all_gather")
    warned = [r.getMessage() for r in records
              if "only one device is visible" in r.getMessage()]
    assert len(warned) == (1 if "partition_graph" in change else 0)
    default = run_engine(RunConfig(**kw), tiny_ds, device="cpu")
    assert len(report.losses) == 2 and report.losses == default.losses
    # a mesh must be a graph group (tests/test_torch_port_partition.py)
    with pytest.raises(TypeError, match="graph group"):
        FullBatchTrainer(RunConfig(layer_sizes=[32, 16, 5]), tiny_ds,
                         mesh=object(), device="cpu")


@pytest.mark.parametrize("change,item", [
    (dict(feature_dtype="int8"), "item 6"), (dict(reorder="degree"), "item 7"),
], ids=["int8", "reorder"])
def test_fullbatch_unported_options_name_their_item(tiny_ds, change, item):
    """REORDER waits for item 7.  FEATURE_DTYPE:int8 trains on one device
    (parity in test_torch_port_quant.py) and, since item 6b, sharded: on a
    one-rank graph group it trains int8 shards as the single device does
    (2 ranks against JAX: test_torch_port_partition.py).  Checkpoints work
    (test_torch_port_checkpoint.py)."""
    cfg = RunConfig(algorithm="GCNFULLBATCH", layer_sizes=[32, 16, 5],
                    vertices=tiny_ds.num_vertices, **change)
    if item == "item 6":
        single = build_trainer(cfg, tiny_ds, device="cpu").base
        assert single.feature_int8
        group = make_group("cpu", graph=1)
        try:
            sharded = FullBatchTrainer(cfg, tiny_ds, mesh=group, device="cpu")
            assert sharded.feature_int8 and sharded.x.dtype == torch.int8
            for _ in range(2):
                got, want = sharded.train_epoch(), single.train_epoch()
                np.testing.assert_allclose(got, want, rtol=1e-6)
        finally:
            torch.distributed.destroy_process_group()
    else:
        with pytest.raises(NotImplementedError, match=item):
            build_trainer(cfg, tiny_ds, device="cpu")
    tr = FullBatchTrainer(RunConfig(layer_sizes=[32, 16, 5]), tiny_ds,
                          device="cpu")
    state = tr.checkpoint_state()
    assert set(state) == {"params", "opt_state", "dropout_rng"}
    tr.load_checkpoint_state(state)


def test_metrics_train_reuses_the_training_forward(tiny_ds, monkeypatch):
    """METRICS:clean at drop > 0 takes one more forward per epoch, without
    dropout; METRICS:train reuses the training log-probs.  The dropout
    draws, and so the losses, are the same either way."""
    calls = []
    orig = FullBatchTrainer.forward

    def counted(self, params, train):
        calls.append(train)
        return orig(self, params, train)

    monkeypatch.setattr(FullBatchTrainer, "forward", counted)
    runs = {}
    for metrics in ("clean", "train"):
        calls.clear()
        tr = FullBatchTrainer(RunConfig(layer_sizes=[32, 16, 5], seed=1,
                                        drop_rate=0.5, metrics=metrics),
                              tiny_ds, device="cpu")
        runs[metrics] = [tr.train_epoch() for _ in range(2)]
        assert calls == ([True, False] * 2 if metrics == "clean"
                         else [True] * 2)
    assert [r[0] for r in runs["clean"]] == [r[0] for r in runs["train"]]
    # drop 0: one forward whatever METRICS says
    calls.clear()
    FullBatchTrainer(RunConfig(layer_sizes=[32, 16, 5], drop_rate=0.0),
                     tiny_ds, device="cpu").train_epoch()
    assert calls == [True]


def test_forward_under_autograd_needs_the_transpose(tiny_ds):
    tr = FullBatchTrainer(RunConfig(layer_sizes=[32, 16, 5]), tiny_ds,
                          device="cpu")
    leaves = [p.detach().requires_grad_() for p in tr.params.leaves()]
    with pytest.raises(ValueError, match="graph_t"):
        full_forward(tr.params.replace_leaves(leaves), "gcn", tr.x, tr.csr)
    with torch.no_grad():   # no autograd: the transpose is not needed
        full_forward(tr.params.replace_leaves(leaves), "gcn", tr.x, tr.csr)


def test_gcn_fullbatch_learns_cora(cora):
    """tests/test_fullbatch.py:61-68's bounds, through run_engine."""
    cfg = _cfg(algorithm="GCNFULLBATCH", layer_sizes=[1433, 64, 7],
               epochs=40, learn_rate=0.01, weight_decay=5e-4)
    report = run_engine(cfg, cora, device="cpu")
    assert report.train_acc[-1] > 0.90, report.train_acc
    assert report.val_acc[-1] > 0.75, report.val_acc


@pytest.mark.parametrize("family", ["gcn", "gat"])
def test_bf16_tracks_f32(cora, family):
    """DTYPE:bfloat16 against f32 from the same parameters, 5 epochs at
    drop 0: bf16 rounds features, activations and the gradient flowing
    into the kernels to 8 significant bits (2^-9 relative, compounding
    through two layers and the update), so losses stay within 2e-2 of f32
    and accuracies within 0.05, while a real fault would move them by
    O(1)."""
    base = _cfg(algorithm=f"{family.upper()}FULLBATCH",
                layer_sizes=[1433, 32, 7], epochs=5, drop_rate=0.0,
                heads=2 if family == "gat" else 1)
    hist = {}
    for dt in ("float32", "bfloat16"):
        tr = build_trainer(dataclasses.replace(base, dtype=dt), cora,
                           device="cpu")
        assert tr.base.x.dtype == (torch.bfloat16 if dt == "bfloat16"
                                   else torch.float32)
        hist[dt] = tr.base.run(5)
    for a, b in zip(hist["float32"], hist["bfloat16"]):
        assert abs(a["loss"] - b["loss"]) <= 2e-2, (a, b)
        assert abs(a["train"] - b["train"]) <= 0.05, (a, b)


# ---------------------------------------------------- min/max serving -----
@pytest.mark.parametrize("family,aggregator", [("gcn", "min"),
                                               ("sage", "max")])
def test_minmax_serving_matches_jax(tiny_ds, family, aggregator):
    jp = j_init_model(jax.random.PRNGKey(4), family, [32, 16, 5])
    tp = params_from_numpy([np.asarray(w) for w in jp.weights], device="cpu")
    ja = JAdjacency.from_edges(tiny_ds.edges, tiny_ds.num_vertices)
    ta = Adjacency.from_edges(tiny_ds.edges, tiny_ds.num_vertices)
    js = JServer(jp, family, ja, tiny_ds.features, aggregator=aggregator)
    ts = InferenceServer(tp, family, ta, tiny_ds.features,
                         aggregator=aggregator, device="cpu")
    full = ts.logprobs()
    np.testing.assert_allclose(full, js.logprobs(), rtol=RTOL, atol=RTOL)
    nids = np.random.default_rng(1).integers(0, tiny_ds.num_vertices, 40)
    got = ts.query(nids)
    np.testing.assert_allclose(got, js.query(nids), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(got, full[nids], rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(ts.query(nids, fanout=[4, 2], seed=2),
                               js.query(nids, fanout=[4, 2], seed=2),
                               rtol=RTOL, atol=RTOL)
