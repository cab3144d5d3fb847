"""Port parity, SpMM: sgnn_tpu_torch.ops.segment.spmm_csr against sgnn_tpu's
whole-graph SpMMs on the same numpy graph and features — the XLA sorted
segment sum (`spmm_coo_fwd_sorted`) and the one-hot Pallas kernel
(`mxu_spmm_fwd`, in interpret mode on the CPU, as tests/test_mxu_spmm.py
runs it).  On the CPU `spmm_csr` is its plain PyTorch version; the CUDA
kernel's own tests are in test_torch_port_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.ops.pallas.mxu_spmm import build_mxu_spmm_plan, mxu_spmm_fwd
from sgnn_tpu.ops.segment import spmm_coo, spmm_coo_fwd_sorted

from sgnn_tpu_torch.ops.cuda.spmm import rows_fit_a_warp, spmm_csr_cuda
from sgnn_tpu_torch.ops.segment import (
    LONG_ROW_EDGES, SpmmCsr, csr_chunk_edges, csr_from_numpy, csr_transpose,
    spmm_csr, spmm_csr_plain,
)

# the tiny one-hot kernel geometry of tests/test_mxu_spmm.py:22-23
KW = dict(s_blk=256, d_blk=512, w_win=128, e_sub=64, e_t=256,
          max_pad_ratio=50.0, chunk_steps=7)


def _csc_graph(rng, v, e, skew=False, zero_rows=()):
    """A dst-sorted (CSC-order) random multigraph: (src, dst, w, rowptr)."""
    if skew:
        dst = (rng.zipf(1.5, e) % v).astype(np.int32)
    else:
        dst = rng.integers(0, v, e).astype(np.int32)
    keep = ~np.isin(dst, np.asarray(zero_rows, np.int32))
    dst = dst[keep]
    src = rng.integers(0, v, dst.size).astype(np.int32)
    w = rng.standard_normal(dst.size).astype(np.float32)
    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    rowptr = np.zeros(v + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=v), out=rowptr[1:])
    return src, dst, w, rowptr


def _port(x, src, w, rowptr, dtype=torch.float32):
    csr = csr_from_numpy(rowptr, src, w, x.shape[0], device="cpu")
    return spmm_csr(torch.from_numpy(x).to(dtype), *csr)


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("feat", [7, 48])
def test_spmm_csr_plain_matches_spmm_coo_fwd_sorted(skew, feat):
    rng = np.random.default_rng(11)
    v = 700
    src, dst, w, rowptr = _csc_graph(rng, v, 5000, skew)
    x = rng.standard_normal((v, feat)).astype(np.float32)
    ref = np.asarray(spmm_coo_fwd_sorted(jnp.asarray(x), jnp.asarray(src),
                                         jnp.asarray(dst), jnp.asarray(w), v))
    out = _port(x, src, w, rowptr).numpy()
    # both sum f32 products in CSC edge order: the repo's f32 op tolerance
    # (tests/test_ops.py:47); atol only absorbs sums that cancel to ~0
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("skew", [False, True])
def test_spmm_csr_plain_matches_mxu_spmm_fwd(skew):
    rng = np.random.default_rng(3)
    v = 1100
    src, dst, w, rowptr = _csc_graph(rng, v, 5000, skew)
    x = rng.standard_normal((v, 48)).astype(np.float32)
    plan = build_mxu_spmm_plan(src, dst, w, v, v, **KW)
    assert plan is not None and plan.static.n_chunks >= 2
    ref = np.asarray(mxu_spmm_fwd(jnp.asarray(x), *plan.operands, plan.meta,
                                  plan.static))
    out = _port(x, src, w, rowptr).numpy()
    # the one-hot kernel casts x and w to bf16 (f32 accumulate); the port
    # keeps f32: the bf16 kernel bound of tests/test_mxu_spmm.py:57
    assert np.abs(out - ref).max() / np.abs(ref).max() < 5e-3


def test_spmm_csr_zero_in_degree_rows_are_zero():
    rng = np.random.default_rng(2)
    v = 300
    src, dst, w, rowptr = _csc_graph(rng, v, 2000, zero_rows=(0, 5, 299))
    x = rng.standard_normal((v, 9)).astype(np.float32)
    out = _port(x, src, w, rowptr).numpy()
    assert np.all(out[[0, 5, 299]] == 0.0)
    ref = np.zeros_like(out)
    np.add.at(ref, dst, x[src] * w[:, None])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_spmm_csr_bf16_sums_in_f32_and_rounds_once():
    rng = np.random.default_rng(4)
    v = 400
    src, dst, w, rowptr = _csc_graph(rng, v, 4000)
    x = rng.standard_normal((v, 16)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    out = _port(x, src, w, rowptr, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    ref = np.zeros((v, 16), np.float64)
    np.add.at(ref, dst, xb.double().numpy()[src] * w[:, None])
    # f32 sum of bf16 inputs, one final rounding: within one bf16 ulp
    # (2^-8 relative) of the exact sum, plus f32 reassociation
    err = np.abs(out.double().numpy() - ref)
    assert np.all(err <= 2.0 ** -8 * np.abs(ref) + 1e-5)


def test_spmm_csr_plain_chunks_equal_one_pass(monkeypatch):
    import sgnn_tpu_torch.ops.segment as seg

    rng = np.random.default_rng(6)
    v = 200
    src, dst, w, rowptr = _csc_graph(rng, v, 3000)
    x = torch.from_numpy(rng.standard_normal((v, 5)).astype(np.float32))
    csr = csr_from_numpy(rowptr, src, w, v, device="cpu")
    whole = spmm_csr_plain(x, *csr)
    monkeypatch.setattr(seg, "PLAIN_CHUNK_EDGES", 97)
    # chunking keeps each row's edge order: the same sums, bit for bit
    assert torch.equal(seg.spmm_csr_plain(x, *csr), whole)


def test_csr_from_numpy_checks_bounds():
    rowptr = np.array([0, 2, 3], np.int64)
    col = np.array([0, 1, 1], np.int32)
    w = np.ones(3, np.float32)
    csr_from_numpy(rowptr, col, w, num_src=2, device="cpu")
    with pytest.raises(ValueError, match="source ids"):
        csr_from_numpy(rowptr, col, w, num_src=1, device="cpu")
    with pytest.raises(ValueError, match="source ids"):
        csr_from_numpy(rowptr, np.array([0, -1, 1], np.int32), w, 2, "cpu")
    with pytest.raises(ValueError, match="non-decreasing"):
        csr_from_numpy(np.array([0, 3, 2, 3]), col, w, 2, device="cpu")
    with pytest.raises(ValueError, match="ends at"):
        csr_from_numpy(np.array([0, 2, 4]), col, w, 2, device="cpu")


def test_spmm_csr_rejects_what_the_kernel_does_not_take():
    rowptr = torch.tensor([0, 1, 2])
    col = torch.tensor([0, 1], dtype=torch.int32)
    w = torch.ones(2)
    x = torch.ones(2, 3)
    for bad in (dict(x=x.half()), dict(x=x.t()), dict(col=col.long()),
                dict(w=w.double()), dict(rowptr=rowptr.int()),
                dict(w=torch.ones(3))):
        args = {**dict(x=x, rowptr=rowptr, col=col, w=w), **bad}
        with pytest.raises(ValueError):
            spmm_csr(args["x"], args["rowptr"], args["col"], args["w"])


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the CUDA wrapper never runs the plain version."""
    x = torch.ones(2, 3)
    before = spmm_csr_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmm_csr_cuda(x, torch.tensor([0, 1, 2]),
                      torch.tensor([0, 1], dtype=torch.int32), torch.ones(2))
    assert spmm_csr_cuda.launches == before


@pytest.mark.parametrize("feat", [7, 41])
def test_spmm_csr_backward_matches_spmm_coo_vjp_with_a_hub(feat):
    """K2's backward (SpmmCsr over the transposed CSR) against the VJP of
    the JAX package's spmm_coo, on a graph whose source 5 takes every 4th
    edge: a transposed row of over LONG_ROW_EDGES edges, many of the card's
    chunks (`csr_chunk_edges`); some sources have no out-edges."""
    rng = np.random.default_rng(12 + feat)
    v = 900
    src, dst, w, rowptr = _csc_graph(rng, v, 8000, skew=True)
    src[::4] = 5
    src[src % 17 == 2] = 1
    x = rng.standard_normal((v, feat)).astype(np.float32)
    c = rng.standard_normal((v, feat)).astype(np.float32)
    rowptr_t, col_t, w_t = csr_transpose(rowptr, src, w, v)
    assert np.diff(rowptr_t).max() > max(LONG_ROW_EDGES,
                                         4 * csr_chunk_edges(src.size))
    _, vjp = jax.vjp(lambda t: spmm_coo(t, jnp.asarray(src), jnp.asarray(dst),
                                        jnp.asarray(w), v), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(c))[0])
    xt = torch.from_numpy(x).requires_grad_()
    csr = csr_from_numpy(rowptr, src, w, v, device="cpu")
    csr_t = csr_from_numpy(rowptr_t, col_t, w_t, v, device="cpu")
    SpmmCsr.apply(xt, *csr, *csr_t).backward(torch.from_numpy(c))
    got = xt.grad.numpy()
    # f32, sums in other orders (the hub's ~2000 terms): the repo's f32 op
    # tolerance as max |Δ| / max |ref|
    assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5
    assert np.all(got[2::17] == 0)      # sources with no out-edges


def test_forward_kernel_choice_is_made_once_per_csr():
    """The card's forward runs a warp per row when every row has at most
    LONG_ROW_EDGES edges, else the edge-balanced sum; the check is made
    once per CSR and kept on its rowptr tensor (torch ops: checked here on
    CPU tensors)."""
    assert rows_fit_a_warp(torch.tensor([0, 3, 3, LONG_ROW_EDGES + 3]))
    rowptr = torch.tensor([0, 5, LONG_ROW_EDGES + 6, LONG_ROW_EDGES + 6])
    assert not rows_fit_a_warp(rowptr)
    rowptr[-1] = 0                       # not looked at again
    assert not rows_fit_a_warp(rowptr)
    assert rows_fit_a_warp(torch.tensor([0]))
