"""Port parity, K1: sgnn_tpu_torch's `gather_aggregate` (forward, dx, dw)
against sgnn_tpu's XLA `gather_aggregate`, its custom VJP under `jax.grad`,
and the Pallas kernel `pallas_gather_aggregate_fwd_impl` in interpret mode
(as tests/test_ops.py:221-236 runs it), on the same numpy blocks.  On the
CPU the port runs its plain PyTorch versions; the CUDA kernels' own tests
are in test_torch_port_cuda.py.  Also the port of tests/test_ops.py:42-77:
the dense-matrix and finite-difference checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgnn_tpu.ops.aggregate import gather_aggregate as j_gather_aggregate
from sgnn_tpu.ops.pallas.gather_agg import pallas_gather_aggregate_fwd_impl

from sgnn_tpu_torch.ops import aggregate as agg
from sgnn_tpu_torch.ops.aggregate import block_transpose, gather_aggregate
from sgnn_tpu_torch.ops.segment import LONG_ROW_EDGES, spmm_csr_plain

# f32 on both sides, the same slot order: only the rounding of fused and
# unfused multiply-adds differs (tests/test_ops.py:47, :236)
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-6)


def _block(rng, d=16, k=5, s=24, f=8, hub=False):
    nbr = rng.integers(0, s, size=(d, k)).astype(np.int32)
    if hub:
        nbr[:, 0] = 3   # one source in every row: the dx contention case
    w = rng.random((d, k)).astype(np.float32)
    w[rng.random((d, k)) < 0.3] = 0.0  # padded slots
    x = rng.standard_normal((s, f)).astype(np.float32)
    return x, nbr, w


def _dense_adj(nbr, w, s):
    a = np.zeros((nbr.shape[0], s), np.float32)
    for d in range(nbr.shape[0]):
        for k in range(nbr.shape[1]):
            a[d, nbr[d, k]] += w[d, k]
    return a


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape", [(16, 5, 24, 8), (37, 1, 50, 41),
                                   (19, 10, 30, 128)])
def test_forward_matches_jax_and_pallas(shape):
    d, k, s, f = shape
    rng = np.random.default_rng(d * k)
    x, nbr, w = _block(rng, d, k, s, f, hub=True)
    out = gather_aggregate(*_t(x, nbr, w)).numpy()
    ref = np.asarray(j_gather_aggregate(jnp.asarray(x), jnp.asarray(nbr),
                                        jnp.asarray(w)))
    np.testing.assert_allclose(out, ref, **FWD)
    # the Pallas kernel needs D % 8 == 0 (its 8-row tile); the port does not
    d8 = d - d % 8
    pal = np.asarray(pallas_gather_aggregate_fwd_impl(
        jnp.asarray(x), jnp.asarray(nbr[:d8]), jnp.asarray(w[:d8]),
        interpret=True))
    np.testing.assert_allclose(out[:d8], pal, **FWD)


@pytest.mark.parametrize("hub", [False, True])
def test_dx_dw_match_jax_grad(hub):
    rng = np.random.default_rng(3)
    x, nbr, w = _block(rng, 40, 25, 30, 12, hub=hub)
    g = rng.standard_normal((40, 12)).astype(np.float32)

    def j_loss(xx, ww):
        return jnp.sum(j_gather_aggregate(xx, jnp.asarray(nbr), ww)
                       * jnp.asarray(g))

    jdx, jdw = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x),
                                                 jnp.asarray(w))
    tx, tnbr, tw, tg = _t(x, nbr, w, g)
    tx.requires_grad_()
    tw.requires_grad_()
    (gather_aggregate(tx, tnbr, tw) * tg).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **GRAD)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **GRAD)


def test_dw_only_when_asked(monkeypatch):
    """The sampler's weights need no gradient: the dw product is skipped."""
    rng = np.random.default_rng(4)
    x, nbr, w = _t(*_block(rng))
    x.requires_grad_()
    calls = []
    monkeypatch.setattr(agg, "gather_agg_bwd_dw",
                        lambda *a: calls.append(1))
    gather_aggregate(x, nbr, w).sum().backward()
    assert calls == [] and x.grad is not None


def test_bf16_forward_rounds_once():
    rng = np.random.default_rng(5)
    x, nbr, w = _block(rng, 30, 10, 40, 16)
    xb = torch.from_numpy(x).bfloat16()
    out = gather_aggregate(xb, *_t(nbr, w))
    assert out.dtype == torch.bfloat16
    exact = _dense_adj(nbr, w, 40) @ xb.float().numpy()
    # an f32 sum rounded once to bf16: half a bf16 ulp, 2^-9 relative
    np.testing.assert_allclose(out.float().numpy(), exact, rtol=2 ** -8,
                               atol=1e-6)


def test_rejects_what_the_kernel_does_not_take():
    x, nbr, w = _t(*_block(np.random.default_rng(6)))
    with pytest.raises(ValueError, match="nbr must be"):
        gather_aggregate(x, nbr.long(), w)
    with pytest.raises(ValueError, match="differ in shape"):
        gather_aggregate(x, nbr, w[:, :2].contiguous())
    with pytest.raises(ValueError, match="x must be"):
        gather_aggregate(x.double(), nbr, w)


# --------------------------- the port of tests/test_ops.py:42-77 ----------
def test_gather_aggregate_matches_dense():
    rng = np.random.default_rng(0)
    x, nbr, w = _block(rng)
    out = gather_aggregate(*_t(x, nbr, w))
    np.testing.assert_allclose(out.numpy(), _dense_adj(nbr, w, 24) @ x,
                               rtol=1e-5)


def test_gather_aggregate_grad_x():
    rng = np.random.default_rng(1)
    x, nbr, w = _block(rng)
    a = torch.from_numpy(_dense_adj(nbr, w, 24))
    tx, tnbr, tw = _t(x, nbr, w)
    xs = tx.clone().requires_grad_()
    torch.sin(gather_aggregate(xs, tnbr, tw)).sum().backward()
    xd = tx.clone().requires_grad_()
    torch.sin(a @ xd).sum().backward()
    np.testing.assert_allclose(xs.grad.numpy(), xd.grad.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_gather_aggregate_grad_w():
    rng = np.random.default_rng(2)
    x, nbr, w = _t(*_block(rng, d=6, k=3, s=10, f=4))

    def f(ww):
        return (gather_aggregate(x, nbr, ww) ** 2).sum()

    wg = w.clone().requires_grad_()
    f(wg).backward()
    eps = 1e-3
    for d, k in [(0, 0), (3, 2), (5, 1)]:
        wp, wm = w.clone(), w.clone()
        wp[d, k] += eps
        wm[d, k] -= eps
        num = (f(wp) - f(wm)).item() / (2 * eps)
        assert np.isclose(wg.grad[d, k].item(), num, rtol=1e-2, atol=1e-2)


# ------------------------------------- dx's transpose (the card's dx path) --
def _hub_block(rng, d=1000, k=5, s=300, f=9):
    """A block with a hub source of more than LONG_ROW_EDGES slots, sources
    with no slot, 30% zero-weight slots (some pointing at row 0, as the
    sampler pads)."""
    x, nbr, w = _block(rng, d, k, s, f)
    nbr.reshape(-1)[::2] = 7      # the hub: ~1600 slots of nonzero weight
    nbr[nbr % 10 == 3] = 4        # sources 3, 13, ...: none
    pad = rng.random((d, k)) < 0.1
    nbr[pad], w[pad] = 0, 0.0
    return x, nbr, w


def test_block_transpose_plain_matches_numpy_stable_argsort():
    rng = np.random.default_rng(8)
    _, nbr, w = _hub_block(rng)
    s = 300
    rowptr, col, wt = (t.numpy() for t in block_transpose(*_t(nbr, w), s))
    flat_n, flat_w = nbr.reshape(-1), w.reshape(-1)
    kept = np.flatnonzero(flat_w != 0)
    order = kept[np.argsort(flat_n[kept], kind="stable")]
    nnz = order.size
    want_ptr = np.zeros(s + 1, np.int64)
    np.cumsum(np.bincount(flat_n[kept], minlength=s), out=want_ptr[1:])
    np.testing.assert_array_equal(rowptr, want_ptr)
    np.testing.assert_array_equal(col[:nnz], order // nbr.shape[1])
    np.testing.assert_array_equal(wt[:nnz], flat_w[order])
    # zero-weight slots dropped past rowptr[S]; the hub is longer than a
    # split row; sources with no slot have empty rows
    assert nnz < flat_w.size and np.all(wt[nnz:] == 0)
    assert np.diff(rowptr).max() > LONG_ROW_EDGES
    assert np.all(np.diff(rowptr)[3::10] == 0)
    for src in (0, 7, 150):   # each source's entries in ascending slot order
        lo, hi = rowptr[src], rowptr[src + 1]
        slots = order[lo:hi]
        assert np.all(np.diff(slots) > 0)


def test_dx_over_the_transpose_matches_jax_vjp():
    """The card's dx is a CSR sum over the block's transpose: that sum and
    the port's CPU dx both match jax.vjp of the JAX gather_aggregate, with
    a hub source longer than LONG_ROW_EDGES (f32, relative max-abs: the
    hub's ~1000-term sums are taken in three orders)."""
    rng = np.random.default_rng(9)
    x, nbr, w = _hub_block(rng)
    g = rng.standard_normal((1000, x.shape[1])).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: j_gather_aggregate(xx, jnp.asarray(nbr),
                                                   jnp.asarray(w)),
                     jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    tx, tnbr, tw, tg = _t(x, nbr, w, g)
    tx.requires_grad_()
    gather_aggregate(tx, tnbr, tw).backward(tg)
    rowptr, col, wt = block_transpose(tnbr, tw, x.shape[0])
    nnz = int(rowptr[-1])
    summed = spmm_csr_plain(tg, rowptr, col[:nnz], wt[:nnz]).numpy()
    for got in (tx.grad.numpy(), summed):
        assert np.abs(got - ref).max() / np.abs(ref).max() <= 1e-5
    np.testing.assert_allclose(tx.grad.numpy(), ref, **GRAD)
