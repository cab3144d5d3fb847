"""Port parity, rate probes: sgnn_tpu_torch.ops.probes against the JAX
package's probe scripts, on the same numpy inputs, on the CPU.

- P-G `gather_sum` against `pallas_vmem_gather_sum` (profile_vmem_gather
  .py:43) in interpret mode and against its XLA baseline `xla_gather_sum`;
- P-S `shuffle` against a restatement of probe_dyngather_shapes.py's
  `probe` closure (it cannot be imported) and `jnp.take_along_axis`;
- P-T `tile_spmm` against `onehot_spmm` (profile_onehot_spmm.py:43) in
  interpret mode and its `reference`; `tile_row_order` (the card
  kernel's order) against numpy's stable argsort and `tile_spmm_ordered`
  against a sequential numpy sum; the bisect cases of
  probe_onehot_parts.py and probe_onehot_parts2.py (closures inside
  `main`) against restatements citing their lines, and `reference` where
  it applies;
- P-A `gat_tile` against probe_gat_kernel_parts.py's `kernel` through the
  `pl.pallas_call` its `main` makes off the TPU (interpret mode), pads and
  repeated destinations included.

A script's Pallas kernel runs in interpret mode without editing the script:
the module is loaded from its file and its `pl` replaced by a namespace
whose `pallas_call` passes `interpret=True`.  On the CPU the port runs its
plain versions; the kernels' own tests are in test_torch_port_cuda.py.
"""

import functools
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sgnn_tpu_torch.ops import probes as pr

ROOT = pathlib.Path(__file__).resolve().parents[1]

# P-G, P-T: relative max-abs.  f32 on both sides; products of bf16 values
# are exact, so only the order of the f32 sums differs (tests/test_ops.py:47)
F32_REL = 1e-5
# P-A out: the repo's bf16 kernel bound (tests/test_mxu_spmm.py:57): a
# one-ulp difference in exp between the two libraries can flip bf16(u)
BF16_REL = 5e-3


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _load_script(name: str):
    """scripts/<name>.py with its `pl.pallas_call` in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                  if not k.startswith("_")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = ns
    return mod


@pytest.fixture(scope="module")
def vmem_gather():
    return _load_script("profile_vmem_gather")


@pytest.fixture(scope="module")
def onehot():
    return _load_script("profile_onehot_spmm")


@pytest.fixture(scope="module")
def gat_parts():
    return _load_script("probe_gat_kernel_parts")


def _sublanes(a):
    """The TPU's [n, 8, E] copy of an [n, E] index or weight array."""
    return np.ascontiguousarray(np.broadcast_to(a[:, None, :],
                                                (a.shape[0], 8, a.shape[1])))


def _bf16(a):
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


# ------------------------------------------------------------------ P-G ---
@pytest.mark.parametrize("t_rows,edges", [(256, 1024), (128, 512)])
def test_gather_sum_matches_pallas_and_xla(vmem_gather, t_rows, edges):
    # the JAX function's tile is the table's length (a square shuffle)
    table, idx = pr.gather_inputs(t_rows, t_rows, edges, tile=t_rows)
    got = {res: pr.gather_sum(torch.from_numpy(table), torch.from_numpy(idx),
                              res).numpy() for res in (True, False)}
    idx3d = jnp.asarray(_sublanes(idx))
    pallas = np.asarray(vmem_gather.pallas_vmem_gather_sum(
        jnp.asarray(table.T.copy()), idx3d))
    assert pallas.shape == (8 * idx.shape[0], table.shape[1])
    for out in got.values():
        assert out.shape == (idx.shape[0], table.shape[1])
        assert _rel(out, pallas[::8]) <= F32_REL
        assert _rel(out.sum(0), vmem_gather.xla_gather_sum(
            jnp.asarray(table), idx3d)) <= F32_REL


def test_gather_inputs_draw_as_the_script():
    # profile_vmem_gather.py:99-107 at its sizes
    rng = np.random.default_rng(0)
    table = np.asarray(jnp.asarray(rng.standard_normal((2048, 128)),
                                   jnp.float32))
    idx = rng.integers(0, 2048, size=1 << 20).astype(np.int32)
    got_table, got_idx = pr.gather_inputs(0, 2048)
    np.testing.assert_array_equal(got_table, table)
    np.testing.assert_array_equal(got_idx, idx.reshape(-1, 2048))


# ------------------------------------------------------------------ P-S ---
def _probe_shuffle(x, axis):
    """probe_dyngather_shapes.py:19-27 over the grid of :29-43: each step i
    writes take_along_axis(x, idx_i) to the one output block (its index map
    is constant), so the last step's result stands."""
    m, n = x.shape
    r = np.arange(m, dtype=np.int32)[:, None]
    c = np.arange(n, dtype=np.int32)[None, :]
    lim = m if axis == 0 else n
    for i in range(pr.SHUFFLE_STEPS):
        idx = ((r * 131 + c * 7 + i * 13) % lim).astype(np.int32)
        y = np.take_along_axis(x, idx, axis=axis)
    return y, idx


@pytest.mark.parametrize("shape,axis", pr.SHUFFLE_SHAPES,
                         ids=[f"{m}x{n}-axis{a}"
                              for (m, n), a in pr.SHUFFLE_SHAPES])
def test_shuffle_matches_probe(shape, axis):
    x = pr.shuffle_input(0, *shape)
    got = pr.shuffle(torch.from_numpy(x), axis).numpy()
    ref, last_idx = _probe_shuffle(x, axis)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(jnp.take_along_axis(
        jnp.asarray(x), jnp.asarray(last_idx), axis=axis)))


def test_shuffle_chained_like_the_scan():
    # probe_dyngather_shapes.py:45: the scan feeds each call the last result
    x = pr.shuffle_input(0, 8, 128)
    y, ref = torch.from_numpy(x), x
    for _ in range(8):
        y = pr.shuffle(y, 1)
        ref, _ = _probe_shuffle(ref, 1)
    np.testing.assert_array_equal(y.numpy(), ref)


# ------------------------------------------------------------------ P-T ---
@pytest.mark.parametrize("n_steps,s_blk,d_blk,e_t,e_sub,w_win",
                         [(2, 64, 256, 256, 64, 64),
                          (3, 128, 512, 256, 128, 96)])
def test_tile_spmm_matches_onehot_and_reference(onehot, n_steps, s_blk,
                                                d_blk, e_t, e_sub, w_win):
    a = pr.tile_inputs(n_steps, s_blk, d_blk, e_t, e_sub, w_win, n_steps)
    t = pr.to_torch(a, "cpu")
    got = pr.tile_spmm(t["slab"], t["src"], t["dst"], t["w"], t["r0"],
                       d_blk).numpy()
    args = (_bf16(a["slab"]), jnp.asarray(_sublanes(a["src"])),
            jnp.asarray(_sublanes(a["dst"])), _bf16(_sublanes(a["w"])))
    pallas = np.asarray(onehot.onehot_spmm(*args, jnp.asarray(a["r0"]),
                                           d_blk, e_sub, w_win))
    ref = onehot.reference(*args, a["r0"], d_blk, e_sub)
    assert got.shape == (d_blk, pr.PROBE_F)
    assert _rel(got, pallas) <= F32_REL
    assert _rel(got, ref) <= F32_REL


def test_tile_inputs_draw_as_the_script():
    # profile_onehot_spmm.py:124-140 at configuration 1's widths, 8 steps
    s_blk, d_blk, e_t, e_sub, w_win = pr.TILE_CONFIGS["1"]
    rng = np.random.default_rng(0)
    slab = jnp.asarray(rng.standard_normal((s_blk, 128)), jnp.bfloat16)
    src = rng.integers(0, s_blk, size=(8, 1, e_t)).astype(np.int32)
    dst = rng.integers(0, w_win, size=(8, 1, e_t)).astype(np.int32)
    w = rng.standard_normal((8, 1, e_t)).astype(np.float32)
    r0 = rng.integers(0, (d_blk - w_win) // 8,
                      size=(8, e_t // e_sub)).astype(np.int32) * 8
    got = pr.tile_inputs(0, s_blk, d_blk, e_t, e_sub, w_win, 8)
    np.testing.assert_array_equal(got["slab"], np.asarray(slab, np.float32))
    np.testing.assert_array_equal(got["src"], src[:, 0])
    np.testing.assert_array_equal(got["dst"], dst[:, 0])
    np.testing.assert_array_equal(
        got["w"], np.asarray(jnp.asarray(w[:, 0], jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(got["r0"], r0)


# the parts at small sizes: S_BLK, E_T, W, D_BLK, steps
PART_SIZES = (64, 256, 48, 512, 4)


def _parts_reference(part, slab, src, w, r0s, w_win, d_blk):
    """The bisect cases restated in numpy, f32 sums of exact products."""
    n, e_t = src.shape
    msgs = slab[src]                                    # f32(bf16 slab)
    if part == "c1":  # probe_onehot_parts.py:46-52, out block (i, 0) :62
        return msgs.reshape(n * e_t, -1)
    if part == "a":   # probe_onehot_parts2.py:46-54: out[0:E_T] += msgs
        out = np.zeros((d_blk, slab.shape[1]), np.float32)
        for s in range(n):
            out[:e_t] += msgs[s]
        return out
    dst = src % w_win  # probe_onehot_parts.py:84, probe_onehot_parts2.py:75
    if part in ("b", "c"):  # probe_onehot_parts2.py:72-80 and :100-107:
        out = np.zeros((n * w_win, slab.shape[1]), np.float32)  # own block
        for s in range(n):
            wt = w[s] if part == "b" else np.ones(e_t, np.float32)
            np.add.at(out, s * w_win + dst[s], msgs[s] * wt[:, None])
        return out
    out = np.zeros((d_blk, slab.shape[1]), np.float32)
    for s in range(n):  # c2 :70-90 (window at 0), c3 :110-131 (at r0s[s, 0])
        r0 = 0 if part == "c2" else int(r0s[s, 0])
        np.add.at(out, r0 + dst[s], msgs[s] * w[s][:, None])
    return out


@pytest.mark.parametrize("part", pr.TILE_PARTS)
def test_tile_parts_match_restatements(onehot, part):
    s_blk, e_t, w_win, d_blk, steps = PART_SIZES
    a = pr.tile_part_inputs(7, s_blk, e_t, w_win, d_blk, steps)
    t = pr.to_torch(a, "cpu")
    fn, args = pr.tile_part_args(part, t["slab"], t["src"], t["w"],
                                 t["r0s"], w_win, d_blk)
    got = fn(*args).numpy()
    ref = _parts_reference(part, a["slab"], a["src"], a["w"], a["r0s"],
                           w_win, d_blk)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= F32_REL
    if part == "c1":
        return
    # the script's own reference on the same case: windows of one sub-tile
    n = steps
    dst = {"a": np.broadcast_to(np.arange(e_t, dtype=np.int32), (n, e_t))
           }.get(part, a["src"] % w_win)
    wts = a["w"] if part in ("b", "c2", "c3") else np.ones((n, e_t),
                                                           np.float32)
    r0 = {"b": np.arange(n)[:, None] * w_win, "c": np.arange(n)[:, None]
          * w_win, "c3": a["r0s"][:, :1]}.get(part, np.zeros((n, 1)))
    rows = ref.shape[0]
    script_ref = onehot.reference(
        _bf16(a["slab"]), _sublanes(a["src"]), _sublanes(dst),
        _bf16(_sublanes(wts)), r0.astype(np.int32), rows, e_t)
    assert _rel(got, script_ref) <= F32_REL


def test_tile_part_inputs_draw_as_the_scripts():
    # probe_onehot_parts.py:34-43 at its sizes
    rng = np.random.default_rng(0)
    slab = jnp.asarray(rng.standard_normal((1024, 128)), jnp.bfloat16)
    src = rng.integers(0, 1024, size=(4, 1, 2048)).astype(np.int32)
    w8 = jnp.asarray(rng.standard_normal((4, 1, 2048)).astype(np.float32),
                     jnp.bfloat16)
    r0s = (rng.integers(0, (8192 - 1280) // 8, size=(4, 8)) * 8).astype(
        np.int32)
    got = pr.tile_part_inputs(0)
    np.testing.assert_array_equal(got["slab"], np.asarray(slab, np.float32))
    np.testing.assert_array_equal(got["src"], src[:, 0])
    np.testing.assert_array_equal(got["w"], np.asarray(w8, np.float32)[:, 0])
    np.testing.assert_array_equal(got["r0s"], r0s)


@pytest.mark.parametrize("n_steps,e_t,e_sub,d_blk,w_win",
                         [(3, 64, 16, 96, 40), (5, 48, 48, 120, 70)])
def test_tile_row_order_is_numpy_stable_argsort(n_steps, e_t, e_sub, d_blk,
                                                w_win):
    # the card kernel's order of sums: each row's edges in (step, edge)
    # order; rows repeat within a step and across steps
    a = pr.tile_inputs(n_steps, 32, d_blk, e_t, e_sub, w_win, n_steps, 8)
    t = pr.to_torch(a, "cpu")
    rows, order = pr.tile_row_order(t["src"], t["dst"], t["r0"])
    want = (np.repeat(a["r0"], e_sub, axis=1) + a["dst"]).reshape(-1)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(want, kind="stable"))
    np.testing.assert_array_equal(rows.numpy(), np.sort(want))


@pytest.mark.parametrize("part", ["a", "c2"])
def test_tile_spmm_ordered_is_the_sequential_sum(part):
    # added one message at a time in tile_row_order, from f32 zeros: the
    # plain index_add_ within F32_REL, and a numpy loop bit for bit
    s_blk, e_t, w_win, d_blk, steps = PART_SIZES
    t = pr.to_torch(pr.tile_part_inputs(11, s_blk, e_t, w_win, d_blk,
                                        steps), "cpu")
    fn, args = pr.tile_part_args(part, t["slab"], t["src"], t["w"],
                                 t["r0s"], w_win, d_blk)
    got = pr.tile_spmm_ordered(*args)
    assert _rel(got.numpy(), pr.tile_spmm_plain(*args).numpy()) <= F32_REL
    slab, src, dst, w, r0, _ = args
    rows = pr.tile_rows(src, dst, r0).reshape(-1).numpy()
    msgs = slab.float().numpy()[src.reshape(-1).numpy()]
    if w is not None:
        msgs = msgs * w.float().numpy().reshape(-1, 1)
    want = np.zeros((d_blk, slab.shape[1]), np.float32)
    for i in np.argsort(rows, kind="stable"):
        want[rows[i]] = want[rows[i]] + msgs[i]
    np.testing.assert_array_equal(got.numpy(), want)


def test_tile_part_args_rejects_unknown_part():
    t = pr.to_torch(pr.tile_part_inputs(0, *PART_SIZES), "cpu")
    with pytest.raises(ValueError, match="unknown part"):
        pr.tile_part_args("d", t["slab"], t["src"], t["w"], t["r0s"])


# ------------------------------------------------------------------ P-A ---
def _gat_inputs(case):
    a = pr.gat_tile_inputs(0 if case == "probe" else 3)
    if case == "pads":
        rng = np.random.default_rng(5)
        # sentinel sources with real destinations: u reaches z, no message
        a["dst"][0, 200:230] = rng.integers(0, pr.GAT_W, 30)
        # real sources with the sentinel destination: nothing at all
        a["src"][0, 230:] = rng.integers(0, pr.GAT_S_BLK, 26)
        # one destination taking many edges, sources repeated
        a["dst"][0, :40] = 7
        a["src"][0, 40:60] = 3
    return a


def _jax_gat_tile(mod, a):
    """probe_gat_kernel_parts.py:98-108: the one-tile call its main makes,
    in interpret mode as off the TPU."""
    out, z = pl.pallas_call(
        mod.kernel,
        out_shape=(jax.ShapeDtypeStruct((mod.W_WIN, mod.F), jnp.float32),
                   jax.ShapeDtypeStruct((mod.W_WIN, 8), jnp.float32)),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 5,
        out_specs=(pl.BlockSpec(memory_space=pltpu.VMEM),
                   pl.BlockSpec(memory_space=pltpu.VMEM)),
        interpret=True,
    )(jnp.asarray(a["src"][0].reshape(1, -1)),
      jnp.asarray(a["dst"][0].reshape(1, -1)), _bf16(a["slab"][0]),
      _bf16(a["ts"][0]), jnp.asarray(a["td"][0]))
    return np.asarray(out), np.asarray(z)


@pytest.mark.parametrize("case", ["probe", "pads"])
def test_gat_tile_matches_pallas_kernel(gat_parts, case):
    a = _gat_inputs(case)
    t = pr.to_torch(a, "cpu")
    out, z = pr.gat_tile(t["slab"], t["ts"], t["td"], t["src"], t["dst"],
                         pr.GAT_HEADS)
    assert out.shape == (1, pr.GAT_W, pr.PROBE_F)
    assert z.shape == (1, pr.GAT_W, pr.GAT_TABLE_COLS)
    j_out, j_z = _jax_gat_tile(gat_parts, a)
    assert _rel(out[0].numpy(), j_out) <= BF16_REL
    assert _rel(z[0].numpy(), j_z) <= F32_REL
    if case == "pads":
        # the sentinel-source edges' u = exp(lrelu(bf16 td[d])) is in z
        src, dst = a["src"][0], a["dst"][0]
        only_pads = np.setdiff1d(dst[200:230], dst[(src < pr.GAT_S_BLK)
                                                   & (dst < pr.GAT_W)])
        assert only_pads.size > 0
        assert (z[0].numpy()[only_pads, :pr.GAT_HEADS] > 0).all()
        np.testing.assert_array_equal(out[0].numpy()[only_pads], 0.0)


def test_gat_tile_meets_the_script_check():
    # probe_gat_kernel_parts.py:111-131: its numpy reference (td unrounded)
    # at its own bounds
    a = pr.gat_tile_inputs(0)
    t = pr.to_torch(a, "cpu")
    out, z = (v[0].numpy() for v in pr.gat_tile(
        t["slab"], t["ts"], t["td"], t["src"], t["dst"], pr.GAT_HEADS))
    slab, ts, td = a["slab"][0], a["ts"][0], a["td"][0]
    fh = pr.PROBE_F // pr.GAT_HEADS
    ref = np.zeros_like(out)
    zref = np.zeros_like(z)
    for e in range(pr.GAT_LIVE):
        s, d = a["src"][0, e], a["dst"][0, e]
        sc = ts[s] + td[d]
        sc = np.where(sc >= 0, sc, 0.2 * sc)
        u = np.exp(np.clip(sc, -60.0, 60.0))
        zref[d] += u
        for h in range(pr.GAT_HEADS):
            ref[d, h * fh:(h + 1) * fh] += (
                pr.bf16_round(np.float32(u[h])) * slab[s, h * fh:(h + 1) * fh])
    assert _rel(out, ref) < 3e-2 and _rel(z, zref) < 1e-2


def test_gat_tile_inputs_draw_as_the_script():
    # probe_gat_kernel_parts.py:85-95; tile 1 continues the same generator
    rng = np.random.default_rng(0)
    src = np.full(256, 256, np.int32)
    dst = np.full(256, 128, np.int32)
    src[:200] = rng.integers(0, 256, 200)
    dst[:200] = np.sort(rng.integers(0, 128, 200))
    slab = rng.standard_normal((256, 128)).astype(np.float32)
    ts = np.zeros((256, 8), np.float32)
    td = np.zeros((128, 8), np.float32)
    ts[:, :4] = rng.standard_normal((256, 4)) * 0.3
    td[:, :4] = rng.standard_normal((128, 4)) * 0.3
    got = pr.gat_tile_inputs(0, n_tiles=2)
    np.testing.assert_array_equal(got["src"][0], src)
    np.testing.assert_array_equal(got["dst"][0], dst)
    np.testing.assert_array_equal(
        got["slab"][0], np.asarray(jnp.asarray(slab, jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(
        got["ts"][0], np.asarray(jnp.asarray(ts, jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(got["td"][0], td)
    assert not np.array_equal(got["src"][1], got["src"][0])


# ------------------------------------------------------------ dispatch ---
def test_checks_reject_bad_arguments():
    table = torch.zeros((4, 8), dtype=torch.float64)
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="table must be"):
        pr.gather_sum(table, idx)
    with pytest.raises(ValueError, match="axis"):
        pr.shuffle(torch.zeros((4, 4)), 2)
    slab = torch.zeros((4, 8), dtype=torch.bfloat16)
    src = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="n_sub"):
        pr.tile_spmm(slab, src, None, None,
                     torch.zeros((2, 3), dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="heads"):
        pr.gat_tile(torch.zeros((1, 4, 8), dtype=torch.bfloat16),
                    torch.zeros((1, 4, 2), dtype=torch.bfloat16),
                    torch.zeros((1, 2, 2)), src[:1], src[:1], 3)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pr.gather_sum(torch.zeros((4, 8), device="meta"), idx)
