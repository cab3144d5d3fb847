"""The port's roofline module (sgnn_tpu_torch/utils/roofline.py) against
the JAX package's (sgnn_tpu/utils/roofline.py) and against the kernel
bounds chip_smoke.py prints (PERF.md §6's bound column).

All on the CPU, no card, no large arrays: the module is numpy-free
arithmetic on shapes."""

import math

import numpy as np
import pytest

from sgnn_tpu.utils import roofline as jax_roofline
from sgnn_tpu_torch.ops import probes as pr
from sgnn_tpu_torch.utils import roofline

H100 = "NVIDIA H100 80GB HBM3"
# the Reddit-shaped graph chip_smoke.py drives: reddit_like_dataset(seed=0,
# scale=1.0), self-loops included; K1's and PushDown's x has its rows
# padded to 233,088
V, E = 232_965, 11_880_013
V_PAD = 233_088


# ---- (a) equal to JAX's where the lanes pad nothing -----------------------
@pytest.mark.parametrize("widths", [[128, 128], [256]], ids=str)
@pytest.mark.parametrize("dtype_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("model", ["spmm", "spmm_backward", "sampled",
                                   "sampled_forward"])
def test_bytes_models_equal_jax_at_full_lanes(model, dtype_bytes, widths):
    if model.startswith("spmm"):
        args = (E, V, widths, dtype_bytes, model == "spmm_backward")
        got = roofline.spmm_bytes_model(*args)
        want = jax_roofline.spmm_bytes_model(*args)
    else:
        hops = [E * 25 // 35, E - E * 25 // 35][:len(widths)]
        args = (hops, widths[0], widths[-1], dtype_bytes,
                model == "sampled")
        got = roofline.sampled_bytes_model(*args)
        want = jax_roofline.sampled_bytes_model(*args)
    assert got == want > 0
    lane = (roofline.lane_padded_spmm_bytes_model(*args)
            if model.startswith("spmm")
            else roofline.lane_padded_sampled_bytes_model(*args))
    assert lane == want


# ---- (b) the sector rule at F = 41 and 602 -------------------------------
@pytest.mark.parametrize("feat, dtype_bytes, sector, lanes", [
    (41, 4, 192, 512), (41, 2, 96, 256), (602, 4, 2432, 2560),
    (602, 2, 1216, 1280)])
def test_row_bytes_sector_rule_and_jax_lanes(feat, dtype_bytes, sector,
                                             lanes):
    assert roofline.sector_row_bytes(feat, dtype_bytes) == sector
    assert sector == math.ceil(feat * dtype_bytes / 32) * 32
    assert roofline.lane_row_bytes(feat, dtype_bytes) == lanes
    acc_sector = math.ceil(feat * 4 / 32) * 32
    acc_lanes = jax_roofline.spmm_bytes_model(0, 1, [feat])
    # one edge and one vertex of one layer, each rule's closed form
    assert (roofline.spmm_bytes_model(1000, 100, [feat], dtype_bytes)
            == 1000 * sector + 100 * acc_sector)
    assert (jax_roofline.spmm_bytes_model(1000, 100, [feat], dtype_bytes)
            == roofline.lane_padded_spmm_bytes_model(1000, 100, [feat],
                                                     dtype_bytes)
            == 1000 * lanes + 100 * acc_lanes)
    assert (roofline.sampled_bytes_model([1000], feat, 7, dtype_bytes)
            == 2 * 1000 * sector)
    assert (jax_roofline.sampled_bytes_model([1000], feat, 7, dtype_bytes)
            == 2 * 1000 * lanes)


def test_serving_pass_per_edge_reading_exceeds_the_peak():
    """The module docstring's example: a GCN f32 serving pass (F = 128 +
    41) reads as more than the card's HBM can give under a row an edge."""
    sector = roofline.spmm_bytes_model(E, V, [128, 41], 4)
    lanes = roofline.lane_padded_spmm_bytes_model(E, V, [128, 41], 4)
    assert sector == (E * 512 + V * 512) + (E * 192 + V * 192)
    assert sector == 8_527_536_512
    assert lanes == jax_roofline.spmm_bytes_model(E, V, [128, 41], 4)
    assert lanes == 12_403_689_472
    pct = roofline.stage_roofline(2.264e-3, 2 * E, sector)["pct_hbm_peak"]
    pct_lanes = roofline.stage_roofline(2.264e-3, 2 * E, lanes)[
        "pct_hbm_peak"]
    assert 112 < pct < 113 and 163 < pct_lanes < 164


# ---- (c) stage_roofline is JAX's under JAX's constants -------------------
@pytest.mark.parametrize("seconds, edges, model_bytes, row_ops", [
    (2.264e-3, 2 * E, 8_527_536_512, 2.0),
    (9.357e-3, 2 * E, 3 * 8_527_536_512, 3.0),
    (0.2917, 4_123_456, 7_654_321_000, 2.0),
    (1.5, 10, 12_345, 1.0),
    (0.0, 10, 100, 2.0),
    (1.0, 0, 100, 2.0)])
def test_stage_roofline_equals_jax_under_jax_constants(
        monkeypatch, seconds, edges, model_bytes, row_ops):
    monkeypatch.setattr(roofline, "HBM_PEAK_GB_S",
                        jax_roofline.HBM_PEAK_GB_S)
    monkeypatch.setattr(roofline, "ROW_ACCESS_FLOOR_NS",
                        jax_roofline.ROW_ACCESS_FLOOR_NS)
    got = roofline.stage_roofline(seconds, edges, model_bytes, row_ops)
    want = jax_roofline.stage_roofline(seconds, edges, model_bytes, row_ops)
    assert got == want
    assert list(got) == list(want)


def test_constants_are_the_cards():
    assert roofline.HBM_PEAK_GB_S == 3350.0
    assert roofline.hbm_bytes_per_s(H100) == 3.35e12
    assert roofline.hbm_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12
    assert roofline.hbm_bytes_per_s("NVIDIA H100 NVL") == 3.9e12
    assert roofline.F32_FLOPS_PER_S == 67e12
    assert roofline.HBM_PEAK_GB_S != jax_roofline.HBM_PEAK_GB_S
    assert 0 < roofline.ROW_ACCESS_FLOOR_NS < 1.0
    assert roofline.ROW_ACCESS_FLOOR_NS != jax_roofline.ROW_ACCESS_FLOOR_NS
    with pytest.raises(ValueError, match="no HBM bandwidth"):
        roofline.hbm_bytes_per_s("Tesla V100")
    with pytest.raises(ValueError, match="unknown kernel"):
        roofline.kernel_bound("k9", H100, V=1, E=1, F=1)


# ---- (d) kernel_bound at PERF.md §6's shapes ------------------------------
def _bound(kernel, dtype_bytes=4, **shape):
    return roofline.kernel_bound(kernel, H100, dtype_bytes, **shape)


def _k1_layers():
    # (D, K, S, F): one training step's two layers (602-128-41, 25-10,
    # batch 10000); nnz at most D·K, the bound is the bytes'
    return [dict(D=233_088, K=10, S=V_PAD, F=128, nnz=233_088 * 10),
            dict(D=10_112, K=25, S=V_PAD, F=41, nnz=10_112 * 25)]


@pytest.mark.parametrize("kernel", ["k1_fwd", "k1_dx", "k1_dw"])
def test_kernel_bound_k1(kernel):
    rows = [_bound(kernel, **s) for s in _k1_layers()]
    assert all(r["bound_by"] == "bytes" for r in rows)
    assert round(sum(r["bound_ms"] for r in rows), 4) == 0.0893
    s = _k1_layers()[0]
    assert rows[0]["bytes_once"] == (s["D"] * s["K"] * 8 + s["S"] * 128 * 4
                                     + s["D"] * 128 * 4)


def test_kernel_bound_k1_transpose():
    got = _bound("k1_transpose", D=233_088, K=10, S=V_PAD)
    assert got["bytes_once"] == 233_088 * 10 * 16 + 8 * (V_PAD + 1)
    assert got["operations"] == 0 and got["bound_by"] == "bytes"


@pytest.mark.parametrize("kernel", ["k2_fwd", "k2_bwd"])
def test_kernel_bound_k2(kernel):
    f128, f41 = (_bound(kernel, V=V, E=E, F=f) for f in (128, 41))
    assert (round(f128["bound_ms"], 4), round(f41["bound_ms"], 4)) == (
        0.1001, 0.0517)
    assert round(f128["bound_ms"] + f41["bound_ms"], 4) == 0.1519
    assert f128["bytes_once"] == E * 8 + 8 * (V + 1) + 2 * V * 128 * 4
    # a row gather reads a row an edge: 1.88 ms at F = 128
    assert round(f128["gather_bound_ms"], 2) == 1.88


def test_kernel_bound_k2_pushdown():
    got = _bound("k2_pushdown", C=23_296, V=V_PAD, E=1_136_495, F=602)
    assert round(got["bound_ms"], 4) == 0.1871
    assert got["bytes_once"] == (1_136_495 * 8 + 8 * 23_297
                                 + (V_PAD + 23_296) * 602 * 4)
    assert round(got["gather_bound_ms"], 3) == 0.836


def test_kernel_bound_k3():
    # one single-head f32 GAT pass: F = 128 + 41
    rows = [_bound("k3", V=V, E=E, F=f, H=1) for f in (128, 41)]
    assert round(sum(r["bound_ms"] for r in rows), 4) == 0.1252
    assert rows[0]["bytes_once"] == (V * 128 * 8 + 12 * V + 8 * (V + 1)
                                     + 4 * E)


@pytest.mark.parametrize("kernel, want", [("b1", (0.1260, 0.0501)),
                                          ("b2", (0.0904, 0.0387))])
def test_kernel_bound_k4(kernel, want):
    # one GATFULLBATCH heads-4 epoch's backward: F=128 H=4 + F=41 H=1
    rows = [_bound(kernel, V=V, E=E, F=128, H=4),
            _bound(kernel, V=V, E=E, F=41, H=1)]
    assert tuple(round(r["bound_ms"], 4) for r in rows) == want
    assert all(r["bound_by"] == "bytes" for r in rows)
    b = 4 + (8 if kernel == "b1" else 4)
    assert rows[1]["bytes_once"] == (V * 41 * b + 16 * V + 8 * (V + 1)
                                     + 4 * E)
    assert rows[0]["operations"] == ((4 if kernel == "b1" else 2) * E * 128
                                     + 10 * E * 4)


@pytest.mark.parametrize("kernel, want", [("gat_sampled_fwd", 0.1038),
                                          ("gat_sampled_bwd", 0.1537)])
def test_kernel_bound_gat_sampled(kernel, want):
    # one GATSAMPLEALLGPU heads-4 step's two layers (602-128-41, 25-10,
    # batch 10000): K1's (D, K, S) with F=128 H=4 and F=41 H=1; nnz at
    # most D·K, the bound is the bytes'
    rows = [_bound(kernel, H=h, **s) for s, h in zip(_k1_layers(), (4, 1))]
    assert all(r["bound_by"] == "bytes" for r in rows)
    assert round(sum(r["bound_ms"] for r in rows), 4) == want
    d, k = 233_088, 10
    fixed = d * k * 8 + d * 4 + 2 * V_PAD * 4 * 4 + d * k * 4 * 4
    rows_f = V_PAD * 128 * 4 + d * 128 * 4
    assert rows[0]["bytes_once"] == (
        fixed + rows_f if kernel == "gat_sampled_fwd"
        else fixed + rows_f + V_PAD * 128 * 4 + 2 * V_PAD * 4 * 4)


# the distinct table rows gather_inputs(0, T) draws (np.unique of its 2^20
# indices; T = 2048 is checked below, the larger tables' draws are past
# 29.8 M and 537 M normals)
GATHER_ROWS_READ = {2048: 2048, 232_965: 230_335, 1 << 22: 927_002}


def test_gather_rows_read_of_the_small_table():
    _, idx = pr.gather_inputs(0, 2048)
    assert np.unique(idx).size == GATHER_ROWS_READ[2048]


def test_kernel_bound_probes():
    tiles = pr.GATHER_EDGES // pr.GATHER_TILE
    # P-G: shared and device memory at T = 2048, then 232,965 and 2^22
    pg = [_bound("p_g", rows_read=GATHER_ROWS_READ[t], E=pr.GATHER_EDGES,
                 F=pr.PROBE_F, tiles=tiles)
          for t in (2048, 2048, 232_965, 1 << 22)]
    assert [round(r["bound_ms"], 4) for r in pg] == [0.0020, 0.0020,
                                                     0.0365, 0.1430]
    assert [r["bound_by"] for r in pg] == ["operations"] * 2 + ["bytes"] * 2
    assert round(sum(r["bound_ms"] for r in pg), 4) == 0.1835
    # P-S: the nine shapes
    ps = [_bound("p_s", m=m, n=n) for (m, n), _ in pr.SHUFFLE_SHAPES]
    assert round(sum(r["bound_ms"] for r in ps), 4) == 0.0021
    # P-T configuration 0, and the slab row an edge beside it
    s_blk, d_blk, e_t, e_sub, _ = pr.TILE_CONFIGS["0"]
    e_n = pr.TILE_STEPS * e_t
    pt = _bound("p_t", 2, slab_rows=s_blk, F=pr.PROBE_F, E=e_n,
                windows=pr.TILE_STEPS * (e_t // e_sub), out_rows=d_blk)
    assert round(pt["bound_ms"], 4) == 0.0045
    assert round(pt["gather_bound_ms"], 4) == 0.0846
    assert pt["gather_bytes"] - pt["bytes_once"] == e_n * pr.PROBE_F * 2
    # P-A: 4096 tiles; every tile's GAT_LIVE live edges are in range
    live = pr.GAT_LIVE * pr.GAT_TILES
    pa = _bound("p_a", 2, tiles=pr.GAT_TILES, S=pr.GAT_S_BLK, W=pr.GAT_W,
                E=pr.GAT_E, F=pr.PROBE_F, cols=pr.GAT_TABLE_COLS,
                live_dst=live, live_both=live)
    assert round(pa["bound_ms"], 4) == 0.1778


def test_p_a_live_edges_per_tile():
    t = pr.gat_tile_inputs(0, n_tiles=2)
    live_d = int((t["dst"] < pr.GAT_W).sum())
    live_both = int(((t["dst"] < pr.GAT_W) & (t["src"] < pr.GAT_S_BLK))
                    .sum())
    assert live_d == live_both == 2 * pr.GAT_LIVE


@pytest.mark.parametrize("dst, weighted", [(True, True), (True, False),
                                           (False, False)])
def test_kernel_bound_p_t_parts(dst, weighted):
    # the bisect cases at 8192 edges (4 steps of 2048)
    e_n = pr.PART_STEPS * pr.PART_E_T
    got = _bound("p_t", 2, slab_rows=pr.PART_S_BLK, F=pr.PROBE_F, E=e_n,
                 windows=pr.PART_STEPS, out_rows=pr.PART_D_BLK, dst=dst,
                 weighted=weighted)
    assert got["bytes_once"] == (pr.PART_S_BLK * pr.PROBE_F * 2 + e_n * 4
                                 + (e_n * 4 if dst else 0)
                                 + (e_n * 2 if weighted else 0)
                                 + pr.PART_STEPS * 4
                                 + pr.PART_D_BLK * pr.PROBE_F * 4)
    assert got["operations"] == e_n * pr.PROBE_F * (2 if weighted else 1)
    c1 = _bound("p_t_gather", 2, slab_rows=pr.PART_S_BLK, F=pr.PROBE_F,
                E=e_n)
    assert c1["operations"] == 0 and c1["bytes_once"] == (
        pr.PART_S_BLK * pr.PROBE_F * 2 + e_n * 4 + e_n * pr.PROBE_F * 4)


# ---- (e) the once model is the lower bound of the per-edge one ------------
@pytest.mark.parametrize("dtype_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("stage", ["serving", "whole_graph_epoch"])
def test_bytes_once_below_the_per_edge_model(stage, dtype_bytes):
    widths = [128, 41]
    if stage == "serving":
        once = sum(_bound("k2_fwd", dtype_bytes, V=V, E=E, F=f)["bytes_once"]
                   for f in widths)
        per_edge = roofline.spmm_bytes_model(E, V, widths, dtype_bytes)
    else:
        # the forward and the backward (K2 over the transposed CSR) of
        # each layer, against the model's backward=True count
        once = sum(_bound(k, dtype_bytes, V=V, E=E, F=f)["bytes_once"]
                   for f in widths for k in ("k2_fwd", "k2_bwd"))
        per_edge = roofline.spmm_bytes_model(E, V, widths, dtype_bytes,
                                             backward=True)
    assert 0 < once <= per_edge
    # and so the bound's time is below the per-edge model's at the peak
    assert once / roofline.hbm_bytes_per_s(H100) <= (
        per_edge / (roofline.HBM_PEAK_GB_S * 1e9))
