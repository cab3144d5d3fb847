"""The frozen bounds and FLOP counts: hand counts at the cells' shapes,
the port's `utils/roofline.kernel_bound` at PERF.md section 6's shapes,
and the properties that keep every share at or under 100%."""

from __future__ import annotations

import pytest

from benchmark import bounds, peaks, spec
from sgnn_tpu_torch.utils import roofline

H100 = "NVIDIA H100 80GB HBM3"
V, E = 232_965, 11_880_013          # the Reddit-shaped graph with self-loops


def test_k2_hand_count_at_the_whole_graph_shape():
    once, ops = bounds.k2(4, V, E, 128)
    assert once == E * 8 + 8 * (V + 1) + 2 * V * 128 * 4 == 335_459_992
    assert ops == 2 * E * 128
    per_pass = (bounds.bound_s(bounds.k2(4, V, E, 128), H100)
                + bounds.bound_s(bounds.k2(4, V, E, 41), H100))
    assert per_pass * 1e3 == pytest.approx(0.1519, abs=5e-5)   # PERF.md 6


@pytest.mark.parametrize("kernel,shape,ours", [
    ("k1_fwd", dict(D=233_088, K=10, S=233_088, F=128, nnz=1_500_000),
     lambda s: bounds.k1_fwd(4, **s)),
    ("k1_dx", dict(D=10_112, K=25, S=233_088, F=41, nnz=200_000),
     lambda s: bounds.k1_fwd(4, **s)),
    ("k1_transpose", dict(D=233_088, K=10, S=233_088),
     lambda s: bounds.k1_transpose(**s)),
    ("k2_fwd", dict(V=V, E=E, F=41), lambda s: bounds.k2(4, **s)),
    ("k2_bwd", dict(V=V, E=E, F=128), lambda s: bounds.k2(4, **s)),
    ("k3", dict(V=V, E=E, F=128, H=4), lambda s: bounds.k3(4, **s)),
    ("b1", dict(V=V, E=E, F=41, H=1), lambda s: bounds.b1(4, **s)),
    ("b2", dict(V=V, E=E, F=128, H=4), lambda s: bounds.b2(4, **s)),
    ("gat_sampled_fwd", dict(D=233_088, K=10, S=233_088, F=128, H=4,
                             nnz=1_900_000),
     lambda s: bounds.gat_sampled(4, **s, backward=False)),
    ("gat_sampled_bwd", dict(D=233_088, K=10, S=233_088, F=128, H=4,
                             nnz=1_900_000),
     lambda s: bounds.gat_sampled(4, **s, backward=True)),
    ("gat_sampled_fwd", dict(D=10_112, K=25, S=233_088, F=41, H=1,
                             nnz=240_000),
     lambda s: bounds.gat_sampled(4, **s, backward=False)),
    ("gat_sampled_bwd", dict(D=10_112, K=25, S=233_088, F=41, H=1,
                             nnz=240_000),
     lambda s: bounds.gat_sampled(4, **s, backward=True)),
])
def test_frozen_formulas_equal_the_ports_kernel_bound(kernel, shape, ours):
    got = roofline.kernel_bound(kernel, H100, 4, **shape)
    once, ops = ours(shape)
    assert (once, ops) == (got["bytes_once"], got["operations"])
    assert bounds.bound_s((once, ops), H100) * 1e3 == pytest.approx(
        got["bound_ms"])


def test_bytes_once_never_exceed_a_row_an_edge():
    """Each input row counts once, so the bound is no larger than a
    gather's, which reads a source row an edge."""
    for F in (41, 128):
        got = roofline.kernel_bound("k2_fwd", H100, 4, V=V, E=E, F=F)
        assert got["bytes_once"] <= got["gather_bytes"]


def test_gcn_fullgraph_epoch_flops_hand_count():
    # layer 0 (602 -> 128) transform first: forward x@W and the sum,
    # backward the sum's transpose and dW; layer 1 (128 -> 41) the same
    # and its input's gradient
    l0 = 4 * V * 602 * 128 + 4 * E * 128
    l1 = 6 * V * 128 * 41 + 4 * E * 41
    gnn = spec.reference_module("gnn")
    got = gnn.epoch_flops({"family": "gcn", "layer_sizes": [602, 128, 41]},
                          V, E)
    assert got == l0 + l1
    assert got / 1e9 == pytest.approx(87.17, abs=0.01)


def test_required_flops_take_the_cheaper_order():
    nnz, dv, sv = 1_100_000, 110_000, 230_000
    agg_first = (2 * nnz * 602 + 2 * dv * 602 * 128) + 2 * dv * 602 * 128
    assert bounds.gcn_layer_flops(nnz, dv, sv, 602, 128, False) == min(
        agg_first, 4 * sv * 602 * 128 + 4 * nnz * 128)
    assert bounds.gcn_layer_flops(nnz, dv, sv, 602, 128, False) == agg_first


def test_gat_flops_hand_count():
    nnz, dv, sv, fin, fout = 1000, 50, 80, 16, 8
    fwd = 2 * sv * fin * fout + 4 * sv * fout + 2 * nnz * fout
    bwd = 4 * nnz * fout + 8 * sv * fout + 2 * sv * fin * fout
    assert bounds.gat_layer_flops(nnz, dv, sv, fin, fout, False) == fwd + bwd
    assert bounds.gat_layer_flops(nnz, dv, sv, fin, fout, True) == (
        fwd + bwd + 2 * sv * fin * fout)


def test_mfu_uses_the_published_float32_peak():
    assert peaks.flops_peak(H100, "float32", False) == 67e12
    assert peaks.flops_peak(H100, "float32", True) == 495e12
    assert peaks.peaks_for(H100)["hbm_bytes_per_s"] == 3.35e12
    assert peaks.peaks_for("NVIDIA H100 PCIe")["hbm_bytes_per_s"] == 2.0e12
    with pytest.raises(ValueError):
        peaks.peaks_for("cpu")


def test_group_bounds_sum_each_launch():
    shapes = {"layers": 2, "V": V, "E": E, "forwards": 2, "F0": 128,
              "F1": 41, "H0": 4, "H1": 1}
    k2 = bounds.kernel_bounds_per_step("spmm", H100, 4, shapes)
    assert k2 == pytest.approx(3 * (bounds.bound_s(bounds.k2(4, V, E, 128),
                                                   H100)
                                    + bounds.bound_s(bounds.k2(4, V, E, 41),
                                                     H100)))
    gat_bwd = bounds.kernel_bounds_per_step("gat_bwd", H100, 4, shapes)
    assert gat_bwd * 1e3 == pytest.approx(0.1761 + 0.1291, abs=2e-4)
