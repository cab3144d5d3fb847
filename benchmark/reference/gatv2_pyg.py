"""Plain PyTorch reference of PyG's ogbn-products GAT with GATv2Conv
layers, trained on sampled neighbourhoods: the forward, the NLL loss, the
gradients and torch's Adam.

The model is PyG's `examples/ogbn_products_gat.py` (`GAT(100, 128, 47,
num_layers=3, heads=4)`, three layers with `Lin` skips) with each
`GATConv` replaced by `GATv2Conv` (Brody, Alon & Yahav, "How Attentive
are Graph Attention Networks?", ICLR 2022, arXiv:2105.14491, eq. (7);
`share_weights=False`, `add_self_loops=True`, `bias=True`, attention
dropout 0).  Layer l, over the edges s -> d of its sampled neighbourhood,
for each destination d, head h and column c of the head:

    xl     = x · WL_l + bL_l, viewed [rows, H, C]   (`lin_l`, the sources)
    xr     = x[d] · WR_l + bR_l, viewed [D, H, C]   (`lin_r`, the
             destinations' own rows)
    e(s,d) = Σ_c att_l[h, c] · leaky_relu(xl[s,h,c] + xr[d,h,c], 0.2)
    alpha  = softmax of e over N(d) ∪ {d}: `remove_self_loops` then
             `add_self_loops`, so d attends to itself exactly once
    out[d, h] = sum over s of alpha(s, d) · xl[s, h]

then gat_pyg.py's epilogue: the heads concatenated on hidden layers (4 x
128 = 512) and averaged on the last (4 x 47 -> 47); + the layer's bias
b_l; + the skip x[d] · S_l + c_l; hidden layers ELU and dropout 0.5; the
last log_softmax, and the mean NLL over the batch.  Training is
`torch.optim.Adam(lr=0.001)` with torch's defaults (betas 0.9 and 0.999,
eps 1e-8, bias correction, no weight decay).

Departures from the example are gat_pyg.py's, each shared with the
program it checks: the neighbourhoods, the initial parameters (every leaf
drawn uniform with its fans, where PyG zeroes the biases and glorot-draws
att) and dropout's keep masks are the caller's; no learning-rate
schedule.

Inputs are gat_pyg.py's (global vertex ids, `layer_edges`).  The
parameters are 24 leaves in the program's flat order: W_0..W_2 [in, H·C]
(lin_l), att_0..att_2 [H·C, 1] (head-major), b_0..b_2, S_0..S_2 [in,
out], c_0..c_2, then bL_0..bL_2 [H·C], WR_0..WR_2 [in, H·C] (lin_r),
bR_0..bR_2 [H·C].

The model's side, `forward` to `adam_steps`, is plain torch: no package
of this repository, no kernel.  Float64 or float32; TF32 is switched off,
so a float32 product is a float32 one.  The per-edge vectors [E, H, C]
are made EDGE_CHUNK edges at a time and recomputed in the backward pass.

What the harness calls, as it calls benchmark/reference/gnn.py's, is in
the section at the end: `leaves`, `step_flops`, `epoch_flops`,
`kernel_layers`, `reads_own_rows`, `degrees`, `check_sample`,
`sampled_edges` and `train_steps`; and for the roofline reading of the
kernel pair (`metrics/ops.gatv2_sampled.roofline_pct.py`) its frozen
bytes-once and operation counts, `pair_work`.  Precision "float64"
computes in float64; "tf32" in float32 with every dense product's
operands rounded to TF32 (gnn.py's `make_matmul`): the control that the
float32 configuration with TF32 off must fail.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint


def _sibling(name: str):
    """Another reference module beside this file, loaded by its path."""
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_reference_{name}_of_gatv2_pyg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the GCN and GAT reference (sample check, degrees, precisions) and PyG's
# GATConv stack (edges, softmax, weighted sum, loss, widths)
_gnn = _sibling("gnn")
_gat = _sibling("gat_pyg")

NEG_SLOPE = _gat.NEG_SLOPE
# edges a piece of a layer's per-edge vectors, recomputed in the backward
EDGE_CHUNK = 1 << 18
# weights, att, biases, skip weights, skip biases, source biases,
# destination weights, destination biases
GROUPS = 8

layer_edges = _gat.layer_edges
nll = _gat.nll


def _scores_piece(xl, xr, att, src, dst):
    u = xl.index_select(0, src) + xr.index_select(0, dst)     # [E, H, C]
    return (torch.nn.functional.leaky_relu(u, NEG_SLOPE) * att).sum(-1)


def scores(xl: torch.Tensor, xr: torch.Tensor, att: torch.Tensor,
           src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """e [E, H] of the edges src -> dst, xl [rows, H, C], xr [D, H, C],
    att [H, C], in pieces of EDGE_CHUNK edges."""
    out = []
    for lo in range(0, src.numel(), EDGE_CHUNK):
        args = (xl, xr, att, src[lo:lo + EDGE_CHUNK], dst[lo:lo + EDGE_CHUNK])
        out.append(checkpoint(_scores_piece, *args, use_reentrant=False)
                   if torch.is_grad_enabled() else _scores_piece(*args))
    if not out:
        return xl.new_zeros((0, xl.shape[1]))
    return torch.cat(out)


def forward(params: Sequence[torch.Tensor], x: torch.Tensor,
            edges: Sequence, masks: Sequence[Optional[torch.Tensor]],
            heads: int, drop_rate: float,
            mm: Callable = torch.matmul) -> torch.Tensor:
    """Log-probs of the last layer's destinations.  `x` the feature rows
    by global id, `edges` gat_pyg.py's `layer_edges`, `masks[l]` hidden
    layer l's dropout keep mask (or None), `mm` the dense product."""
    n = len(params) // GROUPS
    w, a, b, s, c, bl, wr, br = (params[g * n:(g + 1) * n]
                                 for g in range(GROUPS))
    h = x.index_select(0, edges[0].x_rows).to(w[0].dtype)
    for l, e in enumerate(edges):
        last = l == n - 1
        f = w[l].shape[1]
        xl = (mm(h, w[l]) + bl[l]).view(-1, heads, f // heads)
        h_dst = h[e.own]
        xr = (mm(h_dst, wr[l]) + br[l]).view(-1, heads, f // heads)
        score = scores(xl, xr, a[l][:, 0].view(heads, -1), e.src, e.dst)
        alpha = _gat.edge_softmax(score, e.dst, e.num_dst)
        agg = _gat.weighted_sum(xl, alpha, e.src, e.dst, e.num_dst)
        agg = agg.mean(dim=1) if last else agg.reshape(e.num_dst, f)
        out = agg + b[l] + mm(h_dst, s[l]) + c[l]
        if last:
            return torch.log_softmax(out, dim=-1)
        out = torch.nn.functional.elu(out)
        mask = masks[l] if l < len(masks) else None
        if mask is not None:
            out = torch.where(mask, out / (1.0 - drop_rate),
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device))
        h = out
    raise ValueError("no layers")


def adam_steps(p0: Sequence[torch.Tensor], steps: Sequence[dict],
               heads: int, drop_rate: float, lr: float,
               betas=(0.9, 0.999), eps: float = 1e-8,
               dtype: torch.dtype = torch.float64, mm: Callable = None,
               half_batch: bool = False, frozen: bool = False) -> dict:
    """Follow training steps from the leaves `p0` with torch's Adam, as
    gat_pyg.py's `adam_steps` (the same inputs, faults and returns)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = mm or torch.matmul
    cur = [t.detach().to(dtype).clone().requires_grad_() for t in p0]
    opt = torch.optim.Adam(cur, lr=lr, betas=tuple(betas), eps=eps)
    losses, grad1, params1 = [], None, None
    for i, inp in enumerate(steps):
        opt.zero_grad(set_to_none=True)
        logp = forward(cur, inp["x"], inp["edges"], inp["masks"], heads,
                       drop_rate, mm)
        rows = inp["rows"]
        if half_batch:
            rows = rows[: max(rows.numel() // 2, 1)]
        loss = nll(logp, inp["labels"], rows)
        loss.backward()
        if i == 0:
            grad1 = [p.grad.detach().clone() * (0.0 if frozen else 1.0)
                     for p in cur]
        if not frozen:
            opt.step()
        if i == 0:
            params1 = [p.detach().clone() for p in cur]
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": grad1, "params1": params1,
            "params": [p.detach().clone() for p in cur]}


# ------------------------------------------------------ the harness's side
degrees = _gnn.degrees
check_sample = _gnn.check_sample
kernel_layers = _gat.kernel_layers
reads_own_rows = _gat.reads_own_rows
sampled_edges = _gat.sampled_edges
_widths = _gat._widths


def leaves(cfg) -> List[tuple]:
    """The 24 leaves in the program's flat order, as (name, shape, draw):
    gat_pyg.py's 15 with att_l [H·C, 1] (fans H·C and 1) in place of its
    [2·H·C, 1], then bL_l [H·C], WR_l [in, H·C] and bR_l [H·C], each
    uniform with the fans of its transform (in, H·C)."""
    w, n, cols = cfg["layer_sizes"], len(cfg["layer_sizes"]) - 1, _widths(cfg)
    out = _gat.leaves(cfg)
    out[n:2 * n] = [(f"att{l}", (cols[l], 1), ("uniform", cols[l], 1))
                    for l in range(n)]
    out += [(f"bL{l}", (cols[l],), ("uniform", w[l], cols[l]))
            for l in range(n)]
    out += [(f"WR{l}", (w[l], cols[l]), ("uniform", w[l], cols[l]))
            for l in range(n)]
    out += [(f"bR{l}", (cols[l],), ("uniform", w[l], cols[l]))
            for l in range(n)]
    return out


def step_flops(cfg, layers) -> int:
    """Required FLOPs of one step, `layers` one (nnz, dv, sv) per layer,
    bottom first, F = H·C W's columns, fin the layer's input width, out
    its output width:
      - the transforms: lin_l over the sv rows read (sources and the
        destinations' own rows) and lin_r over the dv destinations, 2
        (sv + dv) fin F forward, as much for dWL and dWR, and above the
        bottom layer as much again for the input's gradient;
      - the per-edge vectors, over the nnz kept sampled edges (the self
        edges, which replace the masked sampled self-loops, are left
        out): forward 6 nnz F (u's add, leaky_relu, att's product and
        sum, the weighted sum's multiply-add), backward 10 nnz F (the
        weighted sum's two gradients 4, u's gradient through leaky_relu
        and att 2, its adds into dxl and dxr 2, att's gradient 2);
      - the skip over the dv destinations: forward, dS and, above the
        bottom layer, the input's gradient, 2 dv fin out each.
    Softmax, biases, activations, dropout, the loss and the optimizer are
    elementwise and not counted: a lower bound of the work."""
    w, cols = cfg["layer_sizes"], _widths(cfg)
    total = 0
    for l, (nnz, dv, sv) in enumerate(layers):
        passes = 3 if l > 0 else 2
        total += passes * 2 * (sv + dv) * w[l] * cols[l]
        total += 16 * nnz * cols[l]
        total += passes * 2 * dv * w[l] * w[l + 1]
    return total


def epoch_flops(cfg, num_vertices: int, num_edges: int) -> int:
    """A whole-graph epoch's FLOPs: every vertex a destination and a
    source, every edge kept."""
    return step_flops(cfg, [(num_edges, num_vertices, num_vertices)]
                      * (len(cfg["layer_sizes"]) - 1))


def pair_work(D: int, K: int, S: int, F: int, H: int, nnz: int, dv: int,
              sv: int, backward: bool) -> tuple:
    """(bytes once, operations) of the GATv2 kernel pair
    (`csrc/gatv2_sampled.cu`) over one layer's block: D destinations of K
    sampled slots and the own row's, S source rows of which sv are read,
    dv valid destinations, nnz kept sampled slots, F = H·C columns, f32.
    Each input read once and each output written once:
      forward: nbr and w [D, K + 1]; xl's sv rows, xr's dv rows, att;
        out [D, F] and alpha [D, K + 1, H] written;
        6 operations a (kept sampled slot, column), step_flops' count;
      backward: nbr and w, alpha; G's and xr's dv rows, xl's sv rows,
        att; dxl [S, F], dxr [D, F] and att's gradient written;
        10 operations a (kept sampled slot, column).
    The own-row slots' work is left out of the operations, as
    step_flops leaves it: a lower bound, so the share cannot pass 100%."""
    slots = D * (K + 1)
    rows_in = 4 * F * (sv + dv) + 4 * F
    if not backward:
        return (slots * 8 + rows_in + 4 * D * F + 4 * slots * H,
                6 * nnz * F)
    return (slots * 8 + 4 * slots * H + rows_in + 4 * dv * F
            + 4 * (S + D) * F + 4 * F, 10 * nnz * F)


def train_steps(cfg: dict, bias_correction: bool, p0: Sequence[torch.Tensor],
                step_inputs: List[dict], precision: str = "float64",
                half_batch: bool = False, frozen: bool = False) -> dict:
    """The harness's call: the steps of torch's Adam (bias-corrected, as
    the configuration's engine; weight decay none) from the leaves `p0`
    in `precision`."""
    if not bias_correction or cfg["weight_decay"] != 0:
        raise ValueError("gatv2_pyg trains with torch's Adam: bias "
                         "correction on, no weight decay")
    adam = cfg["adam"]
    return adam_steps(
        p0, step_inputs, int(cfg["heads"]), float(cfg["drop_rate"]),
        float(cfg["learn_rate"]), (adam["beta1"], adam["beta2"]),
        adam["epsilon"], _gnn.dtype_of(precision),
        _gnn.make_matmul(precision), half_batch, frozen)
