"""Plain PyTorch reference of PyG's ogbn-products GAT, trained on sampled
neighbourhoods: the forward, the NLL loss, the gradients and torch's Adam.

The model is PyG's `examples/ogbn_products_gat.py` (OGB leaderboard entry
"GAT (NeighborSampling)"): `GAT(100, 128, 47, num_layers=3, heads=4)`,
three `GATConv` layers with `Lin` skips.  Layer l, over the edges s -> d
of its sampled neighbourhood, for each destination d and head h:

    t      = x · W_l, viewed [rows, H, C]  (GATConv's one `lin`, shared by
             sources and destinations)
    e(s,d) = leaky_relu(<a_src[h], t[s, h]> + <a_dst[h], t[d, h]>, 0.2)
    alpha  = softmax of e over N(d) ∪ {d}: GATConv's `remove_self_loops`
             then `add_self_loops`, so d attends to itself exactly once
    out[d, h] = sum over s of alpha(s, d) · t[s, h]

then the heads concatenated on hidden layers (4 x 128 = 512) and averaged
on the last (4 x 47 -> 47); + the layer's bias b_l; + the skip x[d] · S_l
+ c_l (`Lin(100, 512)`, `Lin(512, 512)`, `Lin(512, 47)`); hidden layers
ELU and dropout 0.5; the last log_softmax, and the mean NLL over the
batch.  Training is `torch.optim.Adam(lr=0.001)` with torch's defaults
(betas 0.9 and 0.999, eps 1e-8, bias correction, no weight decay).

Departures from the example, each shared with the program it checks:
  - the neighbourhoods are the caller's: the port's sampler draws 10
    slots a destination with replacement and masks repeats, where PyG's
    NeighborSampler draws without replacement;
  - the initial parameters are the caller's (the benchmark draws every
    leaf uniform with its fans, biases too, where PyG zeroes GATConv's);
  - dropout's keep masks are the caller's (the program's draws);
  - no learning-rate schedule (the example has none either).

Inputs are global vertex ids: each layer (bottom first) is {"dst": [D]
ids, "nbr": [D, K] ids with -1 on an empty slot}, the last layer's
destinations the batch.  The parameters are 15 leaves in the program's
flat order: W_0..W_2 [in, H·C], a_0..a_2 [2·H·C, 1] (the source half
first, head-major), b_0..b_2, S_0..S_2 [in, out], c_0..c_2.

The model's side, `NEG_SLOPE` to `adam_steps`, is plain torch: no
package of this repository, no kernel.  Float64 or float32; TF32 is
switched off, so a float32 product is a float32 one.

What the harness calls, as it calls benchmark/reference/gnn.py's, is in
the section at the end: `leaves`, `step_flops`, `epoch_flops`,
`kernel_layers`, `reads_own_rows`, `degrees` and `check_sample` (gnn.py's,
loaded from the file beside this one), `sampled_edges` and `train_steps`
(the harness's signature over `adam_steps`).  Precision "float64"
computes in float64; "tf32" in float32 with every dense product's operands
rounded to TF32 (gnn.py's `make_matmul`): the control that the float32
configuration with TF32 off must fail.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from benchmark import bounds


def _sibling(name: str):
    """Another reference module beside this file, loaded by its path."""
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_reference_{name}_of_gat_pyg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the GCN and GAT reference: its sample check, degrees and precisions
_gnn = _sibling("gnn")

NEG_SLOPE = 0.2
# edges a piece of a layer's weighted sum, recomputed in the backward pass
EDGE_CHUNK = 1 << 20
GROUPS = 5   # weights, attention vectors, biases, skip weights, skip biases


class Layer(NamedTuple):
    """One layer's edges in row space: `src` rows of the layer's input,
    `dst` destinations 0..num_dst-1, `own` each destination's own input
    row; `x_rows` (layer 0 only) the global ids of the input rows."""

    src: torch.Tensor
    dst: torch.Tensor
    num_dst: int
    own: torch.Tensor
    x_rows: Optional[torch.Tensor] = None


def _positions(ids: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Where each of `query` sits in `ids` (distinct ids, all present)."""
    sorted_ids, order = torch.sort(ids)
    return order[torch.searchsorted(sorted_ids, query)]


def layer_edges(layers: Sequence[dict]) -> List[Layer]:
    """Row-space edges of the sampled layers under GATConv's self-loop
    rule: the kept slots (nbr >= 0) whose source is not the destination,
    then one self edge a destination.  Layer 0's input rows are the
    distinct ids of its sources and destinations, layer l's the
    destinations of layer l - 1."""
    out: List[Layer] = []
    for l, layer in enumerate(layers):
        d, nbr = layer["dst"].long(), layer["nbr"].long()
        num_dst = d.numel()
        keep = (nbr >= 0) & (nbr != d[:, None])
        dst_index = torch.arange(num_dst, device=d.device)[:, None].expand_as(
            nbr)[keep]
        src_ids = nbr[keep]
        x_rows = None
        if l == 0:
            x_rows = torch.unique(torch.cat([src_ids, d]))
            rows = x_rows
        else:
            rows = layers[l - 1]["dst"].long()
        own = _positions(rows, d)
        src = torch.cat([_positions(rows, src_ids), own])
        dst = torch.cat([dst_index, torch.arange(num_dst, device=d.device)])
        out.append(Layer(src, dst, num_dst, own, x_rows))
    return out


def edge_softmax(score: torch.Tensor, dst: torch.Tensor,
                 num_dst: int) -> torch.Tensor:
    """Softmax of the [E, H] scores over the edges into each destination
    (max-shifted, the max held constant)."""
    heads = score.shape[1]
    mx = torch.full((num_dst, heads), float("-inf"), dtype=score.dtype,
                    device=score.device)
    mx = mx.scatter_reduce(0, dst[:, None].expand(-1, heads), score, "amax")
    e = torch.exp(score - mx.detach()[dst])
    z = torch.zeros((num_dst, heads), dtype=score.dtype,
                    device=score.device).index_add(0, dst, e)
    return e / z[dst]


def _weighted_sum_piece(t, alpha, src, dst, num_dst):
    msg = t.index_select(0, src) * alpha[:, :, None]
    out = torch.zeros((num_dst,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    return out.index_add(0, dst, msg)


def weighted_sum(t: torch.Tensor, alpha: torch.Tensor, src: torch.Tensor,
                 dst: torch.Tensor, num_dst: int) -> torch.Tensor:
    """out[d, h] = sum over edges into d of alpha[e, h] · t[src_e, h], for
    t [rows, H, C], in pieces of EDGE_CHUNK edges."""
    out = torch.zeros((num_dst,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    for lo in range(0, src.numel(), EDGE_CHUNK):
        hi = lo + EDGE_CHUNK
        args = (t, alpha[lo:hi], src[lo:hi], dst[lo:hi], num_dst)
        out = out + (checkpoint(_weighted_sum_piece, *args,
                                use_reentrant=False)
                     if torch.is_grad_enabled()
                     else _weighted_sum_piece(*args))
    return out


def forward(params: Sequence[torch.Tensor], x: torch.Tensor,
            edges: Sequence[Layer], masks: Sequence[Optional[torch.Tensor]],
            heads: int, drop_rate: float,
            mm: Callable = torch.matmul) -> torch.Tensor:
    """Log-probs of the last layer's destinations.  `x` the feature rows
    by global id, `masks[l]` hidden layer l's dropout keep mask (or None),
    `mm` the dense product."""
    n = len(params) // GROUPS
    w, a, b, s, c = (params[g * n:(g + 1) * n] for g in range(GROUPS))
    h = x.index_select(0, edges[0].x_rows).to(w[0].dtype)
    for l, e in enumerate(edges):
        last = l == n - 1
        t = mm(h, w[l])
        f = t.shape[1]
        th = t.view(t.shape[0], heads, f // heads)
        s_src = (th * a[l][:f, 0].view(heads, -1)).sum(-1)
        s_dst = (th * a[l][f:, 0].view(heads, -1)).sum(-1)
        score = torch.nn.functional.leaky_relu(
            s_src[e.src] + s_dst[e.own][e.dst], NEG_SLOPE)
        alpha = edge_softmax(score, e.dst, e.num_dst)
        agg = weighted_sum(th, alpha, e.src, e.dst, e.num_dst)
        agg = agg.mean(dim=1) if last else agg.reshape(e.num_dst, f)
        out = agg + b[l] + mm(h[e.own], s[l]) + c[l]
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


def nll(logp: torch.Tensor, labels: torch.Tensor,
        rows: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over `rows` of `logp`."""
    return -logp[rows, labels[rows]].mean()


def adam_steps(p0: Sequence[torch.Tensor], steps: Sequence[dict],
               heads: int, drop_rate: float, lr: float,
               betas=(0.9, 0.999), eps: float = 1e-8,
               dtype: torch.dtype = torch.float64, mm: Callable = None,
               half_batch: bool = False, frozen: bool = False) -> dict:
    """Follow training steps from the leaves `p0` with torch's Adam.

    `steps[i]`: {"x": feature rows by global id, "edges": `layer_edges`
    of the step's layers, "masks": a keep mask or None per hidden layer,
    "labels": the batch's labels, "rows": the rows the loss averages
    over}.  Returns each step's loss, the first step's gradients, and the
    leaves after the first and after the last step.  Two faults a
    comparison has to catch: `half_batch` averages the loss over the first
    half of `rows`; `frozen` is a step that leaves its state unchanged (no
    update, the first gradient read as zero)."""
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


def _layers(cfg) -> int:
    return len(cfg["layer_sizes"]) - 1


def _widths(cfg) -> List[int]:
    """Per layer, W's output columns: the heads concatenated (the last
    layer's are averaged after the aggregation)."""
    w, heads = cfg["layer_sizes"], int(cfg["heads"])
    return [w[l + 1] * heads if l == _layers(cfg) - 1 else w[l + 1]
            for l in range(_layers(cfg))]


def leaves(cfg) -> List[tuple]:
    """The 15 leaves in the program's flat order, as (name, shape, draw):
    W_l [in, H·C], a_l [2·H·C, 1] (gnn.py's draws), then the biases b_l
    [out], the skip weights S_l [in, out] and the skip biases c_l [out],
    each uniform with the fans of its layer (in, out)."""
    w, n, cols = cfg["layer_sizes"], _layers(cfg), _widths(cfg)
    out = [(f"W{l}", (w[l], cols[l]), ("uniform", w[l], cols[l]))
           for l in range(n)]
    out += [(f"a{l}", (2 * cols[l], 1), ("uniform", 2 * cols[l], 1))
            for l in range(n)]
    out += [(f"b{l}", (w[l + 1],), ("uniform", w[l], w[l + 1]))
            for l in range(n)]
    out += [(f"S{l}", (w[l], w[l + 1]), ("uniform", w[l], w[l + 1]))
            for l in range(n)]
    out += [(f"c{l}", (w[l + 1],), ("uniform", w[l], w[l + 1]))
            for l in range(n)]
    return out


def step_flops(cfg, layers) -> int:
    """Required FLOPs of one step, `layers` one (nnz, dv, sv) per layer,
    bottom first: each attention layer as bounds.gat_layer_flops counts
    it at W's columns (the sampled edges; the self edges, which replace
    the masked sampled self-loops, are left out), and its skip over the dv
    destinations, forward, dS and, above the bottom layer, the input's
    gradient."""
    w, cols = cfg["layer_sizes"], _widths(cfg)
    total = 0
    for l, (nnz, dv, sv) in enumerate(layers):
        total += bounds.gat_layer_flops(nnz, dv, sv, w[l], cols[l], l > 0)
        total += (3 if l > 0 else 2) * 2 * dv * w[l] * w[l + 1]
    return total


def epoch_flops(cfg, num_vertices: int, num_edges: int) -> int:
    """A whole-graph epoch's FLOPs: every vertex a destination and a
    source, every edge kept."""
    return step_flops(cfg, [(num_edges, num_vertices, num_vertices)]
                      * _layers(cfg))


def kernel_layers(cfg):
    """Per layer, the (F, H) the sampled GAT kernels see: W's columns in
    the configuration's heads, the last layer's too."""
    return [(f, int(cfg["heads"])) for f in _widths(cfg)]


def reads_own_rows(cfg) -> bool:
    """The destinations' own rows are read (their score half, their self
    edge, their skip)."""
    return True


def sampled_edges(cfg, layers, num_vertices, ind, outd, device):
    """The recorded layers (global ids) as `layer_edges` gives them."""
    return layer_edges(layers)


def train_steps(cfg: dict, bias_correction: bool, p0: Sequence[torch.Tensor],
                step_inputs: List[dict], precision: str = "float64",
                half_batch: bool = False, frozen: bool = False) -> dict:
    """The harness's call: the steps of torch's Adam (bias-corrected, as
    the configuration's engine; weight decay none) from the leaves `p0`
    in `precision`."""
    if not bias_correction or cfg["weight_decay"] != 0:
        raise ValueError("gat_pyg trains with torch's Adam: bias "
                         "correction on, no weight decay")
    adam = cfg["adam"]
    return adam_steps(
        p0, step_inputs, int(cfg["heads"]), float(cfg["drop_rate"]),
        float(cfg["learn_rate"]), (adam["beta1"], adam["beta2"]),
        adam["epsilon"], _gnn.dtype_of(precision),
        _gnn.make_matmul(precision), half_batch, frozen)
