"""Plain PyTorch reference of GCN and GAT training steps, sampled and over
the whole graph.

Written from the published models (Kipf and Welling, arXiv:1609.02907:
relu(A_hat X W) with A_hat's symmetric degree normalisation; GAT,
arXiv:1710.10903: softmax over in-edges of leaky_relu(a^T [W h_s || W h_d]),
heads concatenated on hidden layers) and the update rule of the reference
system's Adam (NtsScheduler.hpp learn_local_with_decay_Adam: weight decay
added to the gradient, epsilon outside the square root, with or without
bias correction).  Departures, which the program shares: no bias terms;
relu after GAT's last layer before log_softmax (the reference system's GAT
engine); dropout on hidden activations with masks the caller supplies.

It imports torch and the harness's FLOP formulas (benchmark/bounds.py),
nothing of the program under test, and takes from the caller only inputs:
the graph's edges, features, labels and split, the initial parameters,
and for a sampled step the sampled neighbourhoods as global vertex ids
and the dropout masks (the program's randomness, which
`check_sample` and the caller's mask statistic judge on their own).  Edge
weights, degrees, attention and every gradient are worked out here.

Precision: "float64" computes everything in float64; "tf32" computes in
float32 with every dense product's operands rounded to TF32 (10 mantissa
bits, round to nearest even, as a TF32 tensor-core product rounds them),
forward and backward: the control that a float32 configuration with TF32
off must fail.

The module is also where the harness learns the architecture (section
"architecture" below): the program's parameter leaves and their draw, a
step's and an epoch's required FLOPs (counted by benchmark/bounds.py's
layer formulas), the (F, H) each layer's aggregation kernels see, and
whether the destinations' own rows are read.  A module for another
architecture gives the same functions; the harness names none.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from benchmark import bounds

EDGE_CHUNK = 1 << 21


# ------------------------------------------------------------- precisions
def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    out = (bits + 0xFFF + lsb) & ~0x1FFF
    return out.view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gr = tf32_round(g)
        return gr @ tf32_round(b).t(), tf32_round(a).t() @ gr


def make_matmul(precision: str):
    if precision == "float64":
        return torch.matmul
    if precision == "tf32":
        return _Tf32Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


def dtype_of(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


# ------------------------------------------------------------------ graph
def degrees(src: torch.Tensor, dst: torch.Tensor, num_vertices: int):
    """(in-degree, out-degree) of every vertex, counting each edge of the
    list (self-loops and repeated edges included)."""
    ind = torch.bincount(dst, minlength=num_vertices)
    outd = torch.bincount(src, minlength=num_vertices)
    return ind, outd


def gcn_coef(src_ids, dst_ids, ind, outd, dtype):
    """1 / (sqrt(outdeg(src)) sqrt(indeg(dst))), degrees at least 1."""
    od = outd[src_ids].clamp_min(1).to(dtype)
    idg = ind[dst_ids].clamp_min(1).to(dtype)
    return 1.0 / (od.sqrt() * idg.sqrt())


def leaky_relu(x, slope):
    return torch.where(x >= 0, x, slope * x)


# ------------------------------------------------------------ sample check
def check_sample(layers: Sequence[dict], src: torch.Tensor, dst: torch.Tensor,
                 num_vertices: int, train_mask: torch.Tensor) -> Dict[str, int]:
    """Violations of what a uniform neighbour sample guarantees, counted.

    `layers` bottom first, each {"dst": [D] global ids, "nbr": [D, K]
    global ids, -1 where the slot holds no edge}; the last layer's
    destinations are the step's seeds.  Counted: kept (dst, src) pairs that
    are not edges of the graph or occur more often than the graph holds
    them; rows whose kept count is not their in-degree (in-degree <= K) or
    not in [1, K] (in-degree > K); destinations repeated within a layer;
    a layer's destinations other than the next layer's kept sources and
    destinations; seeds outside the training split."""
    V = num_vertices
    ind = torch.bincount(dst, minlength=V)
    gkeys, gcounts = torch.unique(dst * V + src, sorted=True,
                                  return_counts=True)
    bad = {"not_edges": 0, "row_counts": 0, "repeated_dst": 0,
           "layer_links": 0, "seeds_not_train": 0}
    for l, layer in enumerate(layers):
        d, nbr = layer["dst"], layer["nbr"]
        keep = nbr >= 0
        k = nbr.shape[1]
        keys = (d[:, None] * V + nbr)[keep]
        skeys, scounts = torch.unique(keys, sorted=True, return_counts=True)
        pos = torch.searchsorted(gkeys, skeys).clamp_max(gkeys.numel() - 1)
        found = gkeys[pos] == skeys
        have = torch.where(found, gcounts[pos], torch.zeros_like(scounts))
        bad["not_edges"] += int((scounts - have).clamp_min(0).sum())
        cnt = keep.sum(1)
        deg = ind[d]
        ok = torch.where(deg <= k, cnt == deg, (cnt >= 1) & (cnt <= k))
        bad["row_counts"] += int((~ok).sum())
        bad["repeated_dst"] += int(d.numel() - torch.unique(d).numel())
        if l + 1 < len(layers):
            up = layers[l + 1]
            want = torch.unique(torch.cat([up["nbr"][up["nbr"] >= 0],
                                           up["dst"]]))
            have_d = torch.unique(d)
            if want.numel() != have_d.numel():
                bad["layer_links"] += abs(want.numel() - have_d.numel()) or 1
            else:
                bad["layer_links"] += int((want != have_d).sum())
    seeds = layers[-1]["dst"]
    bad["seeds_not_train"] = int((~train_mask[seeds]).sum())
    return bad


# ----------------------------------------------------------------- layers
def _edge_sum_chunk(t, coef, src, dst, num_dst, heads):
    """One chunk of out[d] += coef_e * t[src_e] (per head)."""
    msg = t.index_select(0, src)
    if heads > 1:
        msg = (msg.view(msg.shape[0], heads, -1) * coef[:, :, None]).view(
            msg.shape[0], -1)
    else:
        msg = msg * coef.reshape(-1, 1)
    out = torch.zeros((num_dst, t.shape[1]), dtype=t.dtype, device=t.device)
    return out.index_add(0, dst, msg)


def edge_sum(t, coef, src, dst, num_dst, heads=1):
    """out[d] = sum over edges e into d of coef_e * t[src_e], in chunks of
    EDGE_CHUNK edges, each recomputed in the backward pass instead of
    keeping its [edges, F] messages."""
    out = None
    for lo in range(0, src.numel(), EDGE_CHUNK):
        hi = lo + EDGE_CHUNK
        args = (t, coef[lo:hi], src[lo:hi], dst[lo:hi], num_dst, heads)
        part = (checkpoint(_edge_sum_chunk, *args, use_reentrant=False)
                if torch.is_grad_enabled() else _edge_sum_chunk(*args))
        out = part if out is None else out + part
    if out is None:
        out = torch.zeros((num_dst, t.shape[1]), dtype=t.dtype,
                          device=t.device)
    return out


def edge_softmax(score, dst, num_dst):
    """Softmax of [E, H] scores over the edges into each destination."""
    h = score.shape[1]
    mx = torch.full((num_dst, h), -math.inf, dtype=score.dtype,
                    device=score.device)
    mx = mx.scatter_reduce(0, dst[:, None].expand(-1, h), score, "amax")
    e = torch.exp(score - mx.detach()[dst])
    z = torch.zeros((num_dst, h), dtype=score.dtype, device=score.device)
    z = z.index_add(0, dst, e)
    return e / z[dst]


def score_halves(t, a, heads):
    """Per-row score halves (source, destination), [rows, heads] each."""
    f = t.shape[1]
    fh = f // heads
    tv = t.view(-1, heads, fh)
    a_src = a[:f, 0].view(heads, fh)
    a_dst = a[f:, 0].view(heads, fh)
    return (tv * a_src).sum(-1), (tv * a_dst).sum(-1)


# ---------------------------------------------------------------- forward
class EdgeList:
    """An edge list in row space: `src` rows of the layer's input, and
    `dst_index` the destination (0..num_dst-1) of each edge."""

    def __init__(self, src, dst_index, num_dst, dst_self_rows, coef=None):
        self.src, self.dst_index, self.num_dst = src, dst_index, num_dst
        self.dst_self_rows = dst_self_rows
        self.coef = coef


def _activate(cfg, l, pre, mask):
    last = l == len(cfg["layer_sizes"]) - 2
    if cfg["family"] == "gat":
        pre = torch.relu(pre)
        if last:
            return torch.log_softmax(pre, dim=-1)
    elif last:
        return torch.log_softmax(pre, dim=-1)
    else:
        pre = torch.relu(pre)
    if mask is not None:
        pre = torch.where(mask, pre / (1.0 - cfg["drop_rate"]),
                          torch.zeros((), dtype=pre.dtype, device=pre.device))
    return pre


def forward(cfg, params, x, edges: List[EdgeList], masks, mm):
    """Log-probs of the last layer's destinations.  `edges[l]` is layer l's
    edge list over the rows of its input (x for layer 0, layer l-1's
    destinations after), `masks[l]` its dropout mask or None."""
    h = x
    n_layers = len(cfg["layer_sizes"]) - 1
    for l in range(n_layers):
        el = edges[l]
        w = params["weights"][l]
        t = mm(h, w)
        if cfg["family"] == "gcn":
            pre = edge_sum(t, el.coef.to(t.dtype), el.src, el.dst_index,
                           el.num_dst)
        else:
            heads = 1 if l == n_layers - 1 else cfg["heads"]
            ts, td = score_halves(t, params["attn"][l], heads)
            score = leaky_relu(ts[el.src] + td[el.dst_self_rows][el.dst_index],
                               cfg.get("leaky_relu_slope", 0.2))
            att = edge_softmax(score, el.dst_index, el.num_dst)
            pre = edge_sum(t, att, el.src, el.dst_index, el.num_dst, heads)
        h = _activate(cfg, l, pre, masks[l] if l < len(masks) else None)
    return h


def nll(logp, labels, rows):
    """Mean negative log-likelihood over `rows` of `logp`, `labels`
    indexed like `logp`'s rows."""
    return -logp[rows, labels[rows]].mean()


# ------------------------------------------------------------------- adam
def adam_step(cfg, bias_correction, step, params, grads, state):
    """The reference system's Adam: g += wd * p; moments; p -= lr * m /
    (sqrt(v) + eps), bias-corrected where the engine corrects."""
    b1, b2 = cfg["adam"]["beta1"], cfg["adam"]["beta2"]
    eps, wd = cfg["adam"]["epsilon"], cfg["weight_decay"]
    lr = cfg["learn_rate"]
    if cfg.get("decay_epoch", 0) > 0:
        lr = lr * cfg["decay_rate"] ** (step // cfg["decay_epoch"])
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        g = g + wd * p
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        if bias_correction:
            mh, vh = m / (1 - b1 ** step), v / (1 - b2 ** step)
        else:
            mh, vh = m, v
        new_p.append(p - lr * mh / (vh.sqrt() + eps))
        new_m.append(m)
        new_v.append(v)
    return new_p, {"m": new_m, "v": new_v}


# ----------------------------------------------------------- architecture
def _layers(cfg) -> int:
    return len(cfg["layer_sizes"]) - 1


def leaves(cfg) -> List[tuple]:
    """Every parameter leaf in the program's flat order (the optimizer's:
    each layer's W [in, out], then GAT's attention vectors a [2 out, 1]),
    as (name, shape, draw): ("uniform", fan_in, fan_out) is uniform in
    +-sqrt(6 / (fan_in + fan_out)), ("zeros",) all zero."""
    w = cfg["layer_sizes"]
    out = [(f"W{l}", (w[l], w[l + 1]), ("uniform", w[l], w[l + 1]))
           for l in range(_layers(cfg))]
    if cfg["family"] == "gat":
        out += [(f"a{l}", (2 * w[l + 1], 1), ("uniform", 2 * w[l + 1], 1))
                for l in range(_layers(cfg))]
    return out


def _split(cfg, flat: Sequence[torch.Tensor]) -> Dict[str, list]:
    """The flat leaves of `leaves(cfg)` as `forward` reads them."""
    n = _layers(cfg)
    return {"weights": list(flat[:n]), "attn": list(flat[n:])}


_LAYER_FLOPS = {"gcn": bounds.gcn_layer_flops, "gat": bounds.gat_layer_flops}


def step_flops(cfg, layers) -> int:
    """Required FLOPs of one step, `layers` one (nnz, dv, sv) per layer,
    bottom first (benchmark/bounds.py counts a layer)."""
    fn, w = _LAYER_FLOPS[cfg["family"]], cfg["layer_sizes"]
    return sum(fn(nnz, dv, sv, w[l], w[l + 1], l > 0)
               for l, (nnz, dv, sv) in enumerate(layers))


def epoch_flops(cfg, num_vertices: int, num_edges: int) -> int:
    """A whole-graph training epoch's required FLOPs: every vertex is a
    destination and a source, every edge is kept."""
    return step_flops(cfg, [(num_edges, num_vertices, num_vertices)]
                      * _layers(cfg))


def kernel_layers(cfg) -> List[Tuple[int, int]]:
    """Per layer, the (F, H) its aggregation kernels see: GAT aggregates
    its transform's out columns in the configuration's heads (one head on
    the last layer); a weighted sum aggregates at the narrower side (the
    transform first where the layer shrinks), one head."""
    w, n = cfg["layer_sizes"], _layers(cfg)
    if cfg["family"] == "gat":
        return [(w[l + 1], 1 if l == n - 1 else int(cfg["heads"]))
                for l in range(n)]
    return [(min(w[l], w[l + 1]), 1) for l in range(n)]


def reads_own_rows(cfg) -> bool:
    """Whether a layer reads its destinations' own rows beside their
    sampled sources (GAT's destination score does)."""
    return cfg["family"] == "gat"


# ---------------------------------------------------------------- training
def train_steps(cfg: dict, bias_correction: bool, p0: Sequence[torch.Tensor],
                step_inputs: List[dict], precision: str = "float64",
                half_batch: bool = False, frozen: bool = False) -> dict:
    """Follow the program's first steps from the same initial parameters,
    `p0` the leaves of `leaves(cfg)` in their order.

    `step_inputs[i]`: {"x": input rows of layer 0, "edges": [EdgeList] per
    layer, "masks": [bool mask or None] per hidden layer, "labels": labels
    of the last layer's destinations, "rows": the destinations the loss
    averages over}.  Returns each step's loss, the first gradient as the
    optimizer gets it (weight decay added) per leaf, and the parameters
    after the first and after the last step per leaf, in `p0`'s order.
    Two faults the comparison has to catch: `half_batch` averages the
    loss over the first half of `rows`; `frozen` is a step that returns
    its state unchanged (no update, the first moment, and so the first
    gradient read from it, zero)."""
    dt = dtype_of(precision)
    mm = make_matmul(precision)
    cur = [t.detach().to(dt) for t in p0]
    state = {"m": [torch.zeros_like(t) for t in cur],
             "v": [torch.zeros_like(t) for t in cur]}
    losses, grad1, params1 = [], None, None
    for i, inp in enumerate(step_inputs):
        req = [t.clone().requires_grad_() for t in cur]
        params = _split(cfg, req)
        logp = forward(cfg, params, inp["x"].to(dt), inp["edges"],
                       inp["masks"], mm)
        rows = inp["rows"]
        if half_batch:
            rows = rows[: max(rows.numel() // 2, 1)]
        loss = nll(logp, inp["labels"], rows)
        grads = torch.autograd.grad(loss, req)
        if i == 0:
            grad1 = [(g + cfg["weight_decay"] * p) * (0.0 if frozen else 1.0)
                     for g, p in zip(grads, cur)]
        if not frozen:
            cur, state = adam_step(cfg, bias_correction, i + 1, cur,
                                   [g.detach() for g in grads], state)
        if i == 0:
            params1 = list(cur)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": [g.detach() for g in grad1],
            "params1": params1, "params": cur}


# ------------------------------------------------------- building the inputs
def sampled_edges(cfg, layers, num_vertices, ind, outd,
                  device) -> List[EdgeList]:
    """Edge lists in row space from global-id layers (bottom first): layer
    0 reads rows of the feature matrix by global id, layer l > 0 reads
    layer l-1's destinations, found by their global ids."""
    out = []
    prev_pos = None
    for l, layer in enumerate(layers):
        d, nbr = layer["dst"], layer["nbr"]
        keep = nbr >= 0
        dst_index = torch.arange(d.numel(), device=device)[:, None].expand_as(
            nbr)[keep]
        src_global = nbr[keep]
        if prev_pos is None:
            src_rows, self_rows = src_global, d
        else:
            src_rows, self_rows = prev_pos[src_global], prev_pos[d]
        coef = None
        if cfg["family"] == "gcn":
            coef = gcn_coef(src_global, d[dst_index], ind, outd,
                            torch.float64)
        out.append(EdgeList(src_rows, dst_index, d.numel(), self_rows, coef))
        prev_pos = torch.full((num_vertices,), -1, dtype=torch.int64,
                              device=device)
        prev_pos[d] = torch.arange(d.numel(), device=device)
    return out


def whole_graph_edges(cfg, src, dst, num_vertices, ind,
                      outd) -> List[EdgeList]:
    """The whole graph as every layer's edge list."""
    coef = (gcn_coef(src, dst, ind, outd, torch.float64)
            if cfg["family"] == "gcn" else None)
    self_rows = torch.arange(num_vertices, device=src.device)
    el = EdgeList(src, dst, num_vertices, self_rows, coef)
    return [el] * (len(cfg["layer_sizes"]) - 1)
