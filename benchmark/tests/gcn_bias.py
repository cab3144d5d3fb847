"""A test-only architecture: whole-graph GCN with a bias on every layer,
relu(A_hat (H W) + b) on hidden layers and log_softmax on the last, plain
Adam.  It stands for a later configuration's reference module: the
harness has to take its leaves, its draw, its FLOPs and its steps from
this file alone, and no file of the harness names it."""

from __future__ import annotations

from typing import List, Sequence

import torch

from benchmark import bounds


def _layers(cfg) -> int:
    return len(cfg["layer_sizes"]) - 1


def leaves(cfg) -> List[tuple]:
    """W0, b0, W1, b1, ...: weights drawn, biases zero."""
    w, out = cfg["layer_sizes"], []
    for l in range(_layers(cfg)):
        out.append((f"W{l}", (w[l], w[l + 1]), ("uniform", w[l], w[l + 1])))
        out.append((f"b{l}", (w[l + 1],), ("zeros",)))
    return out


def step_flops(cfg, layers) -> int:
    w = cfg["layer_sizes"]
    return sum(bounds.gcn_layer_flops(nnz, dv, sv, w[l], w[l + 1], l > 0)
               + 2 * dv * w[l + 1]
               for l, (nnz, dv, sv) in enumerate(layers))


def epoch_flops(cfg, num_vertices: int, num_edges: int) -> int:
    return step_flops(cfg, [(num_edges, num_vertices, num_vertices)]
                      * _layers(cfg))


def kernel_layers(cfg):
    w = cfg["layer_sizes"]
    return [(min(w[l], w[l + 1]), 1) for l in range(_layers(cfg))]


def reads_own_rows(cfg) -> bool:
    return False


def degrees(src, dst, num_vertices: int):
    return (torch.bincount(dst, minlength=num_vertices),
            torch.bincount(src, minlength=num_vertices))


def whole_graph_edges(cfg, src, dst, num_vertices, ind, outd):
    coef = 1.0 / (outd[src].clamp_min(1).double().sqrt()
                  * ind[dst].clamp_min(1).double().sqrt())
    return [(src, dst, num_vertices, coef)] * _layers(cfg)


def _forward(cfg, params, x, edges):
    h = x
    for l in range(_layers(cfg)):
        w, b = params[2 * l], params[2 * l + 1]
        src, dst, n, coef = edges[l]
        t = h @ w
        msg = t.index_select(0, src) * coef.to(t.dtype)[:, None]
        pre = torch.zeros((n, t.shape[1]), dtype=t.dtype).index_add(
            0, dst, msg) + b
        h = (torch.log_softmax(pre, -1) if l == _layers(cfg) - 1
             else torch.relu(pre))
    return h


def train_steps(cfg, bias_correction: bool, p0: Sequence[torch.Tensor],
                step_inputs: List[dict], precision: str = "float64",
                half_batch: bool = False, frozen: bool = False) -> dict:
    dt = torch.float64 if precision == "float64" else torch.float32
    b1, b2 = cfg["adam"]["beta1"], cfg["adam"]["beta2"]
    eps, wd, lr = (cfg["adam"]["epsilon"], cfg["weight_decay"],
                   cfg["learn_rate"])
    cur = [t.detach().to(dt) for t in p0]
    m = [torch.zeros_like(t) for t in cur]
    v = [torch.zeros_like(t) for t in cur]
    losses, grad1, params1 = [], None, None
    for i, inp in enumerate(step_inputs):
        req = [t.clone().requires_grad_() for t in cur]
        logp = _forward(cfg, req, inp["x"].to(dt), inp["edges"])
        rows = inp["rows"]
        if half_batch:
            rows = rows[: max(rows.numel() // 2, 1)]
        loss = -logp[rows, inp["labels"][rows]].mean()
        grads = [g + wd * p for g, p in
                 zip(torch.autograd.grad(loss, req), cur)]
        if i == 0:
            grad1 = [g * (0.0 if frozen else 1.0) for g in grads]
        if not frozen:
            step = i + 1
            m = [b1 * a + (1 - b1) * g for a, g in zip(m, grads)]
            v = [b2 * a + (1 - b2) * g * g for a, g in zip(v, grads)]
            c1, c2 = ((1 - b1 ** step, 1 - b2 ** step) if bias_correction
                      else (1.0, 1.0))
            cur = [p - lr * (a / c1) / ((c / c2).sqrt() + eps)
                   for p, a, c in zip(cur, m, v)]
        if i == 0:
            params1 = list(cur)
        losses.append(float(loss.detach()))
    return {"losses": losses, "grad1": [g.detach() for g in grad1],
            "params1": params1, "params": cur}
