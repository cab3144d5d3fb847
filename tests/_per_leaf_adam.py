"""`ReferenceAdam`'s rule leaf by leaf, the form its multi-tensor update
replaces: the plain reference that `sgnn_tpu_torch.nn.optim.ReferenceAdam`
is held to bit for bit, on the CPU (tests/test_torch_port_model.py) and on
the card (tests/test_torch_port_cuda.py).  Each expression is the eager
torch op on the leaves' device, so on the card a division by a Python
number is the card's own.  The imports are torch alone, so the card's
tests can load it without JAX.
"""

import torch

# ReferenceAdam's variants: the GPU engines' rule, the bias-corrected one
# of GATSAMPLEALLGPU and the CPU engines, a decaying learning rate, and
# torch's Adam as the PyG stacks' cells run it (lr 0.001, eps 1e-8, no decay)
ADAM_VARIANTS = [
    dict(learn_rate=0.01, weight_decay=1e-4),
    dict(learn_rate=0.01, weight_decay=1e-4, bias_correction=True),
    dict(learn_rate=0.01, weight_decay=1e-4, decay_rate=0.5, decay_epoch=2),
    dict(learn_rate=1e-3, weight_decay=0.0, epsilon=1e-8,
         bias_correction=True),
]
ADAM_IDS = ["adam", "adam-bias", "adam-decay", "adam-pyg"]


def adam_per_leaf(opt, grads, state, params):
    """One update of `opt` (a ReferenceAdam) leaf by leaf: (params, m, v)."""
    step = state.step + 1
    lr = float(torch.tensor(opt.learn_rate, dtype=torch.float32))
    if opt.decay_epoch > 0 and opt.decay_rate != 1.0:
        lr = float(torch.tensor(opt.learn_rate, dtype=torch.float32)
                   * torch.tensor(opt.decay_rate, dtype=torch.float32)
                   ** float(step // opt.decay_epoch))
    out, ms, vs = [], [], []
    for p, g, m, v in zip(params, grads, state.m, state.v):
        p32 = p.float()
        g = g.float() + opt.weight_decay * p32
        m = opt.beta1 * m + (1.0 - opt.beta1) * g
        v = opt.beta2 * v + (1.0 - opt.beta2) * g.square()
        m_hat, v_hat = m, v
        if opt.bias_correction:
            b1, b2 = (torch.tensor(b, dtype=torch.float32) ** step
                      for b in (opt.beta1, opt.beta2))
            m_hat, v_hat = m / float(1.0 - b1), v / float(1.0 - b2)
        out.append((p32 - lr * m_hat / (v_hat.sqrt() + opt.epsilon))
                   .to(p.dtype))
        ms.append(m)
        vs.append(v)
    return out, ms, vs
