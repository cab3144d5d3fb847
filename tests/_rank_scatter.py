"""The device sampler's source set as a rank scatter: the plain reference
that `sgnn_tpu_torch.sampler.device._source_set` is held to, on the CPU
(tests/test_torch_port_sampler.py) and on the card
(tests/test_torch_port_cuda.py).

The presence bitmap over [V] takes an amax scatter, every slot not kept
aiming at the first seed; the dense ranks come from a prefix sum; and every
vertex scatters its id into its rank slot, the absent ones and those past
the bound into one dump slot at `num_src_pad`.  The imports are torch and
the port alone, so the card's tests can load it without JAX.
"""

import numpy as np
import torch

from sgnn_tpu_torch.sampler import device as device_sampler

BLOCK_FIELDS = ("srcs", "src_valid", "nbr", "weight", "seeds", "seed_in_src",
                "dst_valid")


def rank_scatter_source_set(keep, nbr_global, seeds_l, dst_valid,
                            num_vertices, num_src_pad):
    """(srcs, src_valid, lookup) of one hop, by scatter."""
    dev = keep.device
    presence = torch.zeros(num_vertices, dtype=torch.int32, device=dev)
    presence.scatter_reduce_(
        0, torch.where(keep, nbr_global, seeds_l[:1]).reshape(-1).long(),
        keep.reshape(-1).to(torch.int32), reduce="amax")
    presence.scatter_reduce_(0, seeds_l, dst_valid.to(torch.int32),
                             reduce="amax")
    ranks = presence.cumsum(0)
    lookup = ranks - 1
    num_src = ranks[-1].clamp_max(num_src_pad)
    slot = torch.where((presence == 1) & (lookup < num_src_pad), lookup,
                       num_src_pad)
    srcs = torch.zeros(num_src_pad + 1, dtype=torch.int32, device=dev)
    srcs.scatter_reduce_(0, slot, torch.arange(num_vertices, dtype=torch.int32,
                                               device=dev), reduce="amax")
    src_valid = torch.arange(num_src_pad, device=dev) < num_src
    return srcs[:num_src_pad], src_valid, lookup


def both_ways(monkeypatch, generator, call):
    """`call()` with the sampler's own source set, then again from the same
    generator state with the rank scatter in its place: (own, reference)."""
    state = generator.get_state()
    own = call()
    generator.set_state(state)
    with monkeypatch.context() as m:
        m.setattr(device_sampler, "_source_set", rank_scatter_source_set)
        ref = call()
    return own, ref


def assert_same_blocks(own, ref):
    """Every field of two lists of blocks equal bit for bit."""
    assert len(own) == len(ref)
    for h, (a, b) in enumerate(zip(own, ref)):
        for f in BLOCK_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, (h, f)
            np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy(),
                                          err_msg=f"hop {h} {f}")
