"""What the port's kernel-variant and pair-timing scripts share: patching
a kernel source, building the patched sources, and timing and checking a
call on the card.

Imported by `torch_row_kernel_variants.py`, `torch_redesign_variants.py`
and `torch_redesign_pair.py`; not run by itself.  Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from sgnn_tpu_torch.ops.cuda.build import (  # noqa: E402
    CSRC_DIR, NVCC_FLAGS, find_nvcc,
)


def patched(text: str, replacements) -> str:
    """`text` with each (old, new) replaced; old is a string, or a (start,
    end) pair replacing start through end; each must occur exactly once,
    so a change to the kernels stops a script instead of timing something
    else."""
    for old, new in replacements:
        if isinstance(old, tuple):
            start, end = old
            if text.count(start) != 1 or text.count(end) != 1:
                raise RuntimeError(f"anchor not unique: {start!r} / {end!r}")
            a = text.index(start)
            text = text[:a] + new + text[text.index(end, a) + len(end):]
        else:
            if text.count(old) != 1:
                raise RuntimeError(f"not found exactly once: {old!r}")
            text = text.replace(old, new)
    return text


def build_variants(patches, out_dir: pathlib.Path) -> dict:
    """nvcc each variant of `patches` ({source: ((variant, replacements),
    ...)}, `source` a file `csrc/{source}.cu`) with the port's flags, all
    at once, into `out_dir`; {(source, variant): library path}."""
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    headers = b"".join(f.read_bytes() for f in sorted(CSRC_DIR.glob("*.cuh")))
    procs = {}
    for source, variants in patches.items():
        text = (CSRC_DIR / f"{source}.cu").read_text()
        for name, reps in variants:
            src = patched(text, reps)
            h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + headers
                               + src.encode()).hexdigest()[:16]
            cu = out_dir / f"{source}-{h}.cu"
            cu.write_text(src)
            lib = cu.with_suffix(".so")
            procs[source, name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(lib),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    out = {}
    for key, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        out[key] = lib
    return out


def event_ms(fn, reps: int) -> float:
    """Milliseconds a call of `fn`: CUDA events around `reps` calls after
    a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|, in f32."""
    ref = ref.float()
    return ((got.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()
