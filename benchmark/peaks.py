"""The card's published peaks, by device name: the yardstick every share
of a peak or of a roofline divides by.

NVIDIA H100 SXM data sheet (dense rates, no sparsity): HBM3 at 3.35 TB/s;
67 TFLOP/s in float32 outside the tensor cores (the rate of float32 with
TF32 off, and of the port's hand-written kernels, which sum in float32);
495 TFLOP/s in TF32; 989 TFLOP/s in bfloat16.  The H100 PCIe and NVL
rows are their own data sheets'.  Copied from the port's
`utils/roofline.HBM_BYTES_PER_S` and `F32_FLOPS_PER_S` and frozen
here, so that no later change to the program moves the yardstick.
"""

from __future__ import annotations

from typing import Dict

# name substring -> peaks; the first key the device name contains wins, so
# the longer H100 names come first
PEAKS = (
    ("H100 PCIe", {"hbm_bytes_per_s": 2.0e12, "float32": 51e12,
                   "tf32": 378e12, "bfloat16": 756e12}),
    ("H100 NVL", {"hbm_bytes_per_s": 3.9e12, "float32": 60e12,
                  "tf32": 418e12, "bfloat16": 835e12}),
    ("H100", {"hbm_bytes_per_s": 3.35e12, "float32": 67e12,
              "tf32": 495e12, "bfloat16": 989e12}),
)


def peaks_for(device_name: str) -> Dict[str, float]:
    """The peaks of the card called `device_name`; ValueError for a card
    this table does not know (a share against a guessed peak is worse
    than none)."""
    for key, row in PEAKS:
        if key in device_name:
            return row
    raise ValueError(f"no published peaks known for {device_name!r}")


def flops_peak(device_name: str, dtype: str, tf32: bool) -> float:
    """The product rate a configuration's dtype may use: float32 with TF32
    off is the 67 TFLOP/s rate, float32 with TF32 on the TF32 rate."""
    row = peaks_for(device_name)
    if dtype == "float32":
        return row["tf32"] if tf32 else row["float32"]
    return row[dtype]
