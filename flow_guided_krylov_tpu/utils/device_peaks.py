"""Published peak rates of the accelerators this program is measured on,
keyed by JAX's ``device_kind``.

Source: NVIDIA's H100 data sheet and Hopper architecture white paper (SXM
part, dense rates without sparsity, at the full 700 W power limit).  A
card set below that limit cannot hold its top clock under load, so a
roofline share is always reported beside the card's power limit.  A
device that is not in the table is an error: no peak is assumed.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass

__all__ = ["DevicePeaks", "PEAKS", "peaks_for", "card_label"]


@dataclass(frozen=True)
class DevicePeaks:
    hbm_bytes_s: float          # device-memory bandwidth
    bf16_flops: float           # tensor cores, dense
    tf32_flops: float           # tensor cores, dense
    f32_flops: float            # CUDA cores (Precision.HIGHEST f32 math)


PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(hbm_bytes_s=3.35e12,
                                         bf16_flops=989e12,
                                         tf32_flops=495e12,
                                         f32_flops=67e12),
}


def peaks_for(device_kind: str) -> DevicePeaks:
    """Peaks of ``device_kind``; raises KeyError for a device not in
    ``PEAKS``."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks recorded for device kind "
                       f"{device_kind!r}") from None


def card_label() -> str:
    """Each card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them, one card per
    ``;``-separated entry.  Every device time is reported beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())
