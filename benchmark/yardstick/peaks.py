"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheets,
dense, without sparsity, at the full power limit)."""

from __future__ import annotations

# bf16 tensor-core FLOP/s, HBM bytes/s.
PEAKS = {
    "sxm": {"bf16": 989e12, "bytes": 3.35e12},
    "pcie": {"bf16": 756e12, "bytes": 2.0e12},
}


def card_peaks(name: str) -> dict:
    """The peak table of an H100 by its device name: PCIe's where the name
    says PCIe, else SXM's."""
    if "H100" not in name:
        raise ValueError(f"no peak table for {name!r}")
    return PEAKS["pcie" if "pcie" in name.lower() else "sxm"]
