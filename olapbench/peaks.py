"""The table of peaks the rooflines are taken against: published data-sheet
rates at the card's full power limit (NVIDIA H100 SXM: 80 GB of HBM3 at
3.35 TB/s)."""
from typing import Optional

HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(kind: str) -> Optional[float]:
    """The card's memory rate, or None for a card not in the table (its
    rooflines then read nothing)."""
    return HBM_BYTES_PER_S.get(kind)
