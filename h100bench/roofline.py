"""The work a kernel's roofline share is counted from, and the card's
peaks (peaks.json).  Counted from the inputs' shapes, so the share reads
the same work whatever implementation runs it."""

from __future__ import annotations

import os

from .spec import HERE, load_json


def peaks(device_name: str):
    """The peak rates of a card by its torch.cuda.get_device_name(), or
    None for a card the table does not hold."""
    return load_json(os.path.join(HERE, "peaks.json")).get(device_name)


def extract_bytes(n_reads: int, length: int, k: int) -> int:
    """Extraction's least traffic: each base read once, one 8-byte key
    written a k-mer position (a window of k bases in a read)."""
    return n_reads * length + 8 * n_reads * max(length - k + 1, 0)
