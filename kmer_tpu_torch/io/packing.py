"""Fixed-shape packing of read blocks for the device (a copy of
kmer_tpu/io/packing.py).

Reads are concatenated into one flat uint8 ASCII buffer with a single
NUL separator byte between reads (NUL encodes to the invalid code 4,
which resets the rolling window — so k-mer windows never straddle read
boundaries, reproducing the per-read extraction semantics of the
reference's kc-c4.c:85-100 with fully static shapes).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .fastx import Block


def pack_block(block: Block, capacity: int) -> List[Tuple[np.ndarray, int]]:
    """Pack a Block into one or more (ascii_u8[capacity], n_bases) buffers.

    The buffer tail is NUL-padded (invalid).  A block larger than
    `capacity` is split on read boundaries; a single read longer than
    capacity-1 is split with a (k-1)-overlap upstream (callers choose
    capacity >> max read length so this only matters for chromosomes).
    """
    out = []
    buf = np.zeros(capacity, np.uint8)
    pos = 0
    for seq in block.seqs:
        need = len(seq) + 1
        if pos + need > capacity and pos > 0:
            out.append((buf, pos))
            buf = np.zeros(capacity, np.uint8)
            pos = 0
        if need > capacity:
            raise ValueError(
                f"read of length {len(seq)} exceeds block capacity {capacity}"
            )
        buf[pos : pos + len(seq)] = np.frombuffer(seq, np.uint8)
        pos += need  # +1 leaves a NUL separator
    if pos:
        out.append((buf, pos))
    return out
