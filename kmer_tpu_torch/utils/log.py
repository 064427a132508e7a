"""stderr logging in the reference's uniform convention:
[M::func] info, [W::func] warning, [V::func] verbose, and `is_primary`,
the output gate of a run of several processes (a copy of
kmer_tpu/utils/log.py, `is_primary` on torch.distributed).
"""

from __future__ import annotations

import sys


def minfo(func: str, msg: str) -> None:
    sys.stderr.write(f"[M::{func}] {msg}\n")


def warn(func: str, msg: str) -> None:
    sys.stderr.write(f"[W::{func}] {msg}\n")


def verbose(func: str, msg: str) -> None:
    sys.stderr.write(f"[V::{func}] {msg}\n")


def is_primary() -> bool:
    """True on the output-emitting process: process 0 of a run of
    several (torch.distributed initialized), always in one process.
    Tools gate stdout and result files on it so that a run prints
    once."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0
