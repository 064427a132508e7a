"""stderr logging in the reference's uniform convention:
[M::func] info, [W::func] warning, [V::func] verbose (a copy of
kmer_tpu/utils/log.py without its jax-based `is_primary`: the port runs
on one card, in one process).
"""

from __future__ import annotations

import sys


def minfo(func: str, msg: str) -> None:
    sys.stderr.write(f"[M::{func}] {msg}\n")


def warn(func: str, msg: str) -> None:
    sys.stderr.write(f"[W::{func}] {msg}\n")


def verbose(func: str, msg: str) -> None:
    sys.stderr.write(f"[V::{func}] {msg}\n")
