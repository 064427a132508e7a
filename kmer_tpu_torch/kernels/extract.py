"""Fused extraction: ASCII block -> sentinelized hash64 keys (port of
kmer_tpu/kernels/extract_tpu.py).

Per flat position i of a packed ASCII block (reads separated by one
invalid byte): the canonical k-mer ending at i, hashed by hash64 mod
2^(2k), as a biased int64 key (kernels/keys.py); the sentinel SENT when
the window holds a non-ACGTU byte or i < k-1; k=32 keys collapse to
hash64(0).  Also the count of valid lanes over the whole block.

Two forms, each launching csrc/extract.cu for a CUDA tensor and running
its plain version for a CPU tensor:

  extract_keys(ascii, k)                 one key per position;
  extract_keys_rows(ascii, k, row_bytes) uniform-length reads of
                                         row_bytes = L+1 bytes: only the
                                         in-row offsets k-1..row_bytes-2
                                         of the first n // row_bytes rows
                                         (kmer_tpu/pipeline/counter.py:
                                         474-487), row after row.

The plain versions are `extract_keys_plain` (encode -> extract_canonical
-> sentinelize, as kmer_tpu/pipeline/counter.py:387-392) and
`extract_keys_rows_plain` (its slice).  Both CUDA forms count as
launches of `extract`.
"""

from __future__ import annotations

import torch

from . import _build
from .encode import encode_bases
from .keys import SENT
from .kmer import extract_canonical

_TOP = -(1 << 63)  # int64 with only the top bit set: the key bias


def _check(ascii_u8: torch.Tensor, k: int, row_bytes=None) -> None:
    if ascii_u8.dtype != torch.uint8 or ascii_u8.dim() != 1:
        raise ValueError("extract: need a 1-D uint8 tensor")
    if not 1 <= k <= 32:
        raise ValueError("extract: k must be in [1, 32]")
    if row_bytes is not None and not (
            k < row_bytes < 1 << 31
            and ascii_u8.shape[0] // row_bytes < 1 << 31):
        raise ValueError("extract: row_bytes must exceed k (and the block "
                         "hold under 2^31 rows)")


def extract_keys_plain(ascii_u8: torch.Tensor, k: int):
    """(keys int64 (N,), n_valid int64 0-dim) in plain PyTorch."""
    out = extract_canonical(encode_bases(ascii_u8), k, apply_hash64=True)
    keys = torch.where(out.valid, out.kmer ^ _TOP, SENT)
    return keys, out.valid.sum()


def extract_keys_rows_plain(ascii_u8: torch.Tensor, k: int, row_bytes: int):
    """(keys int64 (n_rows * (row_bytes - k),), n_valid over the whole
    block) in plain PyTorch: the flat plane's kept columns."""
    _check(ascii_u8, k, row_bytes)
    keys, n_valid = extract_keys_plain(ascii_u8, k)
    n_rows = ascii_u8.shape[0] // row_bytes
    keys = keys[:n_rows * row_bytes].view(n_rows, row_bytes)
    return keys[:, k - 1:row_bytes - 1].reshape(-1), n_valid


def _launch(entry: str, x: torch.Tensor, n_out: int, *args):
    keys = torch.empty(n_out, dtype=torch.int64, device=x.device)
    n_valid = torch.zeros((), dtype=torch.int64, device=x.device)
    _build.launch(entry, "extract", x, x.data_ptr(), x.shape[0], *args,
                  keys.data_ptr(), n_valid.data_ptr())
    return keys, n_valid


def extract_keys(ascii_u8: torch.Tensor, k: int):
    """(keys, n_valid): the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if not ascii_u8.is_cuda:
        return extract_keys_plain(ascii_u8, k)
    _check(ascii_u8, k)
    x = ascii_u8.contiguous()
    return _launch("ktt_extract", x, x.shape[0], k)


def extract_keys_rows(ascii_u8: torch.Tensor, k: int, row_bytes: int):
    """(row-sliced keys, n_valid): the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if not ascii_u8.is_cuda:
        return extract_keys_rows_plain(ascii_u8, k, row_bytes)
    _check(ascii_u8, k, row_bytes)
    x = ascii_u8.contiguous()
    n_rows = x.shape[0] // row_bytes
    return _launch("ktt_extract_rows", x, n_rows * (row_bytes - k), k,
                   row_bytes)
