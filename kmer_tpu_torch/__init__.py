"""kmer_tpu_torch — the k-mer counting engine on PyTorch and CUDA.

A port of the JAX/Pallas package `kmer_tpu` (which stays the reference)
to one NVIDIA H100.  Module names mirror the JAX package's; every Pallas
kernel on the ported path is a hand-written CUDA kernel under `csrc/`,
with a plain PyTorch twin beside it in the same module.

Device rule: there is no silent fallback.  Engines take an explicit
`device`; the default comes from `default_device()`, which is CUDA and
raises when no GPU is present.  `KMER_TPU_PLATFORM=cpu` (the JAX
package's platform knob) selects the CPU explicitly, and there every
kernel runs its plain PyTorch version.

The port imports nothing of `kmer_tpu` (nor jax).  The host code it
shares with the JAX package is copied, not imported: the FASTA/FASTQ
readers (`io/fastx.py`, `io/packing.py`, and the native C++ reader in
`io/native/`, built at first use into build/kmer_tpu_torch/) and the CLI
and log helpers (`utils/cli.py`, `utils/log.py`).
"""

from __future__ import annotations

import os

import torch


def default_device() -> torch.device:
    """The engines' device: CUDA unless KMER_TPU_PLATFORM=cpu."""
    plat = os.environ.get("KMER_TPU_PLATFORM", "").strip().lower()
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        raise ValueError(
            f"KMER_TPU_PLATFORM={plat!r}: kmer_tpu_torch runs on 'cuda' "
            "or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "kmer_tpu_torch: no CUDA device is available; set "
            "KMER_TPU_PLATFORM=cpu to run on the CPU")
    return torch.device("cuda")
