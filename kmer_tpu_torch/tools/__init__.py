"""CLI tools of the PyTorch/CUDA port (dispatch table of `ktc_torch`).

Each entry mirrors one reference binary, as kmer_tpu.tools does."""

from __future__ import annotations

import importlib
from typing import Callable

# tool name -> (module, function)
_TOOLS = {
    "kc-py1": ("kmer_tpu_torch.tools.kc", "main_kc_py1"),
    "kc-cpp1": ("kmer_tpu_torch.tools.kc", "main_kc_cpp1"),
    "kc-cpp2": ("kmer_tpu_torch.tools.kc", "main_kc_cpp2"),
    "kc-c1": ("kmer_tpu_torch.tools.kc", "main_kc_c1"),
    "kc-c2": ("kmer_tpu_torch.tools.kc", "main_kc_c2"),
    "kc-c3": ("kmer_tpu_torch.tools.kc", "main_kc_c3"),
    "kc-c4": ("kmer_tpu_torch.tools.kc", "main_kc_c4"),
    "yak-count": ("kmer_tpu_torch.tools.yak_count", "main"),
    "snp-pattern-gen": ("kmer_tpu_torch.tools.snp_pattern_gen", "main"),
    "vaf-counter": ("kmer_tpu_torch.tools.vaf_counter", "main"),
    "correlation-matrix": ("kmer_tpu_torch.tools.correlation_matrix", "main"),
    "match-classifier": ("kmer_tpu_torch.tools.match_classifier", "main"),
    "ed-vaf-counter": ("kmer_tpu_torch.tools.ed_vaf_counter", "main"),
    "bam-vaf-counter": ("kmer_tpu_torch.tools.bam_vaf_counter", "main"),
    "vcf-vaf-counter": ("kmer_tpu_torch.tools.vcf_vaf_counter", "main"),
}


def get_tool(name: str) -> Callable:
    mod, fn = _TOOLS[name]
    return getattr(importlib.import_module(mod), fn)


def tool_names():
    return sorted(_TOOLS)
