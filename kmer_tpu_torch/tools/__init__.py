"""CLI tools of the PyTorch/CUDA port (dispatch table of `ktc_torch`).

Each entry mirrors one reference binary, as kmer_tpu.tools does."""

from __future__ import annotations

import importlib
from typing import Callable

# tool name -> (module, function)
_TOOLS = {
    "kc-c1": ("kmer_tpu_torch.tools.kc", "main_kc_c1"),
    "kc-c2": ("kmer_tpu_torch.tools.kc", "main_kc_c2"),
    "kc-c3": ("kmer_tpu_torch.tools.kc", "main_kc_c3"),
    "kc-c4": ("kmer_tpu_torch.tools.kc", "main_kc_c4"),
    "yak-count": ("kmer_tpu_torch.tools.yak_count", "main"),
}


def get_tool(name: str) -> Callable:
    mod, fn = _TOOLS[name]
    return getattr(importlib.import_module(mod), fn)


def tool_names():
    return sorted(_TOOLS)
