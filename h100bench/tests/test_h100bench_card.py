"""On a card: each cell once through run.py, a short window; `correct`
must be true and the line well formed.  Skips without a card."""

import json
import os
import subprocess
import sys

import pytest

from h100bench import spec
from h100bench.tests.helpers import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, os.path.join("h100bench", "run.py"), "--workload",
         cell, "--seed", str(2**31 + 99), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
