"""kc-c1..c4 on the PyTorch/CUDA engine (port of kmer_tpu/tools/kc.py:29-184).

Same flags, defaults, usage and error text, and the same stdout: 255
`count\tnum_distinct` rows.  The -p/-t flags are accepted for CLI parity;
the engine is one device (kmer_tpu_torch.pipeline.counter).
"""

from __future__ import annotations

import sys

from ..pipeline.counter import make_count_engine
from ..utils.cli import c_atoi, ketopt

KC_BITS = 10  # kc-c2.c:10 / kc-c4.c:11


def _print_hist(hist, lo=1, hi=256):
    out = []
    for i in range(lo, hi):
        out.append(f"{i}\t{hist[i]}")
    sys.stdout.write("\n".join(out) + "\n")


class _HistEngine:
    """Adapter: run the sort-based engine, expose .hist(n_bins).

    Count saturation (255 for kc-c2/c3, 1023 for kc-c4, none for kc-c1)
    never changes a 256-bin display histogram, so all frontends share
    the unsaturated engine."""

    def __init__(self, paths, k, block_bases=10_000_000, qual_policy=None):
        self.eng = make_count_engine(k=k, block_bases=block_bases,
                                     qual_policy=qual_policy)
        self.eng.count_paths(paths)

    def hist(self, n_bins):
        return self.eng.hist(n_bins, max_count=None)


def _run_counter(paths, k, max_count, block_bases=10_000_000,
                 qual_policy=None):
    """Count, or return None after a clean error message."""
    try:
        return _HistEngine(paths, k, block_bases, qual_policy)
    except OSError:
        sys.stderr.write(f"Error: failed to open {paths[0]}\n")
        return None


def main_kc_c1(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    k = 31
    opts, pos = ketopt(argv, "k:")
    for c, a in opts:
        if c == "k":
            k = c_atoi(a)
    if len(pos) < 1:
        sys.stderr.write(f"Usage: kc-c1 [-k {k}] <in.fa>\n")
        return 1
    if k < 1 or k > 32:
        sys.stderr.write("ERROR: -k must be between 1 and 32\n")
        return 1
    eng = _run_counter([pos[0]], k, max_count=None)
    if eng is None:
        return 1
    _print_hist(eng.hist(256))
    return 0


def main_kc_c2(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    k, p = 31, KC_BITS
    opts, pos = ketopt(argv, "k:p:")
    for c, a in opts:
        if c == "k":
            k = c_atoi(a)
        elif c == "p":
            p = c_atoi(a)
    if len(pos) < 1:
        sys.stderr.write(f"Usage: kc-c2 [-k {k}] [-p {p}] <in.fa>\n")
        return 1
    if p < KC_BITS:
        sys.stderr.write(f"ERROR: -p should be at least {KC_BITS}\n")
        return 1
    if k < 1 or k > 32:
        sys.stderr.write("ERROR: -k must be between 1 and 32\n")
        return 1
    eng = _run_counter([pos[0]], k, max_count=255)
    if eng is None:
        return 1
    _print_hist(eng.hist(256))
    return 0


def main_kc_c3(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    k, p, block_size = 31, KC_BITS, 10_000_000
    opts, pos = ketopt(argv, "k:p:b:")
    for c, a in opts:
        if c == "k":
            k = c_atoi(a)
        elif c == "p":
            p = c_atoi(a)
        elif c == "b":
            block_size = c_atoi(a)
    if len(pos) < 1:
        sys.stderr.write("Usage: kc-c3 [options] <in.fa>\n")
        sys.stderr.write("Options:\n")
        sys.stderr.write(f"  -k INT     k-mer size [{k}]\n")
        sys.stderr.write(f"  -p INT     prefix length [{p}]\n")
        sys.stderr.write(f"  -b INT     block size [{block_size}]\n")
        return 1
    if p < KC_BITS:
        sys.stderr.write(f"ERROR: -p should be at least {KC_BITS}\n")
        return 1
    if k < 1 or k > 32:
        sys.stderr.write("ERROR: -k must be between 1 and 32\n")
        return 1
    eng = _run_counter([pos[0]], k, max_count=255, block_bases=block_size,
                       qual_policy=("resume", 0, 2))  # kc-c3: 2 workers, sums ALL reads
    if eng is None:
        return 1
    _print_hist(eng.hist(256))
    return 0


def main_kc_c4(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    k, p, block_size, n_thread = 31, KC_BITS, 10_000_000, 4
    opts, pos = ketopt(argv, "k:p:b:t:")
    for c, a in opts:
        if c == "k":
            k = c_atoi(a)
        elif c == "p":
            p = c_atoi(a)
        elif c == "b":
            block_size = c_atoi(a)
        elif c == "t":
            n_thread = c_atoi(a)
    if len(pos) < 1:
        sys.stderr.write("Usage: kc-c4 [options] <in.fa>\n")
        sys.stderr.write("Options:\n")
        sys.stderr.write(f"  -k INT     k-mer size [{k}]\n")
        sys.stderr.write(f"  -p INT     prefix length [{p}]\n")
        sys.stderr.write(f"  -b INT     block size [{block_size}]\n")
        sys.stderr.write(f"  -t INT     number of worker threads [{n_thread}]\n")
        return 1
    if p < KC_BITS:
        sys.stderr.write(f"ERROR: -p should be at least {KC_BITS}\n")
        return 1
    if k < 1 or k > 32:
        sys.stderr.write("ERROR: -k must be between 1 and 32\n")
        return 1
    eng = _run_counter([pos[0]], k, max_count=1023, block_bases=block_size,
                       qual_policy=("resume", k, 3))
    if eng is None:
        return 1
    _print_hist(eng.hist(256))
    return 0
