"""The k-mer counter family (port of kmer_tpu/tools/kc.py): kc-c1..c4 on
the PyTorch/CUDA engine, and kc-py1, kc-cpp1 and kc-cpp2, the
raw-string-keyed baselines, as host code copied from the JAX package.

Same flags, defaults, usage and error text, and the same stdout: 255
`count\tnum_distinct` rows, printed by process 0 alone in a run of
several processes (utils.log.is_primary).  The -p/-t flags are accepted
for CLI parity; the engine is pipeline.counter.make_count_engine's.
"""

from __future__ import annotations

import sys

from ..pipeline.counter import make_count_engine
from ..utils.cli import c_atoi, ketopt
from ..utils.log import is_primary

KC_BITS = 10  # kc-c2.c:10 / kc-c4.c:11


def _print_hist(hist, lo=1, hi=256):
    if not is_primary():  # one histogram a run, not one a process
        return
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




# ---------------------------------------------------------------------------
# kc-py1 / kc-cpp1 / kc-cpp2: the raw-STRING-keyed baselines.  Unlike the
# bit-packed counters these keep k-mers as text, which gives them
# idiosyncratic exact semantics on non-clean input (lowercase letters are
# distinct keys, non-ACGT characters stay in keys, FASTQ parses as
# line-FASTA so '@'/'+'/quality lines become sequence).  They are
# perf-irrelevant baselines, so a host dict reproduces them byte-for-byte
# on ARBITRARY input (fuzzed vs the originals in scripts/fuzz_parity.py).

_RAW_COMP = str.maketrans("ACGT", "TGCA")


def _count_raw_strings(h: dict, k: int, seq: str) -> None:
    """Canonical counting on raw text: lexicographic min of the window
    and its ACGT-complement reversal (other characters pass through the
    complement unchanged), skipping windows containing a capital 'N'
    (kc-py1.py:9-20 / kc-cpp1.cpp:11-28)."""
    if len(seq) < k:
        return
    get = h.get
    for i in range(len(seq) - k + 1):
        fwd = seq[i : i + k]
        if "N" in fwd:
            continue
        rev = fwd.translate(_RAW_COMP)[::-1]
        key = fwd if fwd < rev else rev
        h[key] = get(key, 0) + 1


def _print_raw_hist(h: dict) -> None:
    hist = [0] * 256
    for cnt in h.values():
        hist[cnt if cnt < 255 else 255] += 1
    _print_hist(hist)


def _cpp_counter(tool_name):
    """kc-cpp1 (std::unordered_map) and kc-cpp2 (robin_hood) differ only
    in the map implementation, which a histogram cannot observe — both
    also print 'kc-cpp1' in their usage line (kc-cpp2.cpp:65 kept the
    copy-pasted string; reproduced deliberately)."""

    def main(argv=None):
        argv = sys.argv[1:] if argv is None else argv
        k = 31
        opts, pos = ketopt(argv, "k:")
        for c, a in opts:
            if c == "k":
                k = c_atoi(a)
        if len(pos) < 1:
            # the C++ originals print usage to STDOUT (kc-cpp1.cpp:65)
            sys.stdout.write(f"Usage: kc-cpp1 [-k {k}] <in.fa>\n")
            return 1
        if k < 0:
            # negative k: size_t underflow in the originals' window loop
            # walks substr past the end -> uncaught std::out_of_range
            # abort; k == 0 is DEFINED there (substr(i, 0) == "" for
            # every i <= length, so the empty-string key accumulates
            # len+1 counts per record) and _count_raw_strings reproduces
            # it naturally
            sys.stderr.write("ERROR: -k must be non-negative\n")
            return 1
        try:
            with open(pos[0], "rb") as f:
                data = f.read()
        except OSError:
            # a failed ifstream reads nothing: the originals print an
            # all-zero histogram and exit 0 (kc-cpp1.cpp:31-35)
            data = b""
        # getline splits on '\n' (keeping '\r'); a trailing newline does
        # not produce a final empty line
        lines = data.split(b"\n")
        if data.endswith(b"\n"):
            lines.pop()
        h: dict = {}
        parts = []

        def flush():
            # EVERY record is uppercased in place (kc-cpp1.cpp:13);
            # latin-1 makes str comparison == byte comparison
            s = b"".join(parts).upper().decode("latin-1")
            if not s:
                return
            if len(s) < k:
                # reference UB again (size_t underflow -> abort with no
                # output); fail cleanly instead (PARITY.md divergence 4)
                sys.stderr.write(
                    f"ERROR: sequence shorter than k={k} (the C++ "
                    "original aborts here)\n"
                )
                raise SystemExit(1)
            _count_raw_strings(h, k, s)

        for line in lines:
            if line[:1] == b">":
                flush()
                parts = []
            else:
                parts.append(line)
        flush()
        _print_raw_hist(h)
        return 0

    main.__name__ = f"main_{tool_name}"
    return main


main_kc_cpp1 = _cpp_counter("kc_cpp1")
main_kc_cpp2 = _cpp_counter("kc_cpp2")


def main_kc_py1(argv=None):
    """FASTA from stdin, fixed k=31 (kc-py1.py:45).  Quirks reproduced
    exactly: every non-header line loses its LAST character whether or
    not it is a newline (kc-py1.py:31), and only the final record is
    uppercased (kc-py1.py:34 vs 27)."""
    h: dict = {}
    parts = []
    for line in sys.stdin:
        if line[:1] == ">":
            if parts:
                _count_raw_strings(h, 31, "".join(parts))
                parts = []
        else:
            parts.append(line[:-1])
    if parts:
        _count_raw_strings(h, 31, "".join(parts).upper())
    _print_raw_hist(h)
    return 0
