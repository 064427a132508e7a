"""ketopt-workalike command-line parsing (a copy of the part of
kmer_tpu/utils/cli.py that the port's tools call: `ketopt`, `c_atof`,
`c_atoi`; after the reference's ketopt.h:56-118).

Supports optstrings like "k:p:b:t:v" with argument permutation (options
may follow positional arguments, matching ketopt's permute=1 mode used
by every reference tool), "-k31" and "-k 31" forms, and "--" to stop.
"""

from __future__ import annotations

from typing import List, Tuple


def ketopt(argv: List[str], ostr: str) -> Tuple[List[Tuple[str, str]], List[str]]:
    """Parse argv (without program name).  Returns (options, positionals)
    where options is a list of (flag_char, arg_or_empty)."""
    takes_arg = {}
    i = 0
    while i < len(ostr):
        c = ostr[i]
        takes_arg[c] = i + 1 < len(ostr) and ostr[i + 1] == ":"
        i += 2 if takes_arg[c] else 1

    opts: List[Tuple[str, str]] = []
    pos: List[str] = []
    i = 0
    stop = False
    while i < len(argv):
        a = argv[i]
        if stop or not a.startswith("-") or a == "-":
            pos.append(a)
            i += 1
            continue
        if a == "--":
            stop = True
            i += 1
            continue
        j = 1
        while j < len(a):
            c = a[j]
            if c not in takes_arg:
                opts.append(("?", c))
                j += 1
                continue
            if takes_arg[c]:
                if j + 1 < len(a):
                    opts.append((c, a[j + 1 :]))
                else:
                    i += 1
                    opts.append((c, argv[i] if i < len(argv) else ""))
                break
            opts.append((c, ""))
            j += 1
        i += 1
    return opts, pos


def c_atof(s: str) -> float:
    """C atof (strtod) semantics: parse the leading float, 0.0 when
    none (the reference's match-classifier parses -t this way).
    Handles inf/infinity/nan and hex floats like strtod."""
    s = s.strip()
    j = 0
    sign = 1.0
    if j < len(s) and s[j] in "+-":
        if s[j] == "-":
            sign = -1.0
        j += 1
    low = s[j:].lower()
    if low.startswith("infinity") or low.startswith("inf"):
        return sign * float("inf")
    if low.startswith("nan"):
        return sign * float("nan")
    if low.startswith("0x"):
        # strtod hex float: longest valid prefix (sign is part of s)
        for end in range(len(s), j + 1, -1):
            try:
                return float.fromhex(s[:end])
            except ValueError:
                continue
    while j < len(s) and s[j].isdigit():
        j += 1
    if j < len(s) and s[j] == ".":
        j += 1
        while j < len(s) and s[j].isdigit():
            j += 1
    if j < len(s) and s[j] in "eE":
        e = j + 1
        if e < len(s) and s[e] in "+-":
            e += 1
        d = e
        while d < len(s) and s[d].isdigit():
            d += 1
        if d > e:
            j = d
    try:
        return float(s[:j])
    except ValueError:
        return 0.0


def c_atoi(s: str) -> int:
    """C atoi/atol semantics for numeric flags: parse the leading
    decimal integer (optional sign), ignore trailing characters, 0 when
    none — the reference tools parse every numeric option this way
    (e.g. `yak-count -K100m` means 100)."""
    s = s.strip()
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[:j])
