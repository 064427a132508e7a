"""ed-vaf-counter of the port (kmer_tpu_torch.kernels.myers and
kmer_tpu_torch.tools.ed_vaf_counter) against the JAX package on the CPU:
the Myers scans lane for lane on tests/test_myers.py's random cases and
on csrc/myers.cu's edge cases (tests/torch_myers_cases.py), a plain
model of the kernel's left-aligned, mask-free recurrence on those cases,
the per-pattern sums, the kernel wrappers' refusals, the VAF files byte
for byte on the fixture patterns (also over many small batches), and the
host helpers the tool copies against their originals.

Inputs are made with numpy from a seed; the same inputs go to both
packages.  Every output is an integer or a file: every comparison is
exact (tolerance 0).  Each JAX tool run is computed once per module."""

import contextlib
import gzip
import inspect
import io
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmer_tpu.kernels import myers as J
from kmer_tpu.tools import ed_vaf_counter as JT
from kmer_tpu_torch.kernels import myers as T
from kmer_tpu_torch.tools import ed_vaf_counter as TT
from tests.test_myers import _random_case
from torch_myers_cases import EVERY_LANE, MYERS_CASES, myers_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
A1 = os.path.join(FIXTURES, "sampleA1.fq.gz")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- the Myers scans ------------------------------------------------------

@pytest.mark.parametrize("max_e", [0, 1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_single_word_matches_jax(seed, max_e):
    """Patterns of 5..32 bases (32 fills the word, so `+` wraps), reads
    of 1..200 bases with planted exact and 1-error copies, a zero-length
    read and a padding lane (code 255, which never matches)."""
    rng = np.random.default_rng(11 + 10 * seed + max_e)
    pc, plen, codes, lens = _random_case(
        rng, n_pat=24, pat_lens=[5, 13, 21, 31, 32], n_reads=60,
        read_max=200)
    lens[3] = 0
    peq = J.build_peq(jnp.asarray(pc), jnp.asarray(plen))
    want = np.asarray(J.myers_hw_counts(peq, jnp.asarray(plen),
                                        jnp.asarray(codes),
                                        jnp.asarray(lens), max_e))
    tpeq = T.build_peq(_t(pc), _t(plen))
    assert tpeq.dtype == torch.int32
    assert np.array_equal(tpeq.numpy().view(np.uint32), np.asarray(peq))
    got = T.myers_hw_counts(tpeq, _t(plen), _t(codes), _t(lens), max_e)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (want[3] == 0).all() and want.sum() > 0


@pytest.mark.parametrize("max_e", [0, 1, 2])
@pytest.mark.parametrize("pat_lens,n_words", [([33, 41, 64, 65, 97], 4),
                                              ([5, 21, 32], 2),
                                              ([40], 2)])
def test_multiword_matches_jax(pat_lens, n_words, max_e):
    """Patterns past one word (carries across 2-4 words), and short ones
    in a wider state; zero-length reads contribute 0."""
    rng = np.random.default_rng(101 + max_e + len(pat_lens))
    pc, plen, codes, lens = _random_case(
        rng, n_pat=12, pat_lens=pat_lens, n_reads=40, read_max=300)
    lens[[0, 5]] = 0
    peq = J.build_peq_multiword(jnp.asarray(pc), jnp.asarray(plen), 4,
                                n_words)
    want = np.asarray(J.myers_hw_counts_multiword(
        peq, jnp.asarray(plen), jnp.asarray(codes), jnp.asarray(lens),
        max_e, n_words))
    tpeq = T.build_peq_multiword(_t(pc), _t(plen), 4, n_words)
    assert np.array_equal(tpeq.numpy().view(np.uint32), np.asarray(peq))
    got = T.myers_hw_counts_multiword(tpeq, _t(plen), _t(codes), _t(lens),
                                      max_e, n_words)
    assert np.array_equal(got.numpy(), want)
    assert (want[[0, 5]] == 0).all() and want.sum() > 0
    if min(pat_lens) > 32:  # the numpy oracle, the copy and the original
        for i in range(3):
            pat = pc[i, :plen[i]].tolist()
            assert np.array_equal(
                T.hw_counts_long_pattern(pat, codes, lens, max_e), want[:, i])
            assert (T.hw_counts_long_pattern(pat, codes, lens, max_e)
                    == J.hw_counts_long_pattern(pat, codes, lens, max_e))


def test_empty_batch_and_alphabet():
    """No reads: an empty (0, P) result.  A larger alphabet (n_alpha 6)
    with codes past it in the reads."""
    rng = np.random.default_rng(5)
    pc, plen, codes, lens = _random_case(rng, n_pat=8, pat_lens=[9, 20],
                                         n_reads=30, read_max=90, n_alpha=6)
    codes[::4, ::7] = 9  # read bytes outside the pattern alphabet
    tpeq = T.build_peq(_t(pc), _t(plen), 6)
    got = T.myers_hw_counts(tpeq, _t(plen), _t(codes[:0]), _t(lens[:0]), 1)
    assert got.shape == (0, 8)
    peq = J.build_peq(jnp.asarray(pc), jnp.asarray(plen), 6)
    want = np.asarray(J.myers_hw_counts(peq, jnp.asarray(plen),
                                        jnp.asarray(codes),
                                        jnp.asarray(lens), 1))
    got = T.myers_hw_counts(tpeq, _t(plen), _t(codes), _t(lens), 1)
    assert np.array_equal(got.numpy(), want) and want.sum() > 0


def test_long_pattern_oracle_is_a_verbatim_copy():
    src = inspect.getsource(T.hw_counts_long_pattern)
    assert src == inspect.getsource(J.hw_counts_long_pattern)


# -- the kernels' plain twins on csrc/myers.cu's edge cases ---------------

@pytest.mark.parametrize("name", sorted(MYERS_CASES))
def test_plain_matches_jax_on_kernel_edge_cases(name):
    """The plain versions (which tests/test_torch_cuda.py holds the
    kernels to on the same cases) against JAX, lane for lane: pattern
    lengths 0, 1 and 32 in one batch; n_alpha 1 and 20 with read codes
    past the alphabet; reads of 1,025-1,500 bases in the 4,096 bucket;
    zero-length reads only; W = 9 words (patterns of up to 288 bases).
    Each at the case's max_e and at EVERY_LANE, where every lane's count
    shows."""
    pc, plen, codes, lens, n_alpha, n_words, max_e = myers_case(name)
    args = [jnp.asarray(x) for x in (plen, codes, lens)]
    targs = [_t(x) for x in (plen, codes, lens)]
    if n_words is None:
        peq = J.build_peq(jnp.asarray(pc), args[0], n_alpha)
        tpeq = T.build_peq(_t(pc), targs[0], n_alpha)
    else:
        peq = J.build_peq_multiword(jnp.asarray(pc), args[0], n_alpha,
                                    n_words)
        tpeq = T.build_peq_multiword(_t(pc), targs[0], n_alpha, n_words)
    assert np.array_equal(tpeq.numpy().view(np.uint32), np.asarray(peq))
    for e in (max_e, EVERY_LANE):
        if n_words is None:
            want = np.asarray(J.myers_hw_counts(peq, *args, e))
            got = T.myers_hw_counts_plain(tpeq, *targs, e)
            public = T.myers_hw_counts(tpeq, *targs, e)
        else:
            want = np.asarray(J.myers_hw_counts_multiword(peq, *args, e,
                                                          n_words))
            got = T.myers_hw_counts_multiword_plain(tpeq, *targs, e,
                                                    n_words)
            public = T.myers_hw_counts_multiword(tpeq, *targs, e, n_words)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        assert torch.equal(public, got)
        if name == "zero_length_reads":
            assert not want.any()
        elif e == EVERY_LANE:  # every lane of a non-empty read counts
            assert (want[lens > 0] >= 1).all()
        else:
            assert want.sum() > 0


_M32 = (1 << 32) - 1


def _left_aligned_model(peq, plen, codes, lens, max_e, n_words):
    """csrc/myers.cu myers_regs' recurrence as plain torch, on int64
    lanes holding uint32 words: each pattern's W-word Peq shifted left by
    32 W - m bits, so its last base sits at bit 31 of word W - 1 (Peq 0
    for m = 0 and m > 32 W), pv all ones and mv 0 at the start, the
    carry rippling from word 0 up, no mask anywhere, and the score moved
    by bit 31 of the top word's ph and mh."""
    W = 1 if n_words is None else n_words
    peq = peq.to(torch.int64) & _M32
    if n_words is None:
        peq = peq[:, None, :]
    P, _, n_alpha = peq.shape
    m = plen.to(torch.int64)
    tab = torch.zeros((W, n_alpha + 1, P), dtype=torch.int64)
    for p in range(P):
        mp = int(m[p])
        if not 1 <= mp <= 32 * W:
            continue
        for c in range(n_alpha):
            v = sum(int(peq[p, w, c]) << (32 * w) for w in range(W))
            v <<= 32 * W - mp
            for w in range(W):
                tab[w, c, p] = (v >> (32 * w)) & _M32
    R = codes.shape[0]
    pv = [torch.full((R, P), _M32, dtype=torch.int64) for _ in range(W)]
    mv = [torch.zeros((R, P), dtype=torch.int64) for _ in range(W)]
    score = m[None, :].expand(R, P).clone()
    best = torch.full((R, P), 0x3FFFFFFF, dtype=torch.int64)
    cnt = torch.zeros((R, P), dtype=torch.int64)
    lens = lens.to(torch.int64).clamp(0, codes.shape[1])
    for t in range(int(lens.max()) if R else 0):
        c = codes[:, t].to(torch.int64).clamp(max=n_alpha)
        v = (t < lens)[:, None]
        carry = 0
        x, ph, mh = [], [], []
        for w in range(W):
            eq = tab[w][c]
            x.append(eq | mv[w])
            s = (eq & pv[w]) + pv[w] + carry
            carry = s >> 32
            xh = ((s & _M32) ^ pv[w]) | x[w]
            ph.append(mv[w] | (~(xh | pv[w]) & _M32))
            mh.append(pv[w] & xh)
        new_score = score + (ph[-1] >> 31) - (mh[-1] >> 31)
        for w in range(W):
            ph2 = ((ph[w] << 1) | (ph[w - 1] >> 31 if w else 0)) & _M32
            mh2 = ((mh[w] << 1) | (mh[w - 1] >> 31 if w else 0)) & _M32
            pv[w] = torch.where(v, mh2 | (~(x[w] | ph2) & _M32), pv[w])
            mv[w] = torch.where(v, ph2 & x[w], mv[w])
        score = torch.where(v, new_score, score)
        lt = v & (score < best)
        same = v & (score == best)
        cnt = torch.where(lt, 1, torch.where(same, cnt + 1, cnt))
        best = torch.where(lt, score, best)
    return torch.where(best <= max_e, cnt, 0).to(torch.int32)


def _jax_counts(name, e):
    """JAX myers_hw_counts{,_multiword} on a tests/torch_myers_cases.py
    case at max_e e, with the port's inputs for it."""
    pc, plen, codes, lens, n_alpha, n_words, max_e = myers_case(name)
    args = [jnp.asarray(x) for x in (plen, codes, lens)]
    if n_words is None:
        peq = J.build_peq(jnp.asarray(pc), args[0], n_alpha)
        want = J.myers_hw_counts(peq, *args, e)
        tpeq = T.build_peq(_t(pc), _t(plen), n_alpha)
    else:
        peq = J.build_peq_multiword(jnp.asarray(pc), args[0], n_alpha,
                                    n_words)
        want = J.myers_hw_counts_multiword(peq, *args, e, n_words)
        tpeq = T.build_peq_multiword(_t(pc), _t(plen), n_alpha, n_words)
    return want, (tpeq, _t(plen), _t(codes), _t(lens)), n_words, max_e


@pytest.mark.parametrize("name", sorted(MYERS_CASES))
def test_left_aligned_model_matches_jax(name):
    """The kernel's mask-free recurrence on left-aligned patterns gives
    JAX's counts lane for lane on every edge case (m = 0, 1 and 32 in one
    word; W = 9 with patterns of 33 to 288 bases, most spanning fewer
    words than W; alphabets of 1 and 20 codes with read codes past them;
    empty reads), at the case's max_e and at EVERY_LANE."""
    max_e = MYERS_CASES[name][-1]
    for e in (max_e, EVERY_LANE):
        want, targs, n_words, _ = _jax_counts(name, e)
        got = _left_aligned_model(*targs, e, n_words)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(MYERS_CASES))
def test_sums_match_jax(name):
    """myers_hw_sums{,_multiword} on CPU tensors: JAX's int32 sum over the
    reads (kmer_tpu/tools/ed_vaf_counter.py:153), as int64, added into
    the total they are given, at max_e and at EVERY_LANE."""
    max_e = MYERS_CASES[name][-1]
    for e in (max_e, EVERY_LANE):
        want, (peq, plen, codes, lens), n_words, _ = _jax_counts(name, e)
        want = np.asarray(jnp.sum(want, axis=0, dtype=jnp.int32)).astype(
            np.int64)
        base = torch.arange(plen.shape[0], dtype=torch.int64) * 1000
        total = base.clone()
        if n_words is None:
            got = T.myers_hw_sums(peq, plen, codes, lens, e, total)
        else:
            got = T.myers_hw_sums_multiword(peq, plen, codes, lens, e,
                                            n_words, total)
        assert got is total and got.dtype == torch.int64
        assert np.array_equal((got - base).numpy(), want)


def _wrapper_args(multiword):
    pc, plen, codes, lens, n_alpha, n_words, max_e = myers_case(
        "multiword_w9" if multiword else "m_0_1_21_32")
    build = ((lambda c, m: T.build_peq_multiword(c, m, n_alpha, n_words))
             if multiword else (lambda c, m: T.build_peq(c, m, n_alpha)))
    args = {"peq": build(_t(pc), _t(plen)), "pat_len": _t(plen),
            "reads_codes": _t(codes), "read_len": _t(lens), "max_e": max_e}
    if multiword:
        args["n_words"] = n_words
    return args


_BAD_INPUTS = {
    "cpu_tensors": ({}, "CUDA tensors"),
    "int64_peq": ({"peq": lambda a: a["peq"].long()}, "int32 peq"),
    "int64_pat_len": ({"pat_len": lambda a: a["pat_len"].long()}, "int32"),
    "int32_codes": ({"reads_codes": lambda a: a["reads_codes"].int()},
                    "uint8 read codes"),
    "short_pat_len": ({"pat_len": lambda a: a["pat_len"][1:]}, "pat_len"),
    "short_read_len": ({"read_len": lambda a: a["read_len"][1:]},
                       "read_len"),
    "flat_codes": ({"reads_codes": lambda a: a["reads_codes"].reshape(-1)},
                   "read codes"),
    # one word: a (P, 1, n_alpha) plane; W words: n_words not the plane's
    "other_words": ({"peq": lambda a: a["peq"] if "n_words" in a
                     else a["peq"][:, None],
                     "n_words": lambda a: 8}, "need peq"),
    "alphabet_257": ({"peq": lambda a: torch.zeros(
        (*a["peq"].shape[:-1], 257), dtype=torch.int32)}, "256 alphabet"),
    "max_e_2_31": ({"max_e": lambda a: 1 << 31}, "int32"),
}


@pytest.mark.parametrize("multiword", [False, True])
@pytest.mark.parametrize("bad", sorted(_BAD_INPUTS))
def test_kernel_wrappers_refuse_what_the_kernel_does_not_take(bad,
                                                              multiword):
    """myers_hw_counts{,_multiword}_kernel raise ValueError on CPU
    tensors, a wrong dtype, mismatched shapes or word counts, an alphabet
    past 256 codes and a max_e past int32, before any launch (no card
    here)."""
    args = _wrapper_args(multiword)
    change, match = _BAD_INPUTS[bad]
    for key, fn in change.items():
        if key in args:
            args[key] = fn(args)
    fn = (T.myers_hw_counts_multiword_kernel if multiword
          else T.myers_hw_counts_kernel)
    with pytest.raises(ValueError, match=match):
        fn(**args)


_BAD_TOTALS = {
    "int32_total": (lambda P: torch.zeros(P, dtype=torch.int32), "int64"),
    "short_total": (lambda P: torch.zeros(P - 1, dtype=torch.int64),
                    "int64 total"),
    "strided_total": (lambda P: torch.zeros(2 * P, dtype=torch.int64)[::2],
                      "contiguous"),
}


@pytest.mark.parametrize("multiword", [False, True])
@pytest.mark.parametrize("bad", sorted(_BAD_INPUTS) + sorted(_BAD_TOTALS))
def test_sum_wrappers_refuse_what_the_kernel_does_not_take(bad, multiword):
    """myers_hw_sums{,_multiword}_kernel refuse what the counts' wrappers
    refuse, and a total that is not int64 (P,) contiguous on the inputs'
    device, before any launch (no card here)."""
    args = _wrapper_args(multiword)
    P = args["pat_len"].shape[0]
    args["total"] = torch.zeros(P, dtype=torch.int64)
    if bad in _BAD_TOTALS:
        make, match = _BAD_TOTALS[bad]
        args["total"] = make(P)
        # a total on the CPU beside inputs on it: the device check first
        # refuses the CPU inputs, so state the total's own refusal alone
        fn = T._check_total
        with pytest.raises(ValueError, match=match):
            fn("myers_hw_sums_kernel", args["total"], P, torch.device("cpu"))
        return
    change, match = _BAD_INPUTS[bad]
    for key, fn in change.items():
        if key in args:
            args[key] = fn(args)
    fn = (T.myers_hw_sums_multiword_kernel if multiword
          else T.myers_hw_sums_kernel)
    with pytest.raises(ValueError, match=match):
        fn(**args)


def test_public_names_never_load_the_kernel_library_on_cpu(monkeypatch):
    """On CPU tensors the public names run the plain versions and never
    build or load csrc/myers.cu's library."""
    from kmer_tpu_torch.kernels import _build

    def no_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "library", no_library)
    for multiword in (False, True):
        args = _wrapper_args(multiword)
        public = (T.myers_hw_counts_multiword if multiword
                  else T.myers_hw_counts)
        plain = (T.myers_hw_counts_multiword_plain if multiword
                 else T.myers_hw_counts_plain)
        assert torch.equal(public(**args), plain(**args))
        P = args["pat_len"].shape[0]
        total = torch.zeros(P, dtype=torch.int64)
        sums = (T.myers_hw_sums_multiword if multiword else T.myers_hw_sums)
        assert torch.equal(sums(**args, total=total),
                           plain(**args).sum(0, dtype=torch.int64))
    assert not any(_build.LAUNCHES[k] for k in ("myers", "myers_multiword"))


def test_myers_cu_defines_every_bound_entry_point():
    """Every ktt_myers* entry that kernels/_build.py binds is defined in
    csrc/myers.cu with as many parameters as its ctypes signature, and
    the register-form word limit is the wrapper's REG_WORDS."""
    import re

    from kmer_tpu_torch.kernels import _build

    with open(os.path.join(_build.CSRC, "myers.cu")) as f:
        src = f.read()
    entries = {n: a for n, a in _build._SIGNATURES.items()
               if n.startswith("ktt_myers")}
    assert set(entries) == {"ktt_myers", "ktt_myers_multiword",
                            "ktt_myers_sums", "ktt_myers_multiword_sums",
                            "ktt_myers_shape"}
    for name, argtypes in entries.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert len(params) == len(argtypes), name
    assert f"constexpr int kRegWords = {T.REG_WORDS};" in src
    assert {"myers", "myers_multiword"} <= set(_build.LAUNCHES)


# -- the tool -------------------------------------------------------------

def _run(pkg, args, d, monkeypatch):
    """(rc, stderr, {file: bytes}) of one ed-vaf-counter run in d."""
    import importlib

    os.makedirs(d, exist_ok=True)
    monkeypatch.chdir(d)
    for fn in os.listdir(d):
        if fn.endswith(".vaf"):
            os.remove(fn)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = importlib.import_module(f"{pkg}.tools").get_tool(
            "ed-vaf-counter")(list(args))
    files = {}
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".vaf"):
            with open(fn, "rb") as f:
                files[fn] = f.read()
    return rc, err.getvalue(), files


@pytest.fixture(scope="module")
def patterns(tmp_path_factory):
    """The fixture pattern file: snp-pattern-gen -k21 on genome_small +
    snps_small.bed (the port's tool; tests/test_torch_snp_tools.py holds
    it to JAX's)."""
    from kmer_tpu_torch.tools import get_tool

    d = tmp_path_factory.mktemp("ed_patterns")
    pat = str(d / "p.pat")
    with pytest.MonkeyPatch.context() as m, \
            contextlib.redirect_stderr(io.StringIO()):
        m.setenv("KMER_TPU_PLATFORM", "cpu")
        assert get_tool("snp-pattern-gen")(
            ["-k21", "-b", os.path.join(FIXTURES, "snps_small.bed"), "-f",
             os.path.join(FIXTURES, "genome_small.fa.gz"), "-o", pat]) == 0
    return pat


@pytest.fixture(scope="module")
def crafted(tmp_path_factory):
    """A pattern file with patterns of 21, 41 and 33 bases (the last two
    through the multiword batch), an alt longer and one shorter than its
    ref, a lowercase and an N pattern; reads of 1 to 3000 bases (the
    1024 and 4096 buckets) drawn from the patterns' random genome, some
    lowercase or with an N, in a gzipped FASTQ
    (tests/test_golden_vaf_tools.py's long-read case, extended)."""
    d = tmp_path_factory.mktemp("ed_crafted")
    rng = np.random.default_rng(4)
    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 30000)].tobytes()
    g = g.decode()
    rows = []
    for i, k in [(0, 21), (1, 41), (2, 33), (3, 21), (4, 25)]:
        pos = 3000 + i * 5000
        ref = g[pos - k // 2:pos + k // 2 + 1]
        alt_base = "A" if g[pos] != "A" else "C"
        alt = ref[:k // 2] + alt_base + ref[k // 2 + 1:]
        if i == 3:
            alt += "GT"  # longer than its ref: truncated
        if i == 4:
            alt = alt[:19]  # shorter: NUL-padded
        rows.append(f"chr1\t{pos}\t{pos + 1}\trs{i}\t{g[pos]}\t{alt_base}\t"
                    f"{ref}\t{alt}")
    rows.append("chr2\t10\t11\trs5\tA\tC\tacgtacgtacgtacgtacgta\t"
                "acgtacgtaccgtacgtacgt")
    rows.append("chr2\t20\t21\trs6\tG\tT\tGGGGGNGGGGGGGGGGGGGGG\t"
                "GGGGGNGGGGTGGGGGGGGGG")
    pat = str(d / "p.txt")
    with open(pat, "w") as f:
        f.write("\n".join(rows) + "\n")
    fq = str(d / "r.fq.gz")
    with gzip.open(fq, "wb") as f:
        for r in range(40):
            L = int(rng.integers(1, 3000)) if r % 4 else int(
                rng.integers(60, 200))
            st = int(rng.integers(0, len(g) - L))
            s = g[st:st + L]
            if r % 5 == 0:
                s = s.lower()
            if r % 7 == 0:
                s = s[:L // 2] + "N" + s[L // 2 + 1:]
            f.write(f"@r{r}\n{s}\n+\n{'I' * L}\n".encode())
        f.write(b"@empty\n\n+\n\n")
        f.write(b"@nrun\nTTGGGGGNGGGGGGGGGGGGGGGTT\n+\n" + b"I" * 25 + b"\n")
    return pat, fq


_want = {}


def _jax(key, args, d, monkeypatch):
    if key not in _want:
        _want[key] = _run("kmer_tpu", args, d, monkeypatch)
    return _want[key]


@pytest.fixture(scope="module")
def a1_head(tmp_path_factory):
    """sampleA1's first 2,048 reads (one batch), gzipped."""
    fq = str(tmp_path_factory.mktemp("ed_reads") / "a1_head.fq.gz")
    with gzip.open(A1, "rb") as f, gzip.open(fq, "wb") as g:
        g.writelines(f.readline() for _ in range(4 * 2048))
    return fq


@pytest.mark.parametrize("max_e", [0, 1, 2])
def test_fixture_vaf_matches_jax(max_e, patterns, a1_head, tmp_path,
                                 monkeypatch):
    """The fixture patterns (384 sites) over sampleA1's first 2,048
    reads: the VAF file and stderr equal JAX's (the whole file runs in
    chip_smoke.py's fixture phase, card against CPU)."""
    args = [f"-e{max_e}", "-p", patterns, "-o", "a.vaf", a1_head]
    want = _jax(("fixture", max_e), args, str(tmp_path / "jax"), monkeypatch)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    got = _run("kmer_tpu_torch", args, str(tmp_path / "port"), monkeypatch)
    assert want[0] == 0 and list(want[2]) == ["a.vaf"]
    assert got == want
    counts = [ln.split("\t") for ln in want[2]["a.vaf"].decode().splitlines()]
    assert sum(int(r[7]) for r in counts[2:]) > 0


@pytest.mark.parametrize("max_e", [0, 2])
def test_long_patterns_and_reads_match_jax(max_e, crafted, tmp_path,
                                           monkeypatch):
    """Patterns longer than 32 bases (the multiword batch), alt k-mers
    longer and shorter than their ref, raw-byte matching (lowercase, N),
    reads past 1024 bases and an empty read; two inputs, the second
    missing (skipped with a warning)."""
    pat, fq = crafted
    args = [f"-e{max_e}", "-p", pat, "-o", "c.vaf", fq, "/nonexistent.fq"]
    want = _jax(("crafted", max_e), args, str(tmp_path / "jax"), monkeypatch)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    got = _run("kmer_tpu_torch", args, str(tmp_path / "port"), monkeypatch)
    assert got == want and want[0] == 0
    assert "Warning: failed to open /nonexistent.fq" in want[1]
    rows = [ln.split("\t") for ln in want[2]["c.vaf"].decode().splitlines()]
    assert int(rows[3][7]) > 0  # rs1, the 41-base pattern, is found


@pytest.fixture(scope="module")
def a1_256(tmp_path_factory):
    """sampleA1's first 256 reads, gzipped."""
    fq = str(tmp_path_factory.mktemp("ed_reads_256") / "a1_256.fq.gz")
    with gzip.open(A1, "rb") as f, gzip.open(fq, "wb") as g:
        g.writelines(f.readline() for _ in range(4 * 256))
    return fq


@pytest.mark.parametrize("case", ["fixture", "crafted"])
def test_many_small_batches_match_jax(case, patterns, a1_256, crafted,
                                      tmp_path, monkeypatch):
    """_BATCH_BYTES cut to 24 KiB (24 rows of the 1,024 bucket, 6 of the
    4,096) in both tools: the fixture patterns over sampleA1's first 256
    reads go through 11 batches, the crafted file (patterns of 21-41
    bases, reads of 1-3,000 bases) through several batches of two
    buckets and of the multiword batch, with partial last batches:
    the port's totals, summed batch after batch on the device, give
    JAX's VAF file and stderr."""
    if case == "fixture":
        args = ["-e1", "-p", patterns, "-o", "s.vaf", a1_256]
    else:
        args = ["-e2", "-p", crafted[0], "-o", "s.vaf", crafted[1]]
    monkeypatch.setattr(JT, "_BATCH_BYTES", 24 << 10)
    monkeypatch.setattr(TT, "_BATCH_BYTES", 24 << 10)
    batches = []
    real = TT._Staging.upload

    def upload(self, codes, lens, nb):
        batches.append((codes.shape, nb, TT._width(lens, nb)))
        return real(self, codes, lens, nb)

    monkeypatch.setattr(TT._Staging, "upload", upload)
    want = _run("kmer_tpu", args, str(tmp_path / "jax"), monkeypatch)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    got = _run("kmer_tpu_torch", args, str(tmp_path / "port"), monkeypatch)
    assert want[0] == 0 and got == want
    rows = [ln.split("\t") for ln in want[2]["s.vaf"].decode().splitlines()]
    assert sum(int(r[7]) for r in rows[2:]) > 0
    # full batches and a partial last one; the used width a multiple of 16
    assert len(batches) >= 4
    assert any(nb == shape[0] for shape, nb, _ in batches)
    assert any(nb < shape[0] for shape, nb, _ in batches)
    assert all(w % 16 == 0 and w <= shape[1] for shape, _, w in batches)


def _edge_reads(pat, lens=None, long_lens=()):
    """Reads of `lens` bases (24 of 30-250 by default), then one a
    length in long_lens: random flanks around a ref or alt k-mer of the
    pattern file (a substitution or an indel in every third), some
    lowercase."""
    rng = np.random.default_rng(22)
    if lens is None:
        lens = [int(x) for x in rng.integers(30, 251, 24)]
    with open(pat, "rb") as f:
        kmers = [c for ln in f.read().splitlines()
                 for c in ln.split(b"\t")[6:8]]
    reads = []
    for i, L in enumerate(list(lens) + list(long_lens)):
        k = kmers[i % len(kmers)]
        if i % 3 == 0:
            j = int(rng.integers(1, len(k) - 1))
            k = k[:j] + (b"" if i % 2 else b"T") + k[j + 1:]
        flank = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, max(L, len(k)) - len(k))].tobytes()
        at = int(rng.integers(0, len(flank) + 1))
        r = flank[:at] + k + flank[at:]
        reads.append(r.lower() if i % 5 == 4 else r)
    return reads


def _fastq(reads, nl=b"\n"):
    return b"".join(b"@r%d x%s%s%s+%s%s%s" % (i, nl, s, nl, nl, b"I" * len(s),
                                            nl) for i, s in enumerate(reads))


def _edge_inputs(reads, long_reads, uniform):
    """{name: (file bytes, gzip: True, False, or None for bytes that
    are gzip already)}: the inputs the native path must read as
    FastxReader does."""
    fasta = b"".join(b">r%d\n" % i + b"\n".join(
        s[j:j + 60] for j in range(0, len(s), 60)) + b"\n"
        for i, s in enumerate(reads))
    bad = _fastq(reads[:12]) + b"@bad\nACGTACGT\n+\nIIIIIIIIIII\n" + \
        _fastq(reads[12:])
    nul = [s[:len(s) // 2] + b"\x00" + s[len(s) // 2 + 1:] if i % 3 else s
           for i, s in enumerate(reads)]
    heads = _fastq(reads[:10]) + b"@h1\n>ACGT\n+\nIIIII\n@h2\n@ACGT\n+\n" \
        b"IIIII\n@h3\n+ACGT\n+\nIIIII\n" + _fastq(reads[10:])
    whole = gzip.compress(_fastq(reads), 1)
    half = len(reads) // 2
    return {
        "long_reads": (_fastq(long_reads), True),
        "empty_reads": (b"".join(_fastq([s, b""]) for s in reads), True),
        "fasta_multiline": (fasta, True),
        "crlf": (_fastq(reads, b"\r\n") + b">last\r\n" + reads[1] + b"\r",
                 False),
        "bad_quality": (bad, True),
        "truncated_gz": (whole[:len(whole) * 2 // 3], None),
        "two_member_gz": (gzip.compress(_fastq(reads[:half])) +
                          gzip.compress(_fastq(reads[half:])), None),
        "nul_byte": (_fastq(nul), True),
        "header_chars_in_sequence": (heads, False),
        "uniform_150": (_fastq(uniform), True),
    }


@pytest.fixture(scope="module")
def edge_files(crafted, tmp_path_factory):
    d = tmp_path_factory.mktemp("ed_edges")
    out = {}
    reads = _edge_reads(crafted[0])
    long_reads = _edge_reads(crafted[0], long_lens=(1100, 1600, 2400))[-6:]
    uniform = _edge_reads(crafted[0], [150] * 200)
    for name, (data, gz) in _edge_inputs(reads, long_reads,
                                         uniform).items():
        out[name] = str(d / (name + (".fq.gz" if gz is not False else
                                     ".fq")))
        with open(out[name], "wb") as f:
            f.write(gzip.compress(data, 1) if gz else data)
    return out


def _port_paths(monkeypatch, args, d, sides=None):
    """The port's run on the native path and on FastxReader
    (KMER_TPU_NO_NATIVE=1), with the blocks the native path read;
    sides(name) is called before each."""
    from kmer_tpu_torch.io import native

    if not native.available():
        pytest.skip("the native reader does not build here (g++ or zlib)")
    blocks = []
    real = native.iter_records_native

    def spy(path, target_bases):
        # blocks of 512 bases in a buffer of 1,024: a read past 1,024
        # bases grows the buffer
        for raw, lens in real(path, 512):
            blocks.append(len(lens))
            yield raw, lens

    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    sides = sides or (lambda name: None)
    with monkeypatch.context() as m:
        m.setattr(native, "iter_records_native", spy)
        sides("native")
        got = _run("kmer_tpu_torch", args, os.path.join(d, "native"),
                   monkeypatch)
    with monkeypatch.context() as m:
        m.setenv("KMER_TPU_NO_NATIVE", "1")
        sides("python")
        py = _run("kmer_tpu_torch", args, os.path.join(d, "python"),
                  monkeypatch)
    return got, py, blocks


@pytest.mark.parametrize("name", sorted(_edge_inputs([b"A"] * 24, [], [])))
def test_native_reader_path_matches_jax(name, crafted, edge_files,
                                        tmp_path, monkeypatch):
    """Each edge input through the port's native reader path (blocks of
    512 bases) and through FastxReader: reads longer than the reader's
    buffer, in two buckets and the multiword batch, empty reads,
    multi-line FASTA, CR line ends (the last line's CR and no newline),
    a malformed quality section (the stream stops there), a truncated
    gzip, two gzip members, NUL bytes in reads, sequence lines that
    start with '>', '@' or '+', uniform 150-base reads.  The VAF file
    and stderr equal the JAX tool's both ways."""
    args = ["-e1", "-p", crafted[0], "-o", "n.vaf", edge_files[name]]
    want = _jax(("edge", name), args, str(tmp_path / "jax"), monkeypatch)
    got, py, blocks = _port_paths(monkeypatch, args, str(tmp_path))
    assert want[0] == 0 and got == want and py == want
    assert len(blocks) >= 1 and sum(blocks) > 0
    rows = [ln.split("\t") for ln in want[2]["n.vaf"].decode().splitlines()]
    assert sum(int(r[6]) + int(r[7]) for r in rows[2:]) > 0


@pytest.mark.parametrize("case", ["uniform", "ragged"])
def test_native_batches_equal_fastx_batches(case, crafted, edge_files,
                                            tmp_path, monkeypatch):
    """_BATCH_BYTES cut to 24 KiB: every batch the staging uploads, by
    bucket, is the same on the native path (blocks of 512 bases) as on
    FastxReader's (blocks of 3,072), the reads' codes over the used
    width, their lengths, the fill and the width, and so is the number
    of batches; only the order between buckets may differ.  Each also
    holds what the JAX tool's batch of that bucket holds, read by read
    (its whole buffer: 255 past the fill and each read's end, lengths 0
    past the fill).  Uniform 150-base reads (200 of them); ragged reads
    (empty ones, 30-2,400 bases, some past the reader's buffer)."""
    fq = edge_files["uniform_150" if case == "uniform" else "long_reads"]
    if case == "ragged":
        with open(fq, "rb") as f:
            more = gzip.decompress(f.read())
        fq = str(tmp_path / "ragged.fq.gz")
        with open(edge_files["empty_reads"], "rb") as f, \
                open(fq, "wb") as g:
            g.write(gzip.compress(more + gzip.decompress(f.read())))
    args = ["-e1", "-p", crafted[0], "-o", "b.vaf", fq]
    monkeypatch.setattr(TT, "_BATCH_BYTES", 24 << 10)
    monkeypatch.setattr(JT, "_BATCH_BYTES", 24 << 10)
    by = {}  # side -> {buffer shape: [(codes, lens, fill, width)]}
    real = TT._Staging.upload
    real_jax = JT.myers_hw_counts

    def upload(self, codes, lens, nb):
        w = TT._width(lens, nb)
        by[side[0]].setdefault(codes.shape, []).append(
            (codes[:nb, :w].tobytes(), lens[:nb].tolist(), nb, w))
        return real(self, codes, lens, nb)

    def jax_counts(peq, plen, codes, lens, max_e):
        jax_by.setdefault(codes.shape, []).append(
            (np.asarray(codes).tobytes(), np.asarray(lens).tolist()))
        return real_jax(peq, plen, codes, lens, max_e)

    def sides(name):
        side[0] = name
        by[name] = {}

    side, jax_by = [None], {}
    monkeypatch.setattr(TT._Staging, "upload", upload)
    with monkeypatch.context() as m:
        m.setattr(JT, "myers_hw_counts", jax_counts)
        want = _run("kmer_tpu", args, str(tmp_path / "jax"), monkeypatch)
    got, py, blocks = _port_paths(monkeypatch, args, str(tmp_path), sides)
    assert got == py == want and got[0] == 0
    assert by["native"] == by["python"]
    batches = [(shape, b) for shape, bs in by["native"].items() for b in bs]
    assert len(blocks) >= 2 and len(batches) >= 4
    if case == "uniform":
        assert list(by["native"]) == [(24, 1024)]
    else:
        assert {shape[1] for shape, _ in batches} == {1024, 4096}
    assert any(b[2] == shape[0] for shape, b in batches)
    assert any(b[2] < shape[0] for shape, b in batches)
    port = {}
    for (rows, bucket), bs in by["native"].items():
        for codes, lens, nb, w in bs:
            full = np.full((rows, bucket), 255, np.uint8)
            full[:nb, :w] = np.frombuffer(codes, np.uint8).reshape(nb, w)
            port.setdefault((rows, bucket), []).append(
                (full.tobytes(), lens + [0] * (rows - nb)))
    assert port == jax_by


def test_batch_width_is_the_longest_read_rounded_to_16():
    lens = np.array([0, 150, 17, 0], np.int32)
    assert TT._width(lens, 4) == 160 and TT._width(lens, 3) == 160
    assert TT._width(lens[2:], 1) == 32
    assert TT._width(lens[3:], 1) == 16 and TT._width(lens, 0) == 16
    assert TT._width(np.array([1024], np.int32), 1) == 1024


@pytest.mark.parametrize("args", [[], ["-p", "x.pat"], ["-o", "a.vaf", "r"],
                                  ["-p", "/nonexistent.pat", "-o", "a.vaf",
                                   "r.fq"]])
def test_errors_match_jax(args, tmp_path, monkeypatch):
    """Usage and error text, exit codes, and no VAF file written."""
    want = _run("kmer_tpu", args, str(tmp_path / "jax"), monkeypatch)
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")
    got = _run("kmer_tpu_torch", args, str(tmp_path / "port"), monkeypatch)
    assert got == want and want[0] == 1 and not want[2]


def test_host_helpers_match_original(tmp_path):
    """_bucket_for, _alphabet_lut, _encode and _openable: the copies
    answer as the JAX tool's do."""
    for n in (0, 1, 150, 1024, 1025, 4096, 4097, 70_000):
        assert TT._bucket_for(n) == JT._bucket_for(n)
    for kmers in ([b"ACGT", b"acgN"], [b"GGGGG"], [], [b"\x00AC", b"T\xff"]):
        lut, n = TT._alphabet_lut(kmers)
        jlut, jn = JT._alphabet_lut(kmers)
        assert n == jn and np.array_equal(lut, jlut)
        seq = bytes(range(256))
        assert np.array_equal(TT._encode(seq, lut), JT._encode(seq, jlut))
    ok = tmp_path / "ok.fq"
    ok.write_text("")
    for fn in (str(ok), "-", str(tmp_path / "missing.fq"), str(tmp_path)):
        assert TT._openable(fn) == JT._openable(fn)
    assert TT._BATCH_BYTES == JT._BATCH_BYTES
    assert TT._MIN_BUCKET == JT._MIN_BUCKET
    assert TT._KERNEL_MAX_PAT == JT._KERNEL_MAX_PAT
