"""Seeded synthetic inputs: genomes, reads, SNP panels and cohorts.

Everything is made from the run's seed, in bulk with torch on the card
(on the CPU where there is none) and numpy for the small tables, so one
seed gives the same inputs byte for byte on every card of a kind (torch
draws other numbers on the CPU than on a card).  Bases are 2-bit codes
A=0, C=1, G=2, T=3, with N=4; the reference (reference/) counts from
these arrays, the program reads the gzipped files written from them.
Each configuration names its data kind, whose maker is data/<kind>.py.

Gzip files are one member, written pigz-style: blocks deflated in
threads (level 1) and joined with full flushes into one deflate stream,
so set-up does not wait on one core.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

ACGTN = np.frombuffer(b"ACGTN", np.uint8)
N_CODE = 4
NO_ALT = 255  # a haplotype's allele table: the reference base here
_GZ_BLOCK = 4 << 20  # bytes of text a deflate block
# threads that make and deflate the text, and draw genomes: set-up's,
# all joined before the warm-up job
_WRITERS = min(8, os.cpu_count() or 1)
_READS_A_CHUNK = 50_000
_GENOME_CHUNK = 1 << 26  # bases of a genome drawn from one stream


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """A generator for one stream of the run, from the seed and tags."""
    return np.random.default_rng([int(seed) & (2**64 - 1), *tags])


def device_rng(device, seed: int, *tags: int) -> torch.Generator:
    """A torch generator on `device` for one stream of the run, from the
    seed and tags."""
    state = np.random.SeedSequence([int(seed) & (2**64 - 1), *tags])
    g = torch.Generator(device=device)
    g.manual_seed(int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return g


def _gc_table(gc: float) -> np.ndarray:
    """65,536 codes, C and G at share gc / 2 each, A and T at (1 - gc) / 2:
    a uniform 16-bit draw looks a base up in it."""
    n = 1 << 16
    c = g = round(gc / 2 * n)
    a = round((1 - gc) / 2 * n)
    return np.repeat(np.array([1, 2, 0, 3], np.uint8), [c, g, a, n - c - g - a])


def genome_codes(seed_tags: tuple, bases: int, gc: float,
                 device="cpu") -> torch.Tensor:
    """A random genome of `bases` codes (uint8, on `device`) with G+C at
    share `gc`: chunk c of _GENOME_CHUNK bases from the stream
    device_rng(device, *seed_tags, c)."""
    table = torch.from_numpy(_gc_table(gc)).to(device)
    out = torch.empty(bases, dtype=torch.uint8, device=device)
    for lo in range(0, bases, _GENOME_CHUNK):
        n = min(_GENOME_CHUNK, bases - lo)
        draw = torch.randint(0, 1 << 16, (n,), device=device,
                             generator=device_rng(device, *seed_tags,
                                                  lo // _GENOME_CHUNK))
        out[lo:lo + n] = table[draw]
    return out


def sample_reads(rng: torch.Generator, genome: torch.Tensor, n_reads: int,
                 length: int, sub_rate: float, n_rate: float,
                 rc_share: float, variants=None) -> torch.Tensor:
    """(n_reads, length) codes on the genome's device: windows of the
    genome at random starts, the reverse strand at share rc_share, then
    substitutions (a base changed to one of the other three) and N
    calls, each at its rate a base.  `variants`, (positions ascending,
    alleles (H, sites)), on the same device, makes H haplotypes: each
    read is drawn from one of them, uniform, and carries its allele at
    every site it covers (NO_ALT: the genome's base)."""
    dev = genome.device
    starts = torch.randint(0, genome.shape[0] - length + 1, (n_reads,),
                           generator=rng, device=dev)
    out = genome[starts[:, None] + torch.arange(length, device=dev)]
    if variants is not None and n_reads:
        pos, alleles = variants
        hap = torch.randint(0, alleles.shape[0], (n_reads,), generator=rng,
                            device=dev)
        lo = torch.searchsorted(pos, starts)
        hi = torch.searchsorted(pos, starts + length)
        for d in range(int((hi - lo).max())):
            rows = torch.nonzero(lo + d < hi).squeeze(1)
            site = lo[rows] + d
            allele = alleles[hap[rows], site]
            alt = allele != NO_ALT
            rows, site = rows[alt], site[alt]
            out[rows, pos[site] - starts[rows]] = allele[alt]
    flip = torch.rand(n_reads, generator=rng, device=dev) < rc_share
    out[flip] = 3 - out[flip].flip(1)
    # one uniform draw a base: under sub_rate a substitution, over
    # 1 - n_rate an N call
    u = torch.rand((n_reads, length), generator=rng, device=dev)
    shift = torch.randint(1, 4, (n_reads, length), generator=rng,
                          device=dev, dtype=torch.uint8)
    out = torch.where(u < sub_rate, (out + shift) % 4, out)
    return torch.where(u >= 1 - n_rate, torch.full_like(out, N_CODE), out)


def records(reads: torch.Tensor, first_id: int, fmt: str) -> bytes:
    """FASTA (`>` + 9-digit name) or FASTQ (quality `I`) text of reads,
    (n, length) codes, made on their device."""
    n, length = reads.shape
    dev = reads.device
    head = 1 + 9 + 1
    rec = head + length + 1 + (2 + length + 1 if fmt == "fastq" else 0)
    out = torch.empty((n, rec), dtype=torch.uint8, device=dev)
    out[:, 0] = ord(">" if fmt == "fasta" else "@")
    ids = first_id + torch.arange(n, device=dev)
    for d in range(9):
        out[:, 1 + d] = 48 + (ids // 10 ** (8 - d)) % 10
    out[:, 10] = 10
    out[:, head:head + length] = torch.from_numpy(ACGTN.copy()).to(dev)[
        reads.long()]
    out[:, head + length] = 10
    if fmt == "fastq":
        c = head + length + 1
        out[:, c] = ord("+")
        out[:, c + 1] = 10
        out[:, c + 2:c + 2 + length] = ord("I")
        out[:, -1] = 10
    return out.cpu().numpy().tobytes()


def fasta_record(name: str, seq: np.ndarray, width: int) -> bytes:
    """One FASTA record of a code array, `width` bases a line."""
    n = seq.shape[0]
    rows = -(-n // width)
    grid = np.full((rows, width + 1), 10, np.uint8)
    body = np.zeros(rows * width, np.uint8)
    body[:n] = ACGTN[seq]
    grid[:, :width] = body.reshape(rows, width)
    text = grid.tobytes()
    if n % width:  # the last line holds n % width bases
        text = text[:len(text) - (width - n % width) - 1] + b"\n"
    return b">" + name.encode() + b"\n" + text


_HEADER = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"


def _deflate(text: bytes, level: int, last: bool) -> bytes:
    """Raw deflate of text in _GZ_BLOCK pieces, each ended by a full
    flush, the stream ended after the last piece when `last`."""
    parts = []
    for off in range(0, max(len(text), 1), _GZ_BLOCK):
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        end = last and off + _GZ_BLOCK >= len(text)
        parts.append(c.compress(text[off:off + _GZ_BLOCK]) + c.flush(
            zlib.Z_FINISH if end else zlib.Z_FULL_FLUSH))
    return b"".join(parts)


def write_gzip(path: str, tasks, level: int = 1) -> int:
    """Write one gzip member from `tasks`, callables each returning a
    piece of the text, in order: each piece made and deflated in a pool
    of threads, a few in flight.  Returns the text's length."""
    crc, size = 0, 0
    tasks = list(tasks)

    def work(i):
        text = tasks[i]()
        return text, _deflate(text, level, i == len(tasks) - 1)

    with open(path, "wb") as f, ThreadPoolExecutor(_WRITERS) as pool:
        f.write(_HEADER)
        futures = [pool.submit(work, i)
                   for i in range(min(len(tasks), 2 * _WRITERS))]
        for i in range(len(tasks)):
            text, comp = futures[i].result()
            futures[i] = None
            if i + 2 * _WRITERS < len(tasks):
                futures.append(pool.submit(work, i + 2 * _WRITERS))
            crc = zlib.crc32(text, crc)
            size += len(text)
            f.write(comp)
        if not tasks:
            f.write(_deflate(b"", level, True))
        f.write(struct.pack("<II", crc, size & 0xFFFFFFFF))
    return size


# ---------------------------------------------------------------------------
# the inputs of a cell

@dataclass
class ReadSet:
    """One gzipped reads file and the codes it was written from."""
    path: str
    reads: np.ndarray  # (n, length) uint8 codes

    @property
    def bases(self) -> int:
        return int(self.reads.size)


@dataclass
class Inputs:
    """What a cell's jobs read: `files`, taken in turn, `warmup`, the
    small file of the warm-up job (the same generator and shapes), and
    whatever else the configuration's check needs."""
    files: List[ReadSet]
    warmup: List[ReadSet]
    extra: Dict[str, object] = field(default_factory=dict)


def write_reads(path: str, genome: torch.Tensor, n_reads: int, cfg: dict,
                seed_tags: tuple, variants=None) -> np.ndarray:
    """Sample n_reads reads (cfg["reads"]) from the genome in chunks of
    _READS_A_CHUNK, chunk c from its own stream device_rng(genome's
    device, *seed_tags, c), and write them as one gzip file; returns
    their codes, on the host."""
    r = cfg["reads"]
    reads = np.empty((n_reads, r["length"]), np.uint8)

    def task(lo):
        def make():
            n = min(_READS_A_CHUNK, n_reads - lo)
            codes = sample_reads(
                device_rng(genome.device, *seed_tags, lo // _READS_A_CHUNK),
                genome, n, r["length"], r["substitution_rate"], r["n_rate"],
                r["reverse_strand_share"], variants)
            reads[lo:lo + n] = codes.cpu().numpy()
            return records(codes, lo + 1, r["format"])
        return make

    write_gzip(path, [task(lo) for lo in range(0, n_reads, _READS_A_CHUNK)],
               cfg["gzip_level"])
    return reads


def reads_path(workdir: str, cfg: dict, stem: str) -> str:
    ext = "fa" if cfg["reads"]["format"] == "fasta" else "fq"
    return os.path.join(workdir, f"{stem}.{ext}.gz")


def warmup_reads(cfg: dict, per_file: int, bases: int) -> int:
    """The reads of the warm-up file: `bases` bases of the configuration's
    reads, never more than a job's file holds."""
    return max(1, min(per_file, bases // cfg["reads"]["length"]))


def default_device():
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def make_inputs(cfg: dict, seed: int, workdir: str, warmup_bases: int,
                base: str = None) -> Inputs:
    """The inputs of a configuration, made by the data kind it names:
    data/<kind>.py's make(cfg, seed, workdir, warmup_bases, device), on
    the card when there is one."""
    from .spec import HERE, load_module

    dev = default_device()
    inputs = load_module("data", cfg["data"], base or HERE).make(
        cfg, seed, workdir, warmup_bases, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return inputs
