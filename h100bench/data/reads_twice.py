"""Data kind "reads_twice": one genome, cfg["reads"]["count"] reads
sampled from it and written as cfg["reads"]["members"] gzip members one
after another in one file (what `cat pat_1.fq.gz pat_2.fq.gz` makes),
and a second name for that file (a hard link), so a job given both
names reads the same bytes twice, as a tool given `<(cat ...) <(cat
...)` does.  The warm-up file holds fewer reads of the same genome, in
as many members and under two names too.
"""

import os
import shutil

import numpy as np

from h100bench import gen


def write_members(path: str, genome, n_reads: int, cfg: dict, tags: tuple
                  ) -> np.ndarray:
    """n_reads reads in cfg["reads"]["members"] gzip members of one file,
    member m holding an equal share (the last the rest) drawn from the
    streams (*tags, m); returns their codes, in file order."""
    m = cfg["reads"]["members"]
    sizes = [n_reads // m] * (m - 1) + [n_reads - n_reads // m * (m - 1)]
    parts = []
    with open(path, "wb") as out:
        for i, n in enumerate(sizes):
            member = f"{path}.member{i}"
            parts.append(gen.write_reads(member, genome, n, cfg, (*tags, i)))
            with open(member, "rb") as f:
                shutil.copyfileobj(f, out, 16 << 20)
            os.remove(member)
    return np.concatenate(parts)


def two_names(path: str, reads: np.ndarray):
    """Two ReadSets of one file: `path` and a hard link to it."""
    alias = path.replace(".gz", ".again.gz")
    os.link(path, alias)
    return [gen.ReadSet(path, reads), gen.ReadSet(alias, reads)]


def make(cfg: dict, seed: int, workdir: str, warmup_bases: int, device):
    g, r = cfg["genome"], cfg["reads"]
    genome = gen.genome_codes((seed, 1), g["bases"], g["gc"], device)
    path = gen.reads_path(workdir, cfg, "reads")
    files = two_names(path, write_members(path, genome, r["count"], cfg,
                                          (seed, 2, 0)))
    warm = gen.reads_path(workdir, cfg, "warmup")
    n = gen.warmup_reads(cfg, r["count"], warmup_bases)
    return gen.Inputs(files, two_names(warm, write_members(
        warm, genome, n, cfg, (seed, 2, 1))))
