"""Data kind "reads": one genome and cfg["reads"]["count"] reads sampled
from it, in one gzipped file; the warm-up file holds fewer reads of the
same genome."""

from h100bench import gen


def make(cfg: dict, seed: int, workdir: str, warmup_bases: int, device):
    g, r = cfg["genome"], cfg["reads"]
    genome = gen.genome_codes((seed, 1), g["bases"], g["gc"], device)
    path = gen.reads_path(workdir, cfg, "reads")
    files = [gen.ReadSet(path, gen.write_reads(path, genome, r["count"],
                                               cfg, (seed, 2, 0)))]
    warm = gen.reads_path(workdir, cfg, "warmup")
    n = gen.warmup_reads(cfg, r["count"], warmup_bases)
    return gen.Inputs(files, [gen.ReadSet(warm, gen.write_reads(
        warm, genome, n, cfg, (seed, 2, 1)))])
