"""Data kind "snp_cohort": a genome of cfg["genome"]["bases"] whose first
cfg["reference_fasta"]["bases"] are the panel's chromosomes (written as
the FASTA that snp-pattern-gen reads), a BED panel of SNP sites in them,
genotypes drawn at each site (hom-ref, het, hom-alt), and a cohort of
samples, each a gzipped FASTQ of reads drawn from its genotype's two
haplotypes over the whole genome.  The warm-up file is a small sample
of the first genotype."""

import os

import numpy as np
import torch

from h100bench import gen


def chromosome_bounds(rng, bases: int, n: int, margin: int = 1 << 16):
    """n chromosomes of seeded lengths over `bases`: the cut points."""
    cuts = np.sort(rng.choice(np.arange(margin, bases - margin), n - 1,
                              replace=False))
    return np.concatenate([[0], cuts, [bases]]).astype(np.int64)


def snp_sites(rng, bounds: np.ndarray, n_sites: int, grid: int, k: int):
    """(chromosome index, position in it) of n_sites sites on a `grid`-
    base lattice, each at least k bases from its chromosome's ends."""
    total = int(bounds[-1])
    lattice = np.arange(grid // 2, total, grid)
    chrom = np.searchsorted(bounds, lattice, side="right") - 1
    ok = (lattice - bounds[chrom] >= k) & (bounds[chrom + 1] - lattice > k)
    pick = np.sort(rng.choice(np.flatnonzero(ok), n_sites, replace=False))
    return chrom[pick], lattice[pick] - bounds[chrom[pick]]


def make(cfg: dict, seed: int, workdir: str, warmup_bases: int, device):
    g, f, p, c, r = (cfg["genome"], cfg["reference_fasta"], cfg["panel"],
                     cfg["cohort"], cfg["reads"])
    rng = gen.rng_for(seed, 3)
    genome = gen.genome_codes((seed, 6), g["bases"], g["gc"], device)
    region = genome[:f["bases"]].cpu().numpy()
    bounds = chromosome_bounds(rng, f["bases"], f["chromosomes"])
    names = [f"chr{i + 1}" for i in range(f["chromosomes"])]
    chrom, pos = snp_sites(rng, bounds, p["sites"], p["grid"], cfg["k"])
    gpos = bounds[chrom] + pos  # ascending: the sites are sorted
    ref = region[gpos].copy()
    alt = ((ref + rng.integers(1, 4, ref.shape[0])) % 4).astype(np.uint8)
    fasta = os.path.join(workdir, "genome.fa.gz")
    gen.write_gzip(fasta, [lambda i=i: gen.fasta_record(
        names[i], region[bounds[i]:bounds[i + 1]], f["line_width"])
        for i in range(len(names))], cfg["gzip_level"])
    bed = os.path.join(workdir, "panel.bed")
    with open(bed, "w") as out:
        for i in range(pos.shape[0]):
            out.write(f"{names[chrom[i]]}\t{pos[i]}\t{pos[i] + 1}\t"
                      f"rs{i + 1}\t{'ACGT'[ref[i]]}\t{'ACGT'[alt[i]]}\n")
    shares = np.asarray(c["genotype_shares"], np.float64)  # ref/het/alt
    variants = []
    for gi in range(c["genotypes"]):
        state = gen.rng_for(seed, 4, gi).choice(3, pos.shape[0], p=shares)
        alleles = np.full((2, pos.shape[0]), gen.NO_ALT, np.uint8)
        alleles[0, state >= 1] = alt[state >= 1]  # het: alt on haplotype 0
        alleles[1, state == 2] = alt[state == 2]
        variants.append((torch.from_numpy(gpos).to(device),
                         torch.from_numpy(alleles).to(device)))
    n_reads = c["bases_per_sample"] // r["length"]
    files = []
    for s in range(c["samples"]):
        path = gen.reads_path(workdir, cfg, f"sample{s + 1}")
        files.append(gen.ReadSet(path, gen.write_reads(
            path, genome, n_reads, cfg, (seed, 5, s),
            variants[s % c["genotypes"]])))
    warm = gen.reads_path(workdir, cfg, "warmup")
    warmup = [gen.ReadSet(warm, gen.write_reads(
        warm, genome, gen.warmup_reads(cfg, n_reads, warmup_bases), cfg,
        (seed, 7), variants[0]))]
    return gen.Inputs(files, warmup, {
        "fasta": fasta, "bed": bed, "chromosomes": names,
        "genome": region, "bounds": bounds, "site_chrom": chrom,
        "site_pos": pos, "ref": ref, "alt": alt})
