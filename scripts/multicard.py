#!/usr/bin/env python3
"""multicard.py — one process over a mesh of every card against one
process a card under NCCL, in the same call, on a machine of several
NVIDIA GPUs.

Usage: python3 scripts/multicard.py [--seed N]

Inputs are chip_smoke.py's (made from --seed and cached under
build/chip_smoke/): its 256 Mbase FASTQ A, the second 256 Mbase file A'
of its multiproc phase and its SNP phase's 64 Mbase sample B.  Runs, in
order:

  mesh   one process, the tools' default device list (a shard a card):
         kc-c4 -k31 over A + A' and two-file yak-count -k31 -b30 A B
         through the tools, and one step's exchange (sharded.all_to_all,
         the routing done before) timed on the host, synchronized on
         every card, mean of 5 after a warm-up
  nccl   one process a card (dist.multihost.initialize: NCCL), through
         chip_smoke.py's worker: the same two runs, single-reader
         yak-count (KMER_TPU_SINGLE_READER=1) and one step's exchange

The NCCL outputs must equal the mesh's (kc-c4 stdout, yak-count stdout,
and the single-reader `[M` lines equal the mesh's, the same global
batches); it prints each run's wall and Mbases/s, each card's or
process's peak device memory and the exchanges, beside the card's name
and power limit.  Exits non-zero on any difference, or with fewer than
two cards.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def mesh_exchange_ms(eng, path):
    """One step's exchange on the mesh engine eng: host ms, synchronized
    on every card, mean of 5 after a warm-up, and the lanes moved."""
    import torch

    from kmer_tpu_torch.dist import sharded
    from kmer_tpu_torch.kernels import extract
    from kmer_tpu_torch.pipeline import counter

    steps = counter.mesh_steps([path], eng.k, eng.row_bases, eng.capacity,
                               ("resume", eng.k, 3), eng.n_dev, False, True,
                               False, counter.IngestStats())
    rows, rb, *_ = next(steps)
    steps.close()
    keys = [counter.extract_row(r.to(dev), eng.k, rb, None, "ascii",
                                extract.extract_keys,
                                extract.extract_keys_rows)[0]
            for r, dev in zip(rows, eng.mesh.devices)]
    routed = sharded.route_rows(keys, eng.n_dev)

    def sync():
        for d in eng.mesh.devices:
            torch.cuda.synchronize(d)

    times = []
    for _ in range(6):
        sync()
        t0 = time.perf_counter()
        owned = sharded.all_to_all(routed, eng.mesh)
        sync()
        times.append(time.perf_counter() - t0)
    return (sum(times[1:]) / 5 * 1e3, sum(int(o.shape[0]) for o in owned))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        sys.stderr.write("multicard: needs two or more CUDA devices\n")
        return 2
    from kmer_tpu_torch.kernels import _build
    from kmer_tpu_torch.pipeline.counter import MeshSortCountEngine
    from kmer_tpu_torch.tools import kc

    n = torch.cuda.device_count()
    cs.phase_card()
    cs.phase_build()
    a = cs.reads_file(cs.MBASES, args.seed)
    a2 = cs.reads_file(cs.MBASES, args.seed + 100)
    b = cs.snp_inputs(args.seed)[2]["B"]
    bases = cs.MBASES * 1_000_000 // cs.READ_LEN * cs.READ_LEN
    mb_b = dict((s, mb) for s, _, mb, _ in cs.SNP_SAMPLES)["B"]
    ybases = bases + mb_b * 1_000_000 // cs.READ_LEN * cs.READ_LEN
    yak_args = [*cs.YAK2_ARGS, a, b]

    def peaks():
        return " ".join(f"{torch.cuda.max_memory_allocated(i) / 2**30:.2f}"
                        for i in range(n))

    for i in range(n):
        torch.cuda.reset_peak_memory_stats(i)
    _build.reset_launches()
    t0 = time.perf_counter()
    h = kc._run_counter([a, a2], cs.K, 1023, qual_policy=("resume", cs.K, 3))
    kc_out = cs.hist_text(h.eng)
    wall = time.perf_counter() - t0
    cs.need(isinstance(h.eng, MeshSortCountEngine) and h.eng.n_dev == n,
            f"kc-c4 did not count on a mesh of the {n} cards")
    cs.say("mesh", f"one process, {n} cards: kc-c4 -k{cs.K} A + A' "
           f"{wall:.3f} s = {2 * bases / 1e6 / wall:.2f} Mbases/s, peak "
           f"GiB a card {peaks()}; {cs.stats_line(h.eng.stats)}")
    cs.say("mesh", f"launches {_build.LAUNCHES}")
    ms, lanes = mesh_exchange_ms(h.eng, a)
    cs.say("mesh", f"one step's exchange ({lanes} owned keys out, peer "
           f"copies): {ms:.3f} ms (host wall, synchronized, mean of 5)")
    del h
    for i in range(n):
        torch.cuda.reset_peak_memory_stats(i)
    t0 = time.perf_counter()
    y_out, y_lines = cs.run_tool("yak-count", yak_args)
    ywall = time.perf_counter() - t0
    cs.say("mesh", f"yak-count {' '.join(cs.YAK2_ARGS)} A B {ywall:.3f} s "
           f"= {ybases / 1e6 / ywall:.2f} Mbases/s, peak GiB a card "
           f"{peaks()}, {len(y_lines)} [M lines")

    items = [
        {"name": "kc", "kind": "kc", "paths": [a, a2]},
        {"name": "exchange", "kind": "exchange", "paths": [a, a2]},
        {"name": "yak2", "kind": "tool", "tool": "yak-count",
         "args": yak_args},
        {"name": "yak2_sr", "kind": "tool", "tool": "yak-count",
         "args": yak_args, "env": {"KMER_TPU_SINGLE_READER": "1"}},
    ]
    t0 = time.perf_counter()
    res = cs.run_multiproc("multicard", items, n_proc=n, shards=0)
    cs.say("nccl", f"{n} processes ended in {time.perf_counter() - t0:.1f} s")
    cs.need(all(r["backend"] == "nccl" for r in res),
            f"one process a card did not take NCCL: "
            f"{[r['backend'] for r in res]}")
    q = [{r["name"]: r for r in x["results"]} for x in res]
    cs.need(q[0]["kc"]["out"] == kc_out, "kc-c4 under NCCL != the mesh")
    cs.need(q[0]["yak2"]["out"] == y_out and q[0]["yak2_sr"]["out"] == y_out,
            "two-file yak-count under NCCL != the mesh")
    cs.need(q[0]["yak2_sr"]["lines"] == y_lines,
            "single-reader yak-count's [M lines under NCCL != the mesh's")
    cs.need(not any(x[name]["out"] for x in q[1:]
                    for name in ("kc", "yak2", "yak2_sr")),
            "a process other than 0 printed")
    cs.say("nccl", "kc-c4, two-file yak-count and single-reader yak-count "
           "(stdout and [M lines) == the one-process mesh of the cards")
    for pid, x in enumerate(q):
        cs.say("nccl", f"process {pid} on cuda:{res[pid]['device']}: kc-c4 "
               f"{cs.mp_line(x['kc'], 2 * bases)}")
        cs.say("nccl", f"  yak-count {cs.mp_line(x['yak2'], ybases)}; "
               f"single reader {cs.mp_line(x['yak2_sr'], ybases)}")
        e = x["exchange"]
        cs.say("nccl", f"  one step's exchange ({e['lanes']} lanes in): "
               f"{e['ms']:.3f} ms (host wall, synchronized, mean of 5), "
               f"{e['bytes'] / 1e6:.1f} MB sent + received")
    print("ok", flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"FAILED: {e}", flush=True)
        sys.exit(1)
