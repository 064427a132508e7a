#!/usr/bin/env python3
"""profile_torch.py — where the PyTorch/CUDA port's device time goes.

Usage: python3 scripts/profile_torch.py [--runs kc31,yak,kc15,yak2,edvaf,
                                               mesh31,mesh2]
                                        [--top N] [--out DIR] [--seed N]
                                        [--reads FASTQ] [--tag TAG]

Runs on one CUDA GPU, on the 256 Mbase FASTQ that chip_smoke.py makes
and its SNP phase's sample B (64 Mbases), both cached under
build/chip_smoke/.  For each run:

  kc31   kc-c4 -k31               (the main path: merge path, seghist)
  yak    yak-count -k31 -b30      (plus the tap's (key, index) merge path)
  kc15   kc-c4 -k15               (one-plane keys: the int32 merge path)
  yak2   yak-count -k31 -b30 A B  (two files: the bloom's bits array,
                                   two compactors, the shrink join)
  edvaf  ed-vaf-counter -e1 on chip_smoke.py's 1,000-site panel over
         the first 2,048 reads of B (one batch of the Myers loop)
  mesh31 kc31 on the mesh of chip_smoke.py's mesh phase (4 logical
         shards of the card: routing, exchange, a compactor a shard)
  mesh2  yak2 on that mesh (deferred admission a shard, no bits array)

two warm passes, then one pass under torch.profiler (CPU and CUDA
activities).  Each pass prints its wall; the profiled pass also prints
the device busy time (the sum of the device time of every kernel, copy
and memset: the trace's device-side events only, since an aten:: op
reports its kernels' time again) and its share of the wall, peak device
memory, the IngestStats, the kernels' launch counts
(kmer_tpu_torch.kernels._build) and the top N device items by time, with
their call counts.  With
--out, each run's full table goes to DIR/profile_<run><TAG>.txt.
--reads takes another FASTQ in place of chip_smoke.py's 256 Mbase file
(yak2's rate then counts the bases of chip_smoke.py's file, not its).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"kc31": ("kc-c4", ["-k31"]), "yak": ("yak-count", ["-k31", "-b30"]),
        "kc15": ("kc-c4", ["-k15"]), "yak2": ("yak-count", ["-k31", "-b30"]),
        "edvaf": ("ed-vaf-counter", ["-e1"]),
        "mesh31": ("kc-c4", ["-k31"]), "mesh2": ("yak-count", ["-k31", "-b30"])}


def _device_us(ev) -> float:
    t = getattr(ev, "self_device_time_total", None)
    return float(t if t is not None else ev.self_cuda_time_total)


def _inputs(name, path, seed):
    """(tool arguments after the flags, bases they read)."""
    import chip_smoke as smoke

    if name == "edvaf":
        pat, head, _b, _ = smoke.edvaf_inputs(seed)
        out = os.path.join(smoke.DATA_DIR, "edvaf", "profile.vaf")
        return ["-p", pat, "-o", out, head], \
            smoke.EDVAF_READS * smoke.READ_LEN
    if name not in ("yak2", "mesh2"):
        return [path], None  # the engine counts them
    mb = (smoke.MBASES, dict((n, mb) for n, _, mb, _ in smoke.SNP_SAMPLES)["B"])
    return [path, smoke.snp_inputs(seed)[2]["B"]], \
        sum(m * 1_000_000 // smoke.READ_LEN * smoke.READ_LEN for m in mb)


def _recording(name, tool):
    """The engines a run builds (none for ed-vaf-counter)."""
    import chip_smoke as smoke
    from kmer_tpu_torch.tools import kc, yak_count

    if name.startswith("mesh"):
        return _on_mesh(yak_count if tool == "yak-count" else kc,
                        tool == "yak-count")
    if name == "yak2":
        return smoke.recording_yak_engines()
    if name == "edvaf":
        return contextlib.nullcontext([])
    return smoke.recording_engines(yak_count if tool == "yak-count"
                                   else None)


@contextlib.contextmanager
def _on_mesh(tool_module, yak):
    """The tool on chip_smoke.py's mesh, its engines recorded."""
    import chip_smoke as smoke

    with smoke.on_mesh(smoke.mesh_card()), \
            smoke.recording_mesh_engines(tool_module, yak) as made:
        yield made


def profile_run(name, path, top, out_dir, tag="", seed=0):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as smoke
    from kmer_tpu_torch.kernels import _build

    tool, args = RUNS[name]
    files, bases = _inputs(name, path, seed)
    for i in range(3):
        profiled = i == 2
        gc.collect()  # free earlier passes' engines (reference cycles)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) if profiled \
            else None
        with _recording(name, tool) as made:
            if prof is not None:
                prof.start()
            t0 = time.perf_counter()
            smoke.run_tool_err(tool, [*args, *files])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if prof is not None:
                prof.stop()
        stats = []
        if made:
            st = made[0].stats
            stats = st if isinstance(st, list) else [st]
            if bases is None:
                bases = made[0].total_bases
        peak = torch.cuda.max_memory_allocated() / 2**30
        label = "profiled" if profiled else f"warm {i + 1}"
        ingest = "".join(f"; {smoke.stats_line(st)}" for st in stats)
        if stats:
            ingest += (f"; finalize "
                       f"{wall - sum(st.loop_s for st in stats):.3f} s")
        print(f"[{name}] {tool} {' '.join(args)} {label}: {wall:.3f} s = "
              f"{bases / 1e6 / wall:.2f} Mbases/s, peak device "
              f"memory {peak:.2f} GiB{ingest}", flush=True)
        del stats, made  # the next pass's peak must not hold this engine
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA and _device_us(ev) > 0]
    if not events:
        raise RuntimeError("the trace holds no device time")
    events.sort(key=_device_us, reverse=True)
    busy = sum(_device_us(ev) for ev in events) / 1e6
    print(f"[{name}] device busy {busy:.3f} s = {100 * busy / wall:.1f}% of "
          f"the profiled wall", flush=True)
    print(f"[{name}] launches: {json.dumps(dict(_build.LAUNCHES))}")
    lines = [f"{_device_us(ev) / 1e3:10.3f} ms {ev.count:6d} calls  "
             f"{ev.key[:110]}" for ev in events]
    for line in lines[:top]:
        print(f"[{name}] {line}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"profile_{name}{tag}.txt"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default="kc31,yak")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reads", default=None)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("profile_torch: no CUDA device\n")
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke

    smoke.phase_build()
    path = args.reads or smoke.reads_file(smoke.MBASES, args.seed)
    for name in args.runs.split(","):
        profile_run(name, path, args.top, args.out, args.tag, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
