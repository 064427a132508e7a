"""One run of one cell: load and build the port, make the inputs from the
seed, warm the port with one job on a small file of the cell's own
shapes, run jobs back to back for the window, then check every job's
output against the plain reference and build the result line.

A job is one call of a tool's entry, kmer_tpu_torch.tools.get_tool(name)
(argv), from gzipped input files to the tool's whole output.  Jobs start
while the window is open; the last one runs to its end and the window
with it, so every rate is over whole jobs.  Between jobs the harness
collects garbage (the port's engines hold reference cycles), as a new
process a job would free them.  Jobs run in this process, on its one
card: a cell on several cards needs a runner of several processes,
which does not exist yet (run.py refuses such a cell).
"""

from __future__ import annotations

import contextlib
import gc
import io
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import gen, trace as tracing
from .spec import Cell, load_module

# top-level module names no run may hold: JAX, its relatives, the JAX
# package and the scripts that run it.  Compared whole: kmer_tpu_torch is
# allowed.
FORBIDDEN = ("jax", "jaxlib", "flax", "kmer_tpu", "bench", "chip_smoke")
TRACE_SECONDS = 8.0  # a traced run profiles whole jobs up to this long
# bases of the warm-up job's file (a traffic mix may set `warmup_bases`):
# a few of the engines' 10 Mbase blocks, so the stream ladder merges
WARMUP_BASES = 32_000_000
# the IngestStats fields the metrics read
STAT_FIELDS = ("reader_s", "wait_s", "dispatch_s", "loop_s")


def foreign_modules(modules=None) -> List[str]:
    """The FORBIDDEN top-level names among the loaded modules."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods} & set(FORBIDDEN))


@dataclass
class Job:
    tool: str
    argv: List[str]
    files: Tuple[int, ...]  # its inputs, indices into Inputs.files
    output: Optional[str] = None  # the output file, or None: stdout
    rc: Optional[int] = None
    error: str = ""
    wall: float = 0.0
    text: str = ""  # stdout, or the output file
    err: str = ""  # stderr
    stats: List[Dict[str, float]] = field(default_factory=list)
    prelude_s: Optional[float] = None  # job start to its first count loop
    finalize_s: Optional[float] = None  # its last count loop to job end


class EngineRecorder:
    """Keep the IngestStats of every count loop the port runs on one
    card, by wrapping SortCountEngine.count_paths (every cell's tools
    count through it), and mark each loop with a `bench.ingest` span for
    the trace."""

    def __init__(self):
        self.stats: List[Dict[str, float]] = []
        self._saved = None

    def __enter__(self):
        import torch
        from kmer_tpu_torch.pipeline.counter import SortCountEngine

        real = SortCountEngine.count_paths

        def wrapped(eng, *a, **kw):
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.ingest"):
                out = real(eng, *a, **kw)
            self.stats.append(dict({f: float(getattr(eng.stats, f))
                                    for f in STAT_FIELDS},
                                   t_begin=t0, t_end=time.perf_counter()))
            return out

        self._saved = (SortCountEngine, real)
        SortCountEngine.count_paths = wrapped
        return self

    def __exit__(self, *exc):
        if self._saved:
            cls, real = self._saved
            cls.count_paths = real
            self._saved = None


def fill(cell: Cell, inputs: gen.Inputs, workdir: str) -> Dict[str, str]:
    """The placeholders a traffic mix's argv may name."""
    d = {"k": str(cell.config["k"]),
         "patterns": os.path.join(workdir, "out", "panel.pat"),
         **{key: str(v) for key, v in cell.traffic.get("params", {}).items()}}
    for key in ("fasta", "bed"):
        if key in inputs.extra:
            d[key] = inputs.extra[key]
    return d


def plan(cell: Cell, inputs: gen.Inputs, workdir: str, n: int,
         warm: bool = False) -> Job:
    """The n-th job of the cell's traffic.  A job takes the traffic's
    `inputs_per_job` files (1 by default), the next ones in turn, cycling
    through Inputs.files (the warm-up job: Inputs.warmup); in its argv
    `{input}` (or `{input0}`, `{input1}`, ...) is one of them, and an
    argument `{inputs}` stands for all of them."""
    t = cell.traffic
    m = int(t.get("inputs_per_job", 1))
    pool = inputs.warmup if warm else inputs.files
    files = tuple((n * m + i) % len(pool) for i in range(m))
    paths = [pool[i].path for i in files]
    out = os.path.join(workdir, "out", t["output"]) \
        if t.get("output") else None
    names = dict(fill(cell, inputs, workdir), output=out, input=paths[0],
                 **{f"input{i}": p for i, p in enumerate(paths)})
    argv = []
    for a in t["argv"]:
        argv.extend(paths if a == "{inputs}" else [a.format(**names)])
    return Job(t["tool"], argv, files, out)


def execute(job: Job, recorder: EngineRecorder) -> Job:
    """Run one job: the tool's entry with stdout and stderr captured."""
    import torch
    from kmer_tpu_torch.tools import get_tool

    out, err = io.StringIO(), io.StringIO()
    n0 = len(recorder.stats)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function("bench.job"), \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            job.rc = get_tool(job.tool)(job.argv)
    except Exception:  # noqa: BLE001 - a failed job is counted
        job.rc, job.error = None, traceback.format_exc()[-2000:]
    t1 = time.perf_counter()
    job.wall = t1 - t0
    job.stats = recorder.stats[n0:]
    if job.stats:  # the tool's own time before and after its count loops
        job.prelude_s = min(s["t_begin"] for s in job.stats) - t0
        job.finalize_s = t1 - max(s["t_end"] for s in job.stats)
    if job.rc != 0 and not job.error:
        job.error = f"exit {job.rc}: {err.getvalue()[-500:]}"
    job.err = err.getvalue()
    if job.output is None:
        job.text = out.getvalue()
    elif os.path.exists(job.output):
        with open(job.output, encoding="latin-1") as f:
            job.text = f.read()
    return job


class LocalRunner:
    """Jobs in this process, on its one card (or the CPU in the tests):
    the count loops' recorder, the peak of the card's memory, and the
    profiler."""

    cards = 1  # the cards its jobs use

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.recorder = EngineRecorder().__enter__()
        self.prof = None

    def run(self, job: Job) -> Job:
        execute(job, self.recorder)
        gc.collect()
        return job

    def reset_peak(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        import torch

        return torch.cuda.max_memory_allocated() if self.cuda else 0

    def trace_start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def trace_stop(self) -> None:
        self.prof.stop()

    def trace_summaries(self, path: str) -> List[tracing.Summary]:
        """The stopped trace, reduced (tracing.summarize)."""
        self.prof.export_chrome_trace(path)
        self.prof = None
        try:
            return [tracing.load(path)]
        finally:
            os.remove(path)

    def close(self) -> None:
        self.recorder.__exit__()
        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()


@dataclass
class Run:
    """What the per-layer metric readers (metrics/<name>.py) read."""
    cell: Cell
    inputs: gen.Inputs
    jobs: List[Job]  # the window's jobs
    traced: List[Job]  # the jobs of the profiled stretch
    summaries: List[tracing.Summary]  # one a chip, of that stretch
    device_name: str

    def bases(self, jobs=None) -> int:
        """The bases the jobs read (the window's by default)."""
        return sum(self.inputs.files[i].bases
                   for j in (self.jobs if jobs is None else jobs)
                   for i in j.files)

    def stat(self, name: str) -> float:
        """An IngestStats field summed over the window's count loops."""
        return sum(s[name] for j in self.jobs for s in j.stats)


def build_port(cuda: bool) -> None:
    """Load the port's native reader and, on a card, its kernel library:
    each builds at its first use in a checkout (g++, nvcc) and loads
    after.  A port without these entry points builds in the warm-up job
    instead."""
    with contextlib.suppress(ImportError, AttributeError):
        from kmer_tpu_torch.io import native

        native.available()
    if cuda:
        with contextlib.suppress(ImportError, AttributeError):
            from kmer_tpu_torch.kernels import _build

            _build.library()


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = r.stdout.strip().splitlines()
    return lines[0] if lines else ""


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, workdir: str, require_cuda: bool = True
             ) -> dict:
    """One run of `cell`: the result line's object (its `checks` last).
    Raises where a run can print no result."""
    import torch

    cuda = torch.cuda.is_available()
    if require_cuda and not cuda:
        raise RuntimeError("no CUDA device")
    os.makedirs(os.path.join(workdir, "out"), exist_ok=True)
    marks = [("start", time.perf_counter())]  # set-up's stages
    build_port(cuda)
    marks.append(("build", time.perf_counter()))
    inputs = gen.make_inputs(
        cell.config, seed, workdir,
        int(cell.traffic.get("warmup_bases", WARMUP_BASES)), cell.base)
    marks.append(("inputs", time.perf_counter()))
    runner = LocalRunner(cuda)
    try:
        for step in cell.traffic.get("setup", []):
            names = fill(cell, inputs, workdir)
            job = runner.run(Job(step["tool"], [a.format(**names)
                                                for a in step["argv"]], ()))
            if job.rc != 0:
                raise RuntimeError(f"set-up {step['tool']}: {job.error}")
        marks.append(("setup_steps", time.perf_counter()))
        warm = runner.run(plan(cell, inputs, workdir, 0, warm=True))
        marks.append(("warmup", time.perf_counter()))
        if warm.rc != 0:
            raise RuntimeError(f"warm-up job: {warm.error}")
        runner.reset_peak()
        gc.freeze()  # set-up's objects: later collections skip them
        jobs: List[Job] = []
        traced: List[Job] = []
        if trace:  # started before the window: it takes seconds
            runner.trace_start()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while True:
            jobs.append(runner.run(plan(cell, inputs, workdir, len(jobs))))
            now = time.perf_counter() - t0
            if trace and not traced and (now >= TRACE_SECONDS
                                         or now >= seconds):
                runner.trace_stop()
                traced = list(jobs)
            if now >= seconds:
                break
        window_s = time.perf_counter() - t0
        peak = runner.peak()
        summaries = (runner.trace_summaries(os.path.join(workdir, "trace"))
                     if trace else [])
    finally:
        gc.unfreeze()
        runner.close()
    foreign = foreign_modules()
    if foreign:
        raise ForeignModules(foreign)
    device = torch.cuda.get_device_name(0) if cuda else "cpu"
    for j in [j for j in jobs if j.rc != 0][:1]:  # the first failure
        sys.stderr.write(f"h100bench: a job failed: {j.tool} {j.argv}: "
                         f"{j.error}\n")
    t_ref = time.perf_counter()
    checks = judge(cell, inputs, jobs, workdir)
    parts = {f"{name}_s": b - a for (_, a), (name, b)
             in zip([("", t_start)] + marks, marks)}
    stages = ", ".join(f"{name} {v:.3f}" for name, v in parts.items())
    sys.stderr.write(
        f"h100bench: set-up {setup_s:.3f} s ({stages}); {len(jobs)} jobs "
        f"in a window of {window_s:.3f} s; walls "
        f"{[round(j.wall, 3) for j in jobs]}; reader_s "
        f"{[round(sum(s['reader_s'] for s in j.stats), 3) for j in jobs]}; "
        f"the reference took {time.perf_counter() - t_ref:.3f} s\n")
    run = Run(cell, inputs, jobs, traced, summaries, device)
    return result(run, checks, setup_s, window_s, peak, trace,
                  power_limit() if cuda else "", parts)


class ForeignModules(RuntimeError):
    def __init__(self, names):
        super().__init__(f"modules of JAX or the JAX package were loaded: "
                         f"{names}")
        self.names = names


def rows_off(got: str, want: str) -> int:
    """Lines of `want` that `got` does not hold at their place, plus the
    lines that one has beyond the other."""
    a, b = got.splitlines(), want.splitlines()
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def judge(cell: Cell, inputs: gen.Inputs, jobs: List[Job], workdir: str
          ) -> Dict[str, List[int]]:
    """The numbers that decide `correct`, each [value, limit]: lines of
    the jobs' outputs unlike the reference's, jobs that failed, lines of
    set-up files unlike the reference's."""
    import torch

    check = load_module("checks", cell.traffic["check"], cell.base)
    keys = sorted({j.files for j in jobs})
    want = check.expected(inputs, cell, keys, reference_device(), False)
    got = getattr(check, "got", lambda job: job.text)
    off = sum(rows_off(got(j), want["jobs"][j.files]) for j in jobs)
    out = {"rows_off": [off, 0],
           "jobs_failed": [sum(j.rc != 0 for j in jobs), 0]}
    for name, text in want.get("setup", {}).items():
        path = fill(cell, inputs, workdir)[name]
        got = open(path, encoding="latin-1").read() \
            if os.path.exists(path) else ""
        out[f"{name}_rows_off"] = [rows_off(got, text), 0]
    del want
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def reference_device():
    import torch

    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def result(run: Run, checks: Dict[str, List[int]], setup_s: float,
           window_s: float, peak: int, trace: bool, power: str,
           setup_parts: Dict[str, float]) -> dict:
    """The result line's object.  `setup_parts` (seconds of set-up's
    stages: process start, the port's build, the inputs, set-up steps,
    the warm-up job) goes into the line apart from `setup_s`, so a
    checkout's first run, whose build takes minutes, shows why."""
    jobs = run.jobs
    values = {}
    if not trace:
        values = {"setup_s": setup_s,
                  "mbases_per_s": run.bases() / 1e6 / window_s,
                  "peak_device_gib": peak / 2**30}
        wanted = run.cell.end_to_end
    else:
        wanted = run.cell.per_layer
        for m in wanted:
            v = load_module("metrics", m["name"], run.cell.base).read(run)
            if v is not None:
                values[m["name"]] = v
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if m["name"] in values}
    correct = all(v <= lim for v, lim in checks.values())
    device = {"platform": "gpu" if run.device_name != "cpu" else "cpu",
              "kind": run.device_name, "count": LocalRunner.cards,
              "memory_peak_bytes": peak, "power": power}
    out = {"correct": correct, "attempted": len(jobs),
           "failed": sum(j.rc != 0 for j in jobs), "metrics": metrics,
           "device": device, "setup_parts": setup_parts}
    if trace and run.summaries:
        s = run.summaries
        device["busy_s"] = sum(x.busy_s for x in s) / len(s)
        device["window_s"] = max(x.window_s for x in s)
        out["breakdown"] = tracing.breakdown(s[0])
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in checks.items()}
    return out
