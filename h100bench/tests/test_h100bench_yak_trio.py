"""The two-file yak cell's pieces: its span readers (yak_spans.py,
metrics/yak_*.py, metrics/bloom_roofline.py) against stores of the
port's spans built by hand, the admission's work count, and the cell run
small on the CPU, traced, with its control."""

import numpy as np
import pytest

from h100bench import bloom_work, gen, harness, spec, trace
from h100bench.spec import load_module
from h100bench.tests.test_h100bench_port_spans import _span

CELL = "yak_trio_b37"
H100 = "NVIDIA H100 80GB HBM3"
METRICS = ["bloom_roofline", "yak_pass1_s_per_gbase",
           "yak_pass2_s_per_gbase", "yak_shrink_ms_per_job"]


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")


def _job_spans(lo, bases=500_000_000, lanes=(1000, 3000)):
    """One job's spans from lo: pass 1 of 4 s with a bloom span a block,
    pass 2 of 5 s, a shrink of 0.25 s."""
    p1 = _span("yak.pass", lo, lo + 4.0, bases=bases, **{"pass": 1})
    out = [p1]
    for i, n in enumerate(lanes):
        b = _span("yak.bloom", lo + 1.0 + i, lo + 1.5 + i, lanes=n)
        b.parent = p1.id
        out.append(b)
    out.append(_span("yak.pass", lo + 4.0, lo + 9.0, bases=bases,
                     **{"pass": 2}))
    out.append(_span("yak.shrink", lo + 9.0, lo + 9.25))
    return out


def _run(n_traced=1, kernel_s=0.0):
    """n_traced traced jobs, each of one 0.5 Gbase file under two
    names; a trace whose bloom kernels took kernel_s."""
    reads = np.broadcast_to(np.zeros(1, np.uint8), (5_000_000, 100))
    inputs = gen.Inputs([gen.ReadSet("/in/a.fq.gz", reads),
                         gen.ReadSet("/in/a.again.fq.gz", reads)], [])
    jobs = [harness.Job("yak-count", [], (0, 1)) for _ in range(n_traced)]
    summ = trace.Summary(10.0, 1.0, {
        "void (anonymous namespace)::bloom_admit_kernel<true>(long)":
            kernel_s / 2,
        "void (anonymous namespace)::bloom_probe_kernel(long)": kernel_s / 4,
        "void (anonymous namespace)::bloom_clear_kernel(long)": kernel_s / 4,
        "void cub::DeviceRadixSortOnesweepKernel<long>()": 7.0}, {})
    return harness.Run(spec.load_cell(CELL), inputs, jobs, jobs, [summ], H100)


def _read(monkeypatch, name, store, run):
    from kmer_tpu_torch.utils import trace as port_trace

    monkeypatch.setattr(port_trace, "spans", lambda: list(store))
    return load_module("metrics", name).read(run)


def test_readers_take_the_last_jobs(monkeypatch):
    """An earlier run's job (other numbers) before the traced one: pass 1
    4 s and pass 2 5 s over 0.5 Gbases each, a 250 ms shrink, and the
    bloom's 4000 lanes at 80 bytes over the card's rate and 1 us of
    bloom kernels (a radix sort's time not counted)."""
    store = _job_spans(0.0, lanes=(7,)) + _job_spans(100.0)
    run = _run(kernel_s=1e-6)
    got = {m: _read(monkeypatch, m, store, run) for m in METRICS}
    assert got["yak_pass1_s_per_gbase"] == pytest.approx(8.0)
    assert got["yak_pass2_s_per_gbase"] == pytest.approx(10.0)
    assert got["yak_shrink_ms_per_job"] == pytest.approx(250.0)
    assert bloom_work.admission_bytes(4000) == 4000 * 80
    assert got["bloom_roofline"] == pytest.approx(
        100 * 4000 * 80 / 3.35e12 / 1e-6)


@pytest.mark.parametrize("fault", ["no_spans", "bases", "no_kernels",
                                   "one_pass"])
def test_readers_give_none(monkeypatch, fault):
    """No yak spans (a port without them, as the parent of the change
    that added them), a job whose passes' bases are not its inputs', a
    trace without the bloom kernels (bloom_roofline only), or a job with
    one pass: no number, and no exception."""
    store = _job_spans(0.0)
    run = _run(kernel_s=0.0 if fault == "no_kernels" else 1e-3)
    if fault == "no_spans":
        store = [s for s in store if not s.name.startswith("yak.")]
    elif fault == "bases":
        store = _job_spans(0.0, bases=400_000_000)
    elif fault == "one_pass":
        store = store[:-2]
    got = {m: _read(monkeypatch, m, store, run) for m in METRICS}
    if fault == "no_kernels":
        assert got["bloom_roofline"] is None
        assert got["yak_pass1_s_per_gbase"] == pytest.approx(8.0)
    else:
        assert got == dict.fromkeys(METRICS)


def _small(bloom_bits):
    cell = spec.load_cell(CELL)
    cell.config["genome"]["bases"] = 60_000
    cell.config["reads"]["count"] = 4_000
    cell.traffic["params"].update(bloom_bits=bloom_bits, chunk=100_000)
    return cell


def test_cell_runs_small_on_cpu(tmp_path):
    """The cell at a small size (a bloom of 2^22 bits) on the CPU,
    traced: correct, the passes' and the shrink's metrics read (the
    bloom's, a device number, does not on the CPU); the check's control
    text at the cell's own -b37, clamped to 2^31 bits, equals its
    expected text at this size (no false positive in so large a bloom
    from 4,000 reads), so the clamp shows only at the cell's size."""
    res = harness.run_cell(_small(22), 2**33 + 3, 0.5, True, 0.0,
                           str(tmp_path / "run"), require_cuda=False)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["rows_off"] == {"value": 0, "limit": 0}
    m = res["metrics"]
    assert set(m) >= {"yak_pass1_s_per_gbase", "yak_pass2_s_per_gbase",
                      "yak_shrink_ms_per_job"}
    assert "bloom_roofline" not in m
    cell = _small(37)
    inputs = gen.make_inputs(cell.config, 2**33 + 3, str(tmp_path), 0)
    check = load_module("checks", cell.traffic["check"])
    want, ctrl = (check.expected(inputs, cell, [(0, 1)], "cpu", c)["jobs"]
                  for c in (False, True))
    assert want == ctrl and want[(0, 1)].count("[M") == 13


@pytest.mark.parametrize("clamp,off", [(19, True), (31, False)])
def test_control_sees_the_clamp(tmp_path, monkeypatch, clamp, off):
    """control.py's jobs hold the control's text in stdout and stderr
    alike; the check takes its `[M` lines once, so the control's rows
    off count exactly the lines the clamp changes: some where the
    clamped bloom admits false positives (2^19 bits here), none where it
    admits as the cell's own does (2^31 bits for 4,000 reads)."""
    from h100bench import control
    from h100bench.reference import yak_wide

    monkeypatch.setattr(yak_wide, "CLAMP_SHIFT", clamp)
    checks = control.control_checks(_small(37), 2**33 + 3,
                                    str(tmp_path / "ctl"))
    assert checks["jobs_failed"] == [0, 0]
    assert (checks["rows_off"][0] > 0) == off
