"""A run on the CPU end to end at a small size: the last line's schema,
the import check by whole top-level names, cells, metrics and
configurations found from files alone, the control and planted faults
coming out not correct."""

import json
import os
import subprocess
import sys

import pytest
import torch

from h100bench import harness, spec
from h100bench.tests.helpers import CELLS, run_small, small_cell

ROOT = spec.ROOT


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("KMER_TPU_PLATFORM", "cpu")


def _schema(res, trace):
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert isinstance(res["correct"], bool) and res["attempted"] >= 1
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    # set-up's stages, the build apart
    assert {"build_s", "inputs_s", "warmup_s"} <= set(res["setup_parts"])
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_run_is_correct_and_well_formed(cell, trace):
    res = run_small(cell, trace=trace)
    _schema(res, trace)
    assert res["correct"] and res["failed"] == 0
    c = spec.load_cell(cell)
    want = c.per_layer if trace else c.end_to_end
    got = set(res["metrics"])
    # on the CPU the device readers find nothing and say nothing
    device_only = {"extract_roofline", "sort_merge_ms_per_gbase",
                   "device_idle_share"}
    assert got == {m["name"] for m in want} - (device_only if trace
                                                else set())
    if not trace:
        assert res["metrics"]["mbases_per_s"]["value"] > 0


@pytest.mark.parametrize("mods, bad", [
    (["kmer_tpu_torch", "kmer_tpu_torch.tools", "jaxtyping", "benchmark"],
     []),
    (["kmer_tpu.tools.kc", "numpy"], ["kmer_tpu"]),
    (["jax.numpy", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["bench", "chip_smoke"], ["bench", "chip_smoke"]),
])
def test_forbidden_modules_by_whole_top_level_name(mods, bad):
    assert harness.foreign_modules(dict.fromkeys(mods)) == bad


def test_a_run_loads_no_jax():
    code = ("import os, sys, tempfile; os.environ['KMER_TPU_PLATFORM']="
            "'cpu'; sys.path.insert(0, %r); "
            "from h100bench.tests.helpers import run_small; "
            "r = run_small('mabs_kc_c4'); "
            "from h100bench.harness import foreign_modules; "
            "print(r['correct'], foreign_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.stdout.split()[-2:] == ["True", "[]"], out.stderr[-2000:]


def test_foreign_module_fails_the_run(monkeypatch):
    monkeypatch.setitem(sys.modules, "kmer_tpu", type(sys)("kmer_tpu"))
    with pytest.raises(harness.ForeignModules) as e:
        run_small("mabs_kc_c4")
    assert e.value.names == ["kmer_tpu"]


def test_run_py_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                          "mabs_kc_c4", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_run_py_refuses_outside_a_checkout(tmp_path):
    """In a directory that holds only BENCHMARK.json and h100bench/, no
    port can be loaded: no result, a code other than 0."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "h100bench"), tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                          "mabs_kc_c4", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path,
                         env={**os.environ, "KMER_TPU_PLATFORM": "cpu"})
    assert out.returncode != 0 and out.stdout == ""


def test_new_cell_metric_and_config_from_files_alone(tmp_path):
    base = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics", "checks", "data"):
        (base / d).mkdir(parents=True)
    cfg = json.load(open(os.path.join(spec.HERE, "configs",
                                      "mabs_k31.json")))
    cfg.update(name="tiny_k21", k=21, data="two_files")
    # a data kind of its own: the reads in two files, taken in turn
    (base / "data" / "two_files.py").write_text(
        "from h100bench import gen\n"
        "def make(cfg, seed, workdir, warmup_bases, device):\n"
        "    g = gen.genome_codes((seed, 1), cfg['genome']['bases'], 0.5,\n"
        "                         device)\n"
        "    n = cfg['reads']['count']\n"
        "    sets = [gen.ReadSet(p, gen.write_reads(p, g, n, cfg, (seed, i)))\n"
        "            for i, p in enumerate(gen.reads_path(workdir, cfg, s)\n"
        "                                  for s in ('a', 'b', 'w'))]\n"
        "    return gen.Inputs(sets[:2], sets[2:])\n")
    cfg["genome"]["bases"], cfg["reads"]["count"] = 50_000, 3_000
    (base / "configs" / "tiny_k21.json").write_text(json.dumps(cfg))
    (base / "traffic" / "kc_c4_twice.json").write_text(json.dumps(
        {"tool": "kc-c4", "argv": ["-k{k}", "{input}"],
         "check": "kc_hist"}))
    (base / "checks" / "kc_hist.py").write_text(
        open(os.path.join(spec.HERE, "checks", "kc_hist.py")).read())
    (base / "metrics" / "jobs_run.py").write_text(
        "def read(run):\n    return float(len(run.jobs))\n")
    bench = {
        "configs": [{"name": "tiny_k21", "source": "x", "reduced": [],
                     "file": str(base / "configs" / "tiny_k21.json")}],
        "workloads": [{"name": "tiny_kc", "config": "tiny_k21",
                       "traffic": "kc_c4_twice", "chips": 1}],
        "end_to_end": [{"name": "mbases_per_s", "unit": "Mbases/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "jobs_run", "unit": "jobs",
                       "moves": "mbases_per_s",
                       "workloads": ["tiny_kc"]}],
    }
    cell = spec.load_cell("tiny_kc", bench, str(tmp_path), str(base))
    assert cell.config["k"] == 21 and cell.traffic["tool"] == "kc-c4"
    assert [m["name"] for m in cell.per_layer] == ["jobs_run"]
    with __import__("tempfile").TemporaryDirectory() as wd:
        res = harness.run_cell(cell, 4, 0.2, True, 0.0, wd,
                               require_cuda=False)
    assert res["correct"] and res["attempted"] >= 1
    assert res["metrics"]["jobs_run"]["value"] == res["attempted"]


def test_a_job_takes_several_inputs(tmp_path):
    """`inputs_per_job` files a job, in turn; `{inputs}` expands to all
    of them, `{input1}` names the second."""
    from h100bench import gen

    cell = small_cell("mabs_kc_c4")
    cell.traffic = {"tool": "yak-count", "inputs_per_job": 2,
                    "argv": ["-k{k}", "-o{input1}.yak", "{inputs}"]}
    files = [gen.ReadSet(f"/in/{i}.fa.gz", None) for i in range(3)]
    inputs = gen.Inputs(files, [gen.ReadSet("/in/w.fa.gz", None)])
    jobs = [harness.plan(cell, inputs, str(tmp_path), n) for n in range(3)]
    assert [j.files for j in jobs] == [(0, 1), (2, 0), (1, 2)]
    assert jobs[1].argv == ["-k31", "-o/in/0.fa.gz.yak", "/in/2.fa.gz",
                            "/in/0.fa.gz"]
    warm = harness.plan(cell, inputs, str(tmp_path), 0, warm=True)
    assert warm.argv[-2:] == ["/in/w.fa.gz", "/in/w.fa.gz"]


def test_run_py_refuses_a_cell_of_several_cards(tmp_path):
    """One process drives one card: a four-card cell exits 3 with no
    result rather than run on one card and report four."""
    import shutil

    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    w = dict(bench["workloads"][0], name="four_cards", chips=4)
    bench["workloads"].append(w)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(os.path.join(ROOT, "h100bench"), tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "h100bench/run.py", "--workload",
                          "four_cards", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 3 and out.stdout == ""
    assert "asks for 4 cards" in out.stderr


def test_warmup_is_small_and_of_the_cells_shapes():
    """The warm-up job reads a small file of the same generator: the
    same read length and format, at most WARMUP_BASES bases."""
    from h100bench import gen

    for name in CELLS:
        cfg = spec.load_cell(name).config
        n = gen.warmup_reads(cfg, 10**9, harness.WARMUP_BASES)
        assert n * cfg["reads"]["length"] <= harness.WARMUP_BASES
        assert gen.warmup_reads(cfg, 7, harness.WARMUP_BASES) == 7


def test_control_is_not_correct():
    sys.path.insert(0, spec.HERE)
    import control

    for name in CELLS:
        cell = small_cell(name, **({"reads.count": 30_000,
                                    "genome.bases": 300_000}
                                   if name != "ngscm_vaf" else
                                   {"cohort.bases_per_sample": 600_000,
                                    "panel.sites": 2000,
                                    "genome.bases": 1_000_000}))
        with __import__("tempfile").TemporaryDirectory() as wd:
            checks = control.control_checks(cell, 2**32 + 9, wd)
        assert checks["rows_off"][0] > checks["rows_off"][1], name


def _fault(monkeypatch, kind):
    from kmer_tpu_torch.table import compactor

    real_add, real_hist = (compactor.KmerCompactor.add_raw,
                           compactor.KmerCompactor.hist)
    real_counts = compactor.KmerCompactor.counts_for
    if kind == "state_unchanged":
        monkeypatch.setattr(compactor.KmerCompactor, "add_raw",
                            lambda self, keys: None)
    elif kind == "half_the_batch":  # every other lane: planes are padded
        monkeypatch.setattr(
            compactor.KmerCompactor, "add_raw",
            lambda self, keys: real_add(self, keys[::2].contiguous()))
    elif kind == "answer_altered":
        def hist(self, *a, **kw):
            h, n = real_hist(self, *a, **kw)
            h = h.copy()
            h[2] += 1
            return h, n

        def counts_for(self, *a):
            out = real_counts(self, *a).copy()
            out[len(out) // 2] += 1
            return out

        monkeypatch.setattr(compactor.KmerCompactor, "hist", hist)
        monkeypatch.setattr(compactor.KmerCompactor, "counts_for",
                            counts_for)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ["state_unchanged", "half_the_batch",
                                  "answer_altered"])
def test_planted_fault_is_not_correct(monkeypatch, cell, kind):
    """The timed path broken underneath; only the jobs of the window see
    it when set-up has already run (snp-pattern-gen is judged apart)."""
    _fault(monkeypatch, kind)
    res = run_small(cell)
    assert not res["correct"]
    assert res["checks"]["rows_off"]["value"] > 0
