"""The harness on the CPU: every cell of ``BENCHMARK.json`` resolves by
name, new cells, mixes, configurations and metrics are found from files
alone, a tiny run prints the contract's last line, and a run loads
neither JAX nor the JAX package.

Run from the repository's root: ``python -m pytest simbench/tests``.
"""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from simbench import check, harness
from simbench.runners import sweep

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_resolves_by_name():
    for work in BENCH["workloads"]:
        _, config, traffic, _ = harness.load_cell(work["name"])
        assert (ROOT / "simbench" / "runners"
                / f"{config['runner']}.py").is_file()
        assert (ROOT / "simbench" / "reference"
                / f"{config['reference']}.py").is_file()
        assert set(config["check"]) == {"mismatched_counters",
                                        "max_rel_gap"}
        assert sweep.kernels(traffic)
    for metric in BENCH["per_layer"]:
        assert callable(harness.reader(metric["name"]).read)


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    configs = {c["name"]: c for c in BENCH["configs"]}
    for work in BENCH["workloads"]:
        assert work["config"] in configs and work["chips"] == 1
        assert len(work["why"]) <= 200
    for c in configs.values():
        assert (ROOT / c["file"]).is_file()
        assert set(c["reduced"]) == set(json.loads(
            (ROOT / c["file"]).read_text())["source_values"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_holds_its_distinct_points(cell):
    _, config, traffic, _ = harness.load_cell(cell)
    kernels = {"timing-sweep": 46, "hiloc-sweep": 16}[traffic_of(cell)]
    geoms = sweep.geometries(config, traffic)
    assert len(sweep.kernels(traffic)) == kernels
    assert len(sweep.kernels(traffic)) * traffic["draws"] * len(geoms) == 9936
    assert len({tuple(sorted(g.items())) for g in geoms}) == len(geoms)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_knob_of_a_cell_changes_its_results(cell):
    """Each knob the mix varies is one the cell's architecture reads:
    one trace under the knob's least and largest value gives two
    different results, so no point of the grid repeats another."""
    import torch
    from repro_torch.core import GpuGeometry, SweepGrid, Trace
    _, config, traffic, _ = harness.load_cell(cell)
    t = sweep.traces(dict(config, rounds=48), dict(traffic, draws=1), 5)[0]
    for knob, values in traffic["knobs"].items():
        geoms = [GpuGeometry(**dict(config["geometry"], **{knob: v}))
                 for v in (min(values), max(values))]
        grid = SweepGrid([config["arch"]], geoms, [Trace(*t)],
                         nocs=[config["noc"]])
        lo, hi = (check.flatten(r) for r in
                  grid.run(device=torch.device("cpu")).results)
        assert lo != hi, knob


def traffic_of(cell: str) -> str:
    return next(w["traffic"] for w in BENCH["workloads"]
                if w["name"] == cell)


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = ["repro_torch", "repro_torch.core", "jax.numpy", "repro.core",
              "jaxlib", "flaxen", "reprox"]
    assert harness.forbidden_modules(loaded) == ["jax.numpy", "jaxlib",
                                                 "repro.core"]


def test_the_yardsticks_import_nothing_of_the_program():
    code = ("import sys; sys.path[0] = sys.argv[1]\n"
            "import simbench.check, simbench.tracegen, simbench.roofline, "
            "simbench.reference.cachesim, simbench.devtrace, simbench.control\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'jaxlib', 'flax')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code, str(ROOT)], check=True,
                   timeout=120)


# ---------------------------------------------------------------------------
# runs in a copy of the benchmark, with cells of its own
# ---------------------------------------------------------------------------
#: 168 points under six geometries that both architectures read
TINY_TRAFFIC = {"apps": ["SN", "HS3D"], "m": 4, "draws": 2,
                "knobs": {"hide": [5.0, 20.0], "svc_l2": [2, 4, 8]}}


def tiny_copy(tmp_path: Path, program=True) -> Path:
    """A checkout holding ``BENCHMARK.json`` and ``simbench/`` (and the
    program, linked), with a tiny configuration, mix and metric added as
    files and named in ``BENCHMARK.json``: no code is edited."""
    shutil.copytree(ROOT / "simbench", tmp_path / "simbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if program:
        (tmp_path / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for arch in ("ata", "private"):
        config = json.loads((ROOT / "simbench" / "configs"
                             / f"table2-{arch}.json").read_text())
        config.update(name=f"tiny-{arch}", rounds=24)
        path = f"simbench/configs/tiny-{arch}.json"
        (tmp_path / path).write_text(json.dumps(config))
        bench["configs"].append({"name": f"tiny-{arch}", "source": "test",
                                 "file": path, "reduced": ["rounds"],
                                 "why": "a test"})
        bench["workloads"].append({"name": f"{arch}.tiny",
                                   "config": f"tiny-{arch}",
                                   "traffic": "tiny", "chips": 1,
                                   "why": "a test"})
    (tmp_path / "simbench" / "traffic" / "tiny.json").write_text(
        json.dumps(TINY_TRAFFIC))
    (tmp_path / "simbench" / "metrics" / "window_ms.py").write_text(
        "def read(cap):\n    return (cap.window[1] - cap.window[0]) / 1e6\n")
    bench["per_layer"].append({"name": "window_ms", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "device",
                               "moves": "sim_requests_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def run_cell(checkout: Path, workload: str, *extra, trace=0, device="cpu",
             prelude=""):
    """Run ``simbench/run.py`` in ``checkout`` (``prelude``: Python run
    first in the same process, to plant a fault); returns the process."""
    args = ["--workload", workload, "--seed", str(3_000_000_019),
            "--seconds", "1", "--trace", str(trace)]
    if device:
        args += ["--device", device]
    env = dict(os.environ, PYTHONPATH="")
    code = ("import runpy, sys\n"
            f"sys.argv = ['simbench/run.py'] + {list(args) + list(extra)!r}\n"
            f"sys.path[:0] = ['{checkout}', '{checkout}/src']\n"
            f"{prelude}\n"
            "runpy.run_path('simbench/run.py', run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def last_line(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_tiny_run_prints_the_contract_line(tmp_path):
    checkout = tiny_copy(tmp_path)
    for arch in ("ata", "private"):
        line = last_line(run_cell(checkout, f"{arch}.tiny"))
        assert list(line)[-1] == "checks"
        assert line["correct"] is True and line["failed"] == 0
        assert line["attempted"] % 8 == 0 and line["attempted"] > 0
        assert set(line["metrics"]) == {"sim_requests_per_s", "setup_s"}
        assert line["metrics"]["sim_requests_per_s"]["unit"] == "req/s"
        assert set(line["device"]) == {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        assert line["checks"]["mismatched_counters"]["value"] == 0


def test_new_files_are_found_with_no_code_edit(tmp_path):
    """The tiny configuration, mix and metric of :func:`tiny_copy` are
    new files; a traced run reads the new metric."""
    checkout = tiny_copy(tmp_path)
    line = last_line(run_cell(checkout, "private.tiny", trace=1))
    assert line["correct"] is True
    assert line["metrics"]["window_ms"]["value"] > 0
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_run_without_a_card_or_the_program_prints_nothing(tmp_path):
    checkout = tiny_copy(tmp_path, program=False)
    proc = run_cell(checkout, "ata.tiny")
    assert proc.returncode != 0 and not proc.stdout.strip()
    if not harness_has_card():
        checkout = tiny_copy(tmp_path / "with_program")
        proc = run_cell(checkout, "ata.tiny", device=None)
        assert proc.returncode != 0 and not proc.stdout.strip()


def test_a_run_that_loads_jax_prints_nothing(tmp_path):
    checkout = tiny_copy(tmp_path)
    proc = run_cell(checkout, "ata.tiny", prelude=(
        "import types; sys.modules['jax'] = types.ModuleType('jax')"))
    assert proc.returncode != 0 and not proc.stdout.strip()
    assert "jax" in proc.stderr


def harness_has_card() -> bool:
    import torch
    return torch.cuda.is_available()


@pytest.mark.parametrize("seed", [1, 3_000_000_019])
def test_trace_seeds_change_values_not_sizes(seed):
    _, config, traffic, _ = harness.load_cell("ata.hiloc-sweep")
    traffic = dict(traffic, draws=2)
    a = sweep.traces(dict(config, rounds=16), traffic, seed)
    b = sweep.traces(dict(config, rounds=16), traffic, seed + 1)
    assert [t.addr.shape for t in a] == [t.addr.shape for t in b]
    assert any((x.addr != y.addr).any() for x, y in zip(a, b))
