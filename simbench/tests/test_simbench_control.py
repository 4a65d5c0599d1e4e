"""The comparison that decides ``correct`` fails what it has to fail.

* The control, the plain reference in bfloat16 put in the program's
  place, fails the cell's limits: at a tiny size here, at the cell's own
  size on the card (``gpu``; ``python -m pytest -m gpu simbench/tests``).
* A run whose timed path is broken underneath reads ``correct`` false,
  once for each fault a sweep cell can have: a round that returns its
  state unchanged, half of the points left out with the other half's
  results in their place, and an answer altered where it is produced.
  (A cell on one card has no exchange between cards to leave out.)
"""
import json

import pytest

from simbench import control, harness
from simbench.tests.test_simbench_harness import (TINY_TRAFFIC, last_line,
                                                  run_cell, tiny_copy)


@pytest.mark.parametrize("arch", ["ata", "private"])
def test_the_control_fails_the_limits_at_a_tiny_size(tmp_path, arch):
    import torch
    checkout = tiny_copy(tmp_path)
    config = json.loads((checkout / "simbench" / "configs"
                         / f"tiny-{arch}.json").read_text())
    v = control.control_numbers(config, TINY_TRAFFIC, 3_000_000_019,
                                torch.device("cpu"))
    assert not v["ok"], v


FAULTS = {
    "state_unchanged": (
        "import repro_torch.core.simulator as S\n"
        "_round = S._round\n"
        "def stuck(runs, geom, insn, core_app, state, *a, **k):\n"
        "    return state, _round(runs, geom, insn, core_app, state,"
        " *a, **k)[1]\n"
        "S._round = stuck\n"),
    "half_the_points": (
        "from repro_torch.core import sweep as W\n"
        "_run = W.SweepGrid.run\n"
        "def half(self, *a, **k):\n"
        "    h = len(self.points) // 2\n"
        "    out = _run(W.SweepGrid.from_points(self.points[:h]), *a, **k)\n"
        "    rest = out.results[:len(self.points) - h]\n"
        "    return out._replace(results=out.results + rest)\n"
        "W.SweepGrid.run = half\n"),
    "answer_altered": (
        "import repro_torch.core.simulator as S\n"
        "_summarize = S._summarize\n"
        "def altered(stats, trace):\n"
        "    r = _summarize(stats, trace)\n"
        "    return r._replace(l2_accesses=r.l2_accesses + 1)\n"
        "S._summarize = altered\n"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("arch", ["ata", "private"])
def test_a_broken_timed_path_reads_not_correct(tmp_path, fault, arch):
    checkout = tiny_copy(tmp_path)
    line = last_line(run_cell(checkout, f"{arch}.tiny",
                              prelude=FAULTS[fault]))
    assert line["correct"] is False, json.dumps(line["checks"])


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["ata.timing-sweep", "private.timing-sweep",
                                  "ata.hiloc-sweep"])
def test_the_control_fails_the_limits_at_the_cells_size(cuda_device, cell):
    _, config, traffic, _ = harness.load_cell(cell)
    v = control.control_numbers(config, traffic, 3_000_000_019, cuda_device)
    assert not v["ok"], v
