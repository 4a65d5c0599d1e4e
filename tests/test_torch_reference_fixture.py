"""Reference results the CUDA card is checked against.

The machine with the card has no JAX, so the reference package's
``simulate()`` results for kernel 0 of every app under the four paper
architectures, at the full 1536 rounds, are stored in
``src/repro_torch/data/reference_kernel0.json``; ``chip_smoke.py``
holds the port's full-suite run against them.

Regenerate the file with::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_reference_fixture.py

The test recomputes two of its cells with JAX and checks the file.
"""
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

from repro.core import APPS, PAPER_GEOMETRY, make_trace, simulate  # noqa: E402
from repro.core.arch import PAPER_ARCHITECTURES  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIXTURE = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                       "data", "reference_kernel0.json")


def result_dict(r) -> dict:
    """A SimResult as plain JSON data (nested blocks as dicts)."""
    d = r._asdict()
    d["per_app"] = [a._asdict() for a in r.per_app]
    d["noc"] = r.noc._asdict()
    return d


def reference_cell(app: str, arch: str) -> dict:
    return result_dict(simulate(arch, make_trace(APPS[app], kernel=0)))


def write_fixture(path: str = FIXTURE) -> None:
    results = {app: {arch: reference_cell(app, arch)
                     for arch in PAPER_ARCHITECTURES} for app in APPS}
    doc = {
        "what": "repro.core.simulate() of kernel 0 of every app, paper "
                "geometry, ideal NoC, default probe backend",
        "rounds": {app: APPS[app].rounds for app in APPS},
        "results": results,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


#: Counters that must agree exactly; every other float within rtol=1e-6,
#: the bar of the reference's own goldens (tests/test_arch_registry.py).
EXACT = {"l2_accesses", "dram_accesses", "noc_flits", "local_hits",
         "remote_hits", "requests", "l1_lat_n", "flits_injected",
         "flits_delivered", "app", "cores"}


def assert_result_close(got: dict, want: dict, where: str = "") -> None:
    """Nested SimResult dicts agree: EXACT fields bit-equal, NaN where
    NaN, other floats within rtol=1e-6."""
    assert set(got) == set(want), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_result_close(g, w, f"{where}.{k}")
        elif isinstance(w, list):
            assert len(g) == len(w), f"{where}.{k}"
            for i, (gi, wi) in enumerate(zip(g, w)):
                assert_result_close(gi, wi, f"{where}.{k}[{i}]")
        elif k in EXACT:
            assert g == w, (f"{where}.{k}", g, w)
        elif isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), f"{where}.{k}"
        else:
            assert math.isclose(g, w, rel_tol=1e-6, abs_tol=0.0), \
                (f"{where}.{k}", g, w)


def test_fixture_covers_every_app_and_paper_arch():
    with open(FIXTURE) as f:
        doc = json.load(f)
    assert set(doc["results"]) == set(APPS)
    for app, cells in doc["results"].items():
        assert set(cells) == set(PAPER_ARCHITECTURES), app
        assert doc["rounds"][app] == 1536
    assert PAPER_GEOMETRY.n_cores == 30


@pytest.mark.parametrize("app,arch", [("b+tree", "ata"), ("sradv1", "remote")])
def test_fixture_matches_reference_simulate(app, arch):
    with open(FIXTURE) as f:
        doc = json.load(f)
    assert_result_close(reference_cell(app, arch), doc["results"][app][arch],
                        f"{app}/{arch}")


def test_port_reproduces_fixture_cell_bit_for_bit():
    """The port on the CPU, full 1536 rounds, against the stored cell
    whose per-app latency sum outgrows 2**20 with fractional (1/16)
    latencies — where the float32 accumulation order shows."""
    from repro_torch.core import APPS as PORT_APPS
    from repro_torch.core import make_trace as port_make_trace
    from repro_torch.core import simulate as port_simulate
    with open(FIXTURE) as f:
        want = json.load(f)["results"]["cfd"]["remote"]
    got = result_dict(port_simulate(
        "remote", port_make_trace(PORT_APPS["cfd"], kernel=0), device="cpu"))
    assert want["per_app"][0]["l1_lat_sum"] > 2 ** 20
    assert got == want


if __name__ == "__main__":
    write_fixture()
    print(f"wrote {os.path.normpath(FIXTURE)}")
