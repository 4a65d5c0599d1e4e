"""Port parity: whole simulations of the contention-policy zoo.

Each zoo policy's ``SimResult`` against the reference ``simulate()`` on
cfd and HS3D (integral counters exact, every other float within
``rtol=1e-6``, the bar of ``tests/test_arch_registry.py::GOLDEN``), and
the behaviour the reference's own tests
(``tests/test_arch_registry.py``, ``tests/test_zoo.py``) ask of each
policy, on the port's results.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

from repro.core import APPS as REF_APPS  # noqa: E402
from repro.core import make_trace as ref_make_trace  # noqa: E402
from repro.core import simulate as ref_simulate  # noqa: E402
from repro_torch.core import APPS, make_trace, simulate  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ZOO = ("ata_bypass", "ata_fifo", "ciao", "victim")


#: long enough that the L1 sets are full and dead victims exist: every
#: zoo mechanism fires (the reference's own behaviour tests use 768)
ROUNDS = 768


@functools.lru_cache(maxsize=None)
def _port(arch: str, app: str):
    tr = make_trace(dataclasses.replace(APPS[app], rounds=ROUNDS), kernel=0)
    return simulate(arch, tr, device="cpu")


@functools.lru_cache(maxsize=None)
def _ref(arch: str, app: str):
    return ref_simulate(arch, ref_make_trace(
        dataclasses.replace(REF_APPS[app], rounds=ROUNDS), kernel=0))


#: counters held exactly
EXACT = {"l2_accesses", "dram_accesses", "noc_flits", "local_hits",
         "remote_hits", "requests", "l1_lat_n", "flits_injected",
         "flits_delivered", "app", "cores"}


def _close(got, want, where):
    for k, w in want._asdict().items():
        g = getattr(got, k)
        if k == "per_app":
            assert len(g) == len(w), where
            for gi, wi in zip(g, w):
                _close(gi, wi, f"{where}.per_app")
        elif k == "noc":
            _close(g, w, f"{where}.noc")
        elif k in EXACT:
            assert g == w, (f"{where}.{k}", g, w)
        elif isinstance(w, float) and math.isnan(w):
            assert math.isnan(g), f"{where}.{k}"
        else:
            assert math.isclose(g, w, rel_tol=1e-6, abs_tol=0.0), \
                (f"{where}.{k}", g, w)


@pytest.mark.parametrize("app", ["cfd", "HS3D"])
@pytest.mark.parametrize("arch", ZOO)
def test_sim_result_matches_reference(arch, app):
    _close(_port(arch, app), _ref(arch, app), f"{app}/{arch}")


# ---------------------------------------------------------------------------
# behaviour
# ---------------------------------------------------------------------------
def test_ata_bypass_cuts_noc_traffic_on_streaming_app():
    base = _port("ata", "HS3D")
    byp = _port("ata_bypass", "HS3D")
    assert tuple(byp) != tuple(base)
    assert byp.noc_flits < 0.95 * base.noc_flits
    assert byp.ipc > 0.95 * base.ipc
    assert byp.l1_hit_rate > base.l1_hit_rate - 0.03


def test_fifo_replacement_diverges_and_stays_valid():
    lru = _port("ata", "cfd")
    fifo = _port("ata_fifo", "cfd")
    assert tuple(fifo) != tuple(lru)
    assert 0.0 < fifo.l1_hit_rate < 1.0
    assert lru.l1_hit_rate >= fifo.l1_hit_rate - 0.05


def test_ciao_throttles_thrashing_lanes():
    base = _port("private", "HS3D")
    ciao = _port("ciao", "HS3D")
    assert tuple(ciao) != tuple(base)
    assert ciao.l1_hit_rate > base.l1_hit_rate
    assert ciao.noc_flits < 0.95 * base.noc_flits
    assert ciao.ipc > 0.97 * base.ipc


def test_victim_buffer_recovers_evicted_lines():
    base = _port("ata", "HS3D")
    vic = _port("victim", "HS3D")
    assert tuple(vic) != tuple(base)
    assert vic.l1_hit_rate >= base.l1_hit_rate
    assert vic.ipc >= 0.98 * base.ipc
    assert vic.l2_accesses <= base.l2_accesses
