"""The trace reductions and the per-layer readers on a made-up trace of
known numbers: one pass of two rounds between an upload and a
read-back."""
import pytest

from simbench import devtrace, harness

MS = 1_000_000
DEVICE = [
    ("Memcpy HtoD (Pageable -> Device)", 10 * MS, 12 * MS),
    ("fill_kernel", 13 * MS, 14 * MS),
    ("ata_probe_rank_kernel<true>", 20 * MS, 24 * MS),
    ("gather", 23 * MS, 30 * MS),          # overlaps the one before
    ("ata_probe_rank_kernel<true>", 32 * MS, 36 * MS),
    ("gather", 36 * MS, 40 * MS),
    ("Memcpy DtoH (Device -> Pageable)", 41 * MS, 42 * MS),
]
HOST = [("aten::where", 30 * MS, 33 * MS), ("aten::add", 50 * MS, 60 * MS)]


def capture(device=DEVICE):
    return devtrace.Capture(device, HOST, (0, 100 * MS),
                            {"rounds": 2, "points": 1})


def test_busy_merges_overlaps_and_clips():
    assert devtrace.busy(DEVICE, 21 * MS, 38 * MS) == [
        (21 * MS, 30 * MS), (32 * MS, 38 * MS)]


def test_rounds_span_lies_between_the_last_upload_and_first_read_back():
    assert devtrace.rounds_span(capture()) == (13 * MS, 40 * MS)
    no_upload = [s for s in DEVICE if "HtoD" not in s[0]]
    assert devtrace.rounds_span(capture(no_upload)) is None


@pytest.mark.parametrize("name,value", [
    ("sweep_edges_ms", 13 + 60),
    ("launches_per_round", 5 / 2),
    ("device_ms_per_round", (1 + 10 + 8) / 2),
    ("device_idle_pct", 100 * (1 - 22 / 100)),
])
def test_readers(name, value):
    assert harness.reader(name).read(capture()) == pytest.approx(value)


def test_roofline_reads_nothing_without_the_kernel():
    no_kernel = [s for s in DEVICE if "probe" not in s[0]]
    assert harness.reader("ata_probe_rank_roofline").read(
        capture(no_kernel)) is None


def test_breakdown_names_the_edges_and_the_host_ops():
    b = devtrace.breakdown(capture())
    ops = dict(b["device_ops"])
    assert ops["gather"] == pytest.approx(0.011)
    gaps = dict(b["idle_gaps"])
    assert gaps["host before the rounds (stacking, upload, set-up)"] == \
        pytest.approx(0.011)
    assert gaps["aten::where"] == pytest.approx(0.002)
    assert gaps["Python between torch ops"] == pytest.approx(0.006)
    assert gaps["host after the rounds (read-back, fold, summaries)"] == \
        pytest.approx(0.059)
