"""Port parity: the trace layer (``repro_torch.core.trace`` and the
strict ``Trace``) against the reference ``repro.core.trace``."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import trace as ref  # noqa: E402
from repro.core.trace.generators import _require_int32 as ref_require_int32  # noqa: E402
from repro_torch.core import Trace  # noqa: E402
from repro_torch.core import trace as port  # noqa: E402
from repro_torch.core.trace.generators import _require_int32  # noqa: E402


def test_app_table_is_a_faithful_copy():
    assert list(port.APPS) == list(ref.APPS)
    for name, p in ref.APPS.items():
        assert dataclasses.asdict(port.APPS[name]) == dataclasses.asdict(p)
    assert port.HIGH_LOCALITY == ref.HIGH_LOCALITY
    assert port.LOW_LOCALITY == ref.LOW_LOCALITY
    assert sum(p.n_kernels for p in port.APPS.values()) == 53


@pytest.mark.parametrize("app", sorted(ref.APPS))
def test_kernel_params_match_reference(app):
    for k in ref.app_kernels(app):
        assert port.app_kernels(app) == ref.app_kernels(app)
        assert (dataclasses.asdict(port.kernel_params(port.APPS[app], k))
                == dataclasses.asdict(ref.kernel_params(ref.APPS[app], k)))
    with pytest.raises(ValueError, match=">= 0"):
        port.kernel_params(port.APPS[app], -1)


@pytest.mark.parametrize("app", sorted(ref.APPS))
def test_make_trace_array_equal_every_kernel(app):
    p_ref = dataclasses.replace(ref.APPS[app], rounds=64)
    p_port = dataclasses.replace(port.APPS[app], rounds=64)
    for k in range(p_ref.n_kernels):
        want = ref.make_trace(p_ref, kernel=k)
        got = port.make_trace(p_port, kernel=k)
        assert got.addr.dtype == np.int32 and got.is_write.dtype == np.bool_
        np.testing.assert_array_equal(got.addr, want.addr)
        np.testing.assert_array_equal(got.is_write, want.is_write)
        assert got.insn_per_req == want.insn_per_req
        assert got.core_app is None and want.core_app is None


def test_make_trace_other_core_counts_and_seeds():
    for n_cores, seed in ((8, 0), (12, 3)):
        p_ref = dataclasses.replace(ref.APPS["SN"], rounds=32)
        p_port = dataclasses.replace(port.APPS["SN"], rounds=32)
        want = ref.make_trace(p_ref, n_cores=n_cores, kernel=2, seed=seed)
        got = port.make_trace(p_port, n_cores=n_cores, kernel=2, seed=seed)
        np.testing.assert_array_equal(got.addr, want.addr)
        np.testing.assert_array_equal(got.is_write, want.is_write)


def test_require_int32_guard():
    ok = np.array([0, 5, 2 ** 31 - 1], np.int64)
    np.testing.assert_array_equal(_require_int32(ok), ref_require_int32(ok))
    for bad in (np.array([-1, 3]), np.array([0, 2 ** 31])):
        with pytest.raises(ValueError, match="outside int32"):
            _require_int32(bad)


def test_trace_is_strict_at_construction():
    addr = np.zeros((4, 3, 2), np.int32)
    w = np.zeros((4, 3, 2), bool)
    with pytest.raises(ValueError, match="int32"):
        Trace(addr.astype(np.int64), w, 1.0)
    with pytest.raises(ValueError, match="bool"):
        Trace(addr, w.astype(np.int8), 1.0)
    with pytest.raises(ValueError, match="shape"):
        Trace(addr, w[:2], 1.0)
    with pytest.raises(ValueError, match=r"\(rounds, cores, m\)"):
        Trace(addr[0], w[0], 1.0)
    with pytest.raises(ValueError, match="per-core vector"):
        Trace(addr, w, np.ones(4))
    assert Trace(addr, w, np.full(3, 2.5)).insn_per_req == 2.5
    with pytest.raises(ValueError, match="dense"):
        Trace(addr, w, 1.0, core_app=np.array([0, 2, 2]))
    assert Trace(addr, w, 1.0, core_app=np.zeros(3, np.int64)).core_app is None
    t = Trace(addr, w, 1.0, core_app=np.array([0, 1, 1]))
    assert t.n_apps == 2 and t.core_app.dtype == np.int32
    with pytest.raises(ValueError, match="int32"):
        t._replace(addr=addr.astype(np.int64))
