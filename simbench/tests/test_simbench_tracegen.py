"""The frozen yardsticks against the program's copies at this commit:
the traffic generator's traces and the probe kernel's byte model."""
import dataclasses

import numpy as np
import pytest

from simbench import roofline, tracegen

gen = pytest.importorskip("repro_torch.core.trace.generators")
apps = pytest.importorskip("repro_torch.core.trace.apps")
port_roofline = pytest.importorskip("repro_torch.launch.roofline")


@pytest.mark.parametrize("seed", [0, 3_000_000_017 * 4096 + 5])
def test_frozen_traces_equal_the_ports(seed):
    assert list(tracegen.APPS) == list(apps.APPS)
    for name, app in tracegen.APPS.items():
        assert dataclasses.asdict(app) == dataclasses.asdict(apps.APPS[name])
        for k in range(app.n_kernels):
            a = tracegen.make_trace(dataclasses.replace(app, rounds=48),
                                    kernel=k, seed=seed)
            b = gen.make_trace(dataclasses.replace(apps.APPS[name],
                                                   rounds=48),
                               kernel=k, seed=seed)
            np.testing.assert_array_equal(a.addr, b.addr)
            np.testing.assert_array_equal(a.is_write, b.is_write)
            assert a.insn_per_req == b.insn_per_req
            assert dataclasses.asdict(tracegen.kernel_params(app, k)) == \
                dataclasses.asdict(gen.kernel_params(apps.APPS[name], k))


def test_frozen_byte_model_equals_the_ports():
    rng = np.random.default_rng(7)
    P, R, C, S, W, G = 5, 120, 30, 8, 64, 10
    set_idx = rng.integers(0, S, (P, R))
    cbase = rng.integers(0, C // G, (P, R)) * G
    assert roofline.probe_rank_traffic(set_idx, cbase, (P, C, S, W), G) == \
        port_roofline.probe_rank_traffic(set_idx, cbase, (P, C, S, W), G)
    for nbytes, ops in [(1e9, 1e6), (1e3, 1e12)]:
        assert roofline.bound(nbytes, ops, roofline.INT32_OPS_PER_S) == \
            port_roofline.bound(nbytes, ops, port_roofline.INT32_OPS_PER_S)
    assert roofline.HBM_BYTES_PER_S == port_roofline.HBM_BYTES_PER_S
