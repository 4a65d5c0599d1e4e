"""Mesh construction: the reference's production meshes as shapes, and
the small test mesh.

The port of the reference's ``launch/mesh.py``. Both build a
``DeviceMesh`` over the process group this rank has joined
(:func:`repro_torch.sharding.compat.init_distributed`), one rank per
device.
"""
from __future__ import annotations

from repro_torch.sharding.compat import make_mesh

#: the reference's TPU v5e production meshes: one 256-chip pod (16 x 16)
#: or two pods over DCN (2 x 16 x 16)
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 (one pod) or 2x16x16 (two pods): raises unless the process
    group has that many ranks (256 or 512)."""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    return make_mesh(shape, axes, device_type=device_type)


def make_test_mesh(n_data: int = 2, n_model: int = 2, *, device_type=None):
    """A small (n_data, n_model) mesh named ("data", "model"); the process
    group must have n_data x n_model ranks."""
    return make_mesh((n_data, n_model), ("data", "model"),
                     device_type=device_type)
