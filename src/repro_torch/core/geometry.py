"""GPU geometry + timing model constants (paper Table II).

The simulated GPU matches the paper's GPGPU-sim v4.0 configuration:
30 SIMT cores in 3 clusters of 10, 64KB 64-way L1 per core (128B lines,
8 sets, 4 banks, 32-cycle latency), 24x128KB 16-way L2 partitions
(188-cycle latency), crossbar NoC.

The fields split into two kinds, as in the reference package:

* **structure** fields (core/cluster counts, set/way/bank/partition
  counts) fix tensor shapes and routing-index arithmetic; they stay
  Python ints;
* **scalar** fields (latencies, service times, rates) only enter the
  timing arithmetic. :class:`DeviceGeometry` turns them into float32
  tensors on the simulation device, one value per simulation point, so
  every timing expression rounds in float32 exactly as the reference's
  traced ``GeomScalars`` do (Python-float arithmetic would round in
  float64), and points of one structure with different timing share
  one batched pass (``repro_torch.core.sweep``).

:func:`split_geometry` performs the split; :class:`DeviceGeometry`
(the reference's ``TracedGeometry``) recombines one
:class:`GeomStructure` with the stacked scalars of P geometries behind
the same attribute names.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class GpuGeometry:
    # --- organization -----------------------------------------------------
    n_cores: int = 30
    cluster_size: int = 10
    # L1: 64KB / 128B lines = 512 lines, 64-way -> 8 sets, 4 banks
    l1_sets: int = 8
    l1_ways: int = 64
    l1_banks: int = 4
    # L2: 24 partitions x 128KB / 128B = 1024 lines, 16-way -> 64 sets
    l2_parts: int = 24
    l2_sets: int = 64
    l2_ways: int = 16

    # --- uncontended latencies (cycles) ------------------------------------
    lat_l1: int = 32
    lat_xbar: int = 2        # ATA intra-cluster crossbar hop (data transfer)
    lat_home: int = 16       # decoupled-sharing core->home NoC round trip
    lat_l2: int = 188
    lat_dram: int = 320
    lat_probe: int = 24      # remote-sharing probe round-trip (uncontended)

    # --- service / occupancy times (cycles per request at the resource) ----
    svc_bank: int = 8        # decoupled-sharing home-cache bank port
    svc_port: int = 2        # ATA remote-data port
    svc_probe: int = 1       # remote-sharing tag-probe service per probe
    svc_l2: int = 4          # L2 partition port
    flits_per_line: int = 4  # 128B line / 40B flit (rounded up)
    noc_bw: float = 16.0     # flits/cycle the probe network sustains/cluster

    # --- interconnect topology (read by the topology-aware NoC models;
    # the `ideal` NoC ignores them) ------------------------------------------
    noc_drain: float = 32.0  # cycles of NoC forwarding budget per round
    noc_queue: float = 128.0  # per-port injection-queue capacity (flits)
    ring_hop: float = 2.0    # cycles per ring hop between cluster slots

    # --- core pipeline model ------------------------------------------------
    issue_rate: float = 4.0  # peak insn/cycle/core (4 GTO schedulers)
    hide: float = 10.0       # warp-level latency-hiding divisor

    @property
    def n_clusters(self) -> int:
        return self.n_cores // self.cluster_size


#: Default geometry = paper Table II.
PAPER_GEOMETRY = GpuGeometry()

#: Fields that fix tensor shapes / routing arithmetic (Python ints).
GEOM_STRUCTURE_FIELDS = ("n_cores", "cluster_size", "l1_sets", "l1_ways",
                         "l1_banks", "l2_parts", "l2_sets", "l2_ways")

#: Timing fields that only enter arithmetic (float32 tensors).
GEOM_SCALAR_FIELDS = ("lat_l1", "lat_xbar", "lat_home", "lat_l2",
                      "lat_dram", "lat_probe", "svc_bank", "svc_port",
                      "svc_probe", "svc_l2", "flits_per_line", "noc_bw",
                      "noc_drain", "noc_queue", "ring_hop",
                      "issue_rate", "hide")


class GeomStructure(NamedTuple):
    """The shape-determining subset of :class:`GpuGeometry` (hashable;
    sweeps group geometries by it)."""
    n_cores: int
    cluster_size: int
    l1_sets: int
    l1_ways: int
    l1_banks: int
    l2_parts: int
    l2_sets: int
    l2_ways: int

    @property
    def n_clusters(self) -> int:
        return self.n_cores // self.cluster_size


class GeomScalars(NamedTuple):
    """The timing subset of :class:`GpuGeometry` as float32 values."""
    lat_l1: np.float32
    lat_xbar: np.float32
    lat_home: np.float32
    lat_l2: np.float32
    lat_dram: np.float32
    lat_probe: np.float32
    svc_bank: np.float32
    svc_port: np.float32
    svc_probe: np.float32
    svc_l2: np.float32
    flits_per_line: np.float32
    noc_bw: np.float32
    noc_drain: np.float32
    noc_queue: np.float32
    ring_hop: np.float32
    issue_rate: np.float32
    hide: np.float32


def geom_structure(geom: GpuGeometry) -> GeomStructure:
    """The shape-determining key of ``geom``."""
    return GeomStructure(*(getattr(geom, f) for f in GEOM_STRUCTURE_FIELDS))


def split_geometry(geom: GpuGeometry):
    """``geom`` -> (:class:`GeomStructure`, float32 :class:`GeomScalars`)."""
    return geom_structure(geom), GeomScalars(
        *(np.float32(getattr(geom, f)) for f in GEOM_SCALAR_FIELDS))


class DeviceGeometry:
    """A ``GpuGeometry`` view for the simulation stages over P points.

    Structure fields read as Python ints, shared by every point. Timing
    fields read as (P, 1) float32 tensors on ``device``, one value per
    point, so they broadcast against the (P, R) per-request, (P, C)
    per-core and (P, L) per-link operands of a round;
    :meth:`point` gives the (P,) view for per-point counters. ``geoms``
    is one geometry per point, all of one :class:`GeomStructure` (a
    single geometry is one point). Every scalar is a dimensioned tensor
    whatever P, so there is one code path: the float32 values, and the
    float32 result of every expression they enter, are the same as the
    reference's traced scalars give.
    """

    __slots__ = ("structure", "_table", "_rows", "_cols")

    def __init__(self, geoms: Union[GpuGeometry, Sequence[GpuGeometry]],
                 device):
        if isinstance(geoms, GpuGeometry):
            geoms = [geoms]
        structures = {geom_structure(g) for g in geoms}
        if len(structures) != 1:
            raise ValueError("DeviceGeometry needs geometries of one "
                             f"structure, got {sorted(structures)}")
        table = np.array([split_geometry(g)[1] for g in geoms],
                         np.float32).T                     # (F, P)
        self._init(structures.pop(),
                   torch.from_numpy(np.ascontiguousarray(table)).to(device))

    def _init(self, structure: GeomStructure, table: torch.Tensor) -> None:
        self.structure = structure
        self._table = table
        self._rows = {f: table[i] for i, f in enumerate(GEOM_SCALAR_FIELDS)}
        self._cols = {f: row[:, None] for f, row in self._rows.items()}

    @classmethod
    def _of(cls, structure: GeomStructure,
            table: torch.Tensor) -> "DeviceGeometry":
        g = cls.__new__(cls)
        g._init(structure, table)
        return g

    def __getattr__(self, name: str):
        if name in GEOM_STRUCTURE_FIELDS:
            return getattr(self.structure, name)
        if name in GEOM_SCALAR_FIELDS:
            return self._cols[name]
        raise AttributeError(name)

    @property
    def n_clusters(self) -> int:
        return self.structure.n_clusters

    @property
    def nbytes(self) -> int:
        """Bytes of the (fields, P) timing table, copied to the device
        once."""
        return self._table.nbytes

    def point(self, name: str) -> torch.Tensor:
        """Timing field ``name`` as a (P,) tensor, for per-point counters."""
        return self._rows[name]

    def take(self, points: slice) -> "DeviceGeometry":
        """The view of a contiguous run of points (no copy)."""
        return DeviceGeometry._of(self.structure, self._table[:, points])
