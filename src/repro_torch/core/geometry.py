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
  zero-dim tensors on the simulation device, so every timing expression
  rounds in float32 exactly as the reference's traced ``GeomScalars``
  do (Python-float arithmetic would round in float64).
"""
from __future__ import annotations

import dataclasses

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


class DeviceGeometry:
    """A ``GpuGeometry`` view for the simulation stages.

    Structure fields read as Python ints; timing fields as float32
    zero-dim tensors on ``device`` (the reference's ``TracedGeometry``
    over ``split_geometry``'s float32 scalars).
    """

    __slots__ = ("geom", "_scalars")

    def __init__(self, geom: GpuGeometry, device):
        self.geom = geom
        self._scalars = {
            f: torch.tensor(float(getattr(geom, f)), dtype=torch.float32,
                            device=device)
            for f in GEOM_SCALAR_FIELDS}

    def __getattr__(self, name: str):
        if name in GEOM_STRUCTURE_FIELDS:
            return getattr(self.geom, name)
        if name in GEOM_SCALAR_FIELDS:
            return self._scalars[name]
        raise AttributeError(name)

    @property
    def n_clusters(self) -> int:
        return self.geom.n_clusters

