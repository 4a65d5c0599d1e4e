"""ATA-style serving: numpy oracle (``ref``) + PyTorch engine (``engine``).

``ref`` keeps the one-request-at-a-time API and the round-based
``run_stream`` (the oracle the engine is held against bit-exactly);
``engine`` replays :class:`~repro_torch.core.trace.serving.RequestStream`
grids on the card (``device="cpu"`` on request), with the
``ata_tag_probe`` kernel as its directory probe.
"""
from repro_torch.serving.ref import (AtaCacheConfig, AtaPrefixCache,
                                     POLICIES, Stats, hash_blocks,
                                     run_stream, run_workload,
                                     synth_requests)
from repro_torch.serving.engine import (SERVING_POLICIES,
                                        SERVING_PROBE_BACKENDS, ServeResult,
                                        ServingConfig, serve_stream)

__all__ = [
    "AtaCacheConfig", "AtaPrefixCache", "POLICIES", "Stats",
    "hash_blocks", "run_stream", "run_workload", "synth_requests",
    "SERVING_POLICIES", "SERVING_PROBE_BACKENDS", "ServeResult",
    "ServingConfig", "serve_stream",
]
