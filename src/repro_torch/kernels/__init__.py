"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  ata_probe_rank  fused ATA probe + winner pick + remote-port
                  arbitration (CUDA C++, ``csrc/ata_probe_rank.cu``)
  ata_tag_probe   aggregated-tag-array probe: hit and first way per
                  (request, cache) (CUDA C++, ``csrc/ata_tag_probe.cu``)
"""
