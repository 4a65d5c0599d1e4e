"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  ata_probe_rank  fused ATA probe + winner pick + remote-port
                  arbitration (CUDA C++, ``csrc/ata_probe_rank.cu``)
"""
