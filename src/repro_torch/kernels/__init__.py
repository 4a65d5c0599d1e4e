"""Hand-written Hopper kernels, each beside its plain PyTorch version.

  ata_probe_rank   fused ATA probe + winner pick + remote-port
                   arbitration (CUDA C++, ``csrc/ata_probe_rank.cu``:
                   one thread-block cluster per simulation point)
  ata_tag_probe    aggregated-tag-array probe: hit and first way per
                   (request, cache) (CUDA C++, ``csrc/ata_tag_probe.cu``;
                   reads a strided tag array in place)
  flash_attention  blocked online-softmax attention with GQA, causal
                   mask, window and kv_len (CUDA C++,
                   ``csrc/flash_attention.cu``)
  wkv6             RWKV6 recurrence with data-dependent decay (CUDA C++,
                   ``csrc/wkv6.cu``)

``ops`` dispatches the LM substrate's calls between the kernels and
their plain versions.
"""
