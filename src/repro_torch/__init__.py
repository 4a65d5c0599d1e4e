"""PyTorch/CUDA port of the ATA-Cache reproduction.

``repro_torch`` mirrors the JAX reference package ``repro`` module for
module (``core/``, ``core/arch/``, ``core/noc/``, ``core/trace/``,
``kernels/``) and never imports it; the parity tests hold the two
against each other. Its entry points run on the CUDA card unless the
caller passes ``device="cpu"``.
"""
