"""Codebook-dequant GEMMs for compressed serving: the CUDA kernels K5
(uint8 indices) and K4 (4-bit packed), their plain versions and the
packing helpers."""
