"""The LC compression framework ported to PyTorch and CUDA (NVIDIA H100).

A second package beside the JAX reference ``src/repro``; it mirrors that
package module for module and imports none of it.
"""
