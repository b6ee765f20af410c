"""C-step solvers behind the dispatch registry, with the CUDA kernels
they launch (sources under ``csrc/``)."""
