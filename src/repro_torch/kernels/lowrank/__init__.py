"""Low-rank serving op (the C-step solvers come with the low-rank
slice)."""
