"""Causal (+ sliding-window) flash attention, GQA-native: the CUDA kernel
K6, its plain version and the model-layout wrapper."""
