"""The decoder models the compression configs target (port of
``src/repro/models``; GQA attention with dense FFNs so far)."""
