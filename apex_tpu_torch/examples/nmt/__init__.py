"""The NMT Transformer example (BASELINE config #3)."""
