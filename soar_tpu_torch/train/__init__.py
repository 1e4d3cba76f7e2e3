"""Port of ``soar_tpu.train``."""
