"""Port of ``soar_tpu.body``."""
