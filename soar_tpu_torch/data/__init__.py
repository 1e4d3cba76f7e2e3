"""Port of ``soar_tpu.data``."""
