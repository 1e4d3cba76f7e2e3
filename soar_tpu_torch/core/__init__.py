"""Port of ``soar_tpu.core``."""
