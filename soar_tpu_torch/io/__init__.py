"""Port of ``soar_tpu.io``."""
