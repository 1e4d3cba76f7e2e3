"""Port of ``soar_tpu.field``."""
