"""Port of ``soar_tpu.avatar``."""
