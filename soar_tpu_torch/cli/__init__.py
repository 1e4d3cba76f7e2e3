"""Port of ``soar_tpu.cli``."""
