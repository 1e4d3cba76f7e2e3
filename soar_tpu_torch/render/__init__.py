"""Port of ``soar_tpu.render``."""
