"""Port of ``render_engine_tpu.utils``."""
