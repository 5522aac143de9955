"""Port of unidisc_tpu.utils."""
