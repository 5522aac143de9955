"""Port of unidisc_tpu.parallel."""
