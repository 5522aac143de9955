"""Port of unidisc_tpu.serving."""
