"""Port of unidisc_tpu.data."""
