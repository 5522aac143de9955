"""Port of unidisc_tpu.ops."""
