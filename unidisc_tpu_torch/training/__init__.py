"""Port of unidisc_tpu.training."""
