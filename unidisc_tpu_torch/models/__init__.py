"""Port of unidisc_tpu.models."""
