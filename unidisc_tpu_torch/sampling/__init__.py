"""Port of unidisc_tpu.sampling."""
