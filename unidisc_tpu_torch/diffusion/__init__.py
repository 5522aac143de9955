"""Port of unidisc_tpu.diffusion."""
