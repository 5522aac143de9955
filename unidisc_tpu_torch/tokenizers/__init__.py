"""Port of unidisc_tpu.tokenizers."""
