"""Port of stvo_pl_tpu.parallel."""
