"""Port of stvo_pl_tpu.utils."""
