"""Native (C++) host-side components: the prefetching stereo image loader
with PGM/PNG decode and rectification remap (`native.loader`)."""
