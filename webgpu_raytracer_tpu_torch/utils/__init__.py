"""Host-side utilities: jitter sequence, texture decoding and packing."""
