"""Device resolution, host-side key derivation and sample warps."""
