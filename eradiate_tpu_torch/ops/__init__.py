"""Device code of the port: scene tensors, RNG, medium, phase, BSDF, tracer."""
