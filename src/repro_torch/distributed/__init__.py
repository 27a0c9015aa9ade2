"""Training's distributed-optimization pieces that run on one device: the
remat policy context and int8 error-feedback gradient compression.  The
mesh half of the JAX package's ``distributed/`` is not ported (ROADMAP
queue 1 items 10c and 12g)."""
