"""The plain reference: an LZ4 frame and block decoder in Python and NumPy.
It imports nothing of the port, of ``jax`` or of the JAX package."""
