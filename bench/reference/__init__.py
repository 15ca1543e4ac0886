"""The plain reference and the comparisons that decide ``correct``. Imports
nothing of the program, of ``jax`` or of the JAX package."""
