"""The benchmark's plain reference: frozen copies of the port's plain
PyTorch modules at commit 4c4571f (each file names its source), with the
kernels' dispatch taken out.  Nothing here imports the program, ``jax`` or
the JAX package."""
