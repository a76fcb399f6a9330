"""The plain reference the correctness check holds the program to: float32
PyTorch and NumPy, importing nothing of the program or of JAX."""
