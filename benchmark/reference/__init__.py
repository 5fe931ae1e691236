"""The plain reference that decides `correct`: plain PyTorch and NumPy,
which import nothing of the program and nothing of JAX."""
