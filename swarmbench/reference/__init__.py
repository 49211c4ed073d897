"""The plain reference the benchmark holds the port to: PyTorch only, float32
with TF32 off, importing nothing of the program."""
