"""Plain PyTorch references, computed in float32 with TF32 off. They import
nothing of the program, of JAX or of the JAX package, and take only the
weights and audio that the benchmark made."""
