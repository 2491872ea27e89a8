"""Plain PyTorch references of architectures the JAX package does not build."""
