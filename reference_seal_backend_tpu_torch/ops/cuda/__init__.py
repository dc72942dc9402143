"""Part of the PyTorch/CUDA port; mirrors the layout of the JAX package."""
