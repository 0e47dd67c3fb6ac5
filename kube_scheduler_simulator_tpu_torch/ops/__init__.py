"""Host encoder, lowering, plain PyTorch versions and CUDA kernels."""
