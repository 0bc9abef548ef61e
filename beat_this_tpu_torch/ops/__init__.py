"""Compute primitives: the fused CUDA kernels with their plain PyTorch
versions, rotary embeddings, log-mel frontend, peak picking."""
