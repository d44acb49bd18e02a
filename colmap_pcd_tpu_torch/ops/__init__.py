"""Device-side compute ops (PyTorch, plus the hand-written CUDA 1-NN kernel)."""
