"""The benchmark of the PyTorch/CUDA port (``tpukube_torch``); see README.md."""
