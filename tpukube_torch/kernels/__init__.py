"""The port's hand-written kernels, each beside its plain PyTorch version.
Importing a module here imports no kernel compiler: each builds its
kernels at its first launch."""
