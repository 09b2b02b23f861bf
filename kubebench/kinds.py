"""Kernel kinds by name: a frozen copy of the classifier in
``tpukube_torch/breakdown.py`` (``KINDS``), kept here so that the
benchmark's shares read the same kernels whatever the program's copy
becomes. First match wins, on the lower-cased name."""

import re

KINDS = [
    ("nccl", r"nccl"),
    ("convolution", r"conv|fprop|dgrad|wgrad|cudnn|implicit"),
    ("matmul", r"gemm|cutlass|cublas|nvjet|xmma|matmul"),
    ("normalization", r"norm|moments|welford"),
    ("softmax", r"softmax"),
    ("copy/cast", r"copy|cast|convert"),
    ("reduction", r"reduce"),
    ("elementwise", r"elementwise|vectorized|foreach"),
]

DENSE = ("matmul", "convolution")

# Not part of the frozen copy: the operations whose kernels are
# attention's batched products (QK^T and PV, forward and backward), told
# apart from the dense products by the operation that launched them
# (lower-cased name contains one of these), since both run as the same
# GEMM kernels. A kernel whose launcher the trace does not name is UNLINKED.
BATCHED_OPS = ("bmm", "einsum")
UNLINKED = "(unlinked)"


def batched(op: str) -> bool:
    low = op.lower()
    return any(b in low for b in BATCHED_OPS)


def kind(name: str) -> str:
    low = name.lower()
    for k, pattern in KINDS:
        if re.search(pattern, low):
            return k
    return "other"
