"""Reading a device trace: each dense kernel is charged to the operation
that launched it, also where the trace links it to an event inside that
operation rather than to the operation."""

from kubebench.kinds import UNLINKED, batched
from kubebench.pod import _Launchers


def test_a_kernel_is_charged_to_its_launching_operation():
    # correlation id -> (host event, start, end, thread)
    ops = {1: ("aten::einsum", 0, 100, 7), 2: ("aten::bmm", 10, 50, 7),
           3: ("Command Buffer Full", 20, 21, 7), 4: ("aten::mm", 200, 300, 7),
           5: ("Command Buffer Full", 250, 251, 7), 6: ("Command Buffer Full", 400, 401, 7),
           7: ("aten::mm", 0, 500, 9)}
    launcher = _Launchers(ops)
    got = [launcher(c) for c in (1, 2, 3, 4, 5, 6, 99)]
    assert got == ["aten::einsum", "aten::bmm", "aten::bmm", "aten::mm", "aten::mm",
                   UNLINKED, UNLINKED]


def test_attention_products_are_told_by_their_operation():
    assert all(map(batched, ["aten::bmm", "aten::baddbmm", "aten::einsum"]))
    assert not any(map(batched, ["aten::mm", "aten::addmm", "aten::linear", UNLINKED,
                                 "aten::cudnn_convolution", "aten::convolution_backward"]))
