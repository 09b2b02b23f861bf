"""A forward replayed from CUDA graphs, one graph per input shape.

    served = ByShape(lambda tokens: forward(params, tokens, cfg), examples)
    out = served(tokens)     # a replay where a graph has tokens' shape

A model whose forward launches thousands of small kernels keeps the card
waiting on the host's launches (Moonlight: ~150 kernels a layer, 27
layers). A server that sees a fixed set of input shapes captures
the forward once per shape and replays it: one launch a request, and the
card's own speed sets the pace, not the host's.

:class:`ByShape` captures ``fn`` over a copy of each example, the largest
first, into one memory pool that the graphs share: each graph's scratch
is free again when its capture ends, so the pool holds what the largest
forward needs, plus every graph's outputs. A call copies its input into
the graph's input buffer, replays the graph and returns the graph's own
outputs, which the next call of the same shape overwrites: a caller that
keeps them clones them. A shape with no graph, and every call off CUDA,
runs ``fn`` as it is.

``fn`` must wait for nothing on the host (no ``.item()``, no output sized
by data) and build no tensor on the host that it copies in: a replay runs
what the capture launched, with the capture's addresses. Set-up runs
``fn`` once on the capturing stream before the first capture, so lazy
initialisation (library handles, workspaces) happens outside any graph.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import torch


class ByShape:
    """``fn`` over one tensor, captured once per example's shape."""

    def __init__(self, fn: Callable[[torch.Tensor], Any], examples: Iterable[torch.Tensor]):
        self._fn = fn
        self._graphs: dict = {}
        examples = sorted(examples, key=lambda x: x.numel(), reverse=True)
        if not examples or examples[0].device.type != "cuda":
            return
        device = examples[0].device
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            fn(examples[0])
        torch.cuda.current_stream(device).wait_stream(stream)
        pool = torch.cuda.graph_pool_handle()
        for x in examples:
            static = x.clone()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                out = fn(static)
            self._graphs[tuple(x.shape)] = (graph, static, out)

    @property
    def shapes(self) -> list:
        """The shapes that replay a graph."""
        return list(self._graphs)

    def __call__(self, x: torch.Tensor) -> Any:
        entry = self._graphs.get(tuple(x.shape))
        if entry is None:
            return self._fn(x)
        graph, static, out = entry
        static.copy_(x)
        graph.replay()
        return out
