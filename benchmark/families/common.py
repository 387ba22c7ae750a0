"""Weights made on the card from the seed, in the program's parameter tree.

A family module lists its leaves as ``(path, shape, init)``: ``init`` is a
standard deviation (a random leaf), ``"ones"`` or ``"zeros"``. ``make_tree``
draws every random leaf from one ``torch.Generator`` on the device in ONE
``normal_`` call over a flat buffer, in the type the weights are served in,
and hands out views of it: no leaf is drawn on its own, nothing is made on
the host. The same seed gives the same weights.

``request_flops`` is the decoder count of a dense MHA/GQA family, which
such a family exports as its own.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple, Union

import torch

from benchmark.counts import model_flops

Leaf = Tuple[Tuple[Union[str, int], ...], Tuple[int, ...], Union[float, str]]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _put(tree: Dict[str, Any], path, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            if key not in node:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
    last = path[-1]
    if isinstance(last, int):
        while len(node) <= last:
            node.append(None)
    node[last] = value


def make_tree(leaves: List[Leaf], seed: int, device, dtype) -> Dict[str, Any]:
    """The parameter tree of ``leaves``, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63 - 1))
    n_rand = sum(_numel(s) for _, s, init in leaves if not isinstance(init, str))
    n_ones = max((_numel(s) for _, s, init in leaves if init == "ones"), default=0)
    n_zeros = max((_numel(s) for _, s, init in leaves if init == "zeros"), default=0)
    flat = torch.empty(n_rand, dtype=dtype, device=device)
    flat.normal_(generator=gen)
    ones = torch.ones(n_ones, dtype=dtype, device=device)
    zeros = torch.zeros(n_zeros, dtype=dtype, device=device)
    tree: Dict[str, Any] = {}
    off = 0
    for path, shape, init in leaves:
        n = _numel(shape)
        if init == "ones":
            leaf = ones[:n].view(shape)
        elif init == "zeros":
            leaf = zeros[:n].view(shape)
        else:
            leaf = flat[off:off + n].view(shape).mul_(float(init))
            off += n
        _put(tree, path, leaf)
    return tree


def count_params(leaves: List[Leaf]) -> int:
    return sum(_numel(s) for _, s, _ in leaves)


def request_flops(c: Dict[str, Any], n_prompt: int, n_fed: int, n_head: int,
                  n_partial: int = 0, partial_layers: int = 0) -> int:
    """One sequence through a dense decoder
    (``counts/model_flops.py::decoder_flops``)."""
    return model_flops.decoder_flops(model_flops.decoder_dims(c), n_prompt, n_fed, n_head,
                                     n_partial, partial_layers)
