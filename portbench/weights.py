"""Weights drawn from the run's seed, the same for the program and the
reference.

Each parameter is drawn by itself, on the device, in the dtype it is
served or trained in, from a ``torch.Generator`` seeded by the run's seed
and the parameter's name: a normal of standard deviation ``gain /
sqrt(fan_in)`` (``fan_in`` the product of the dims the parameter's matrix
product contracts, as the configuration's ``draw`` names them by the
parameter's last name part), or zeros for the norms' gains. So any
parameter can be drawn again alone, bit for bit: the program gets them
written into its own parameters at set-up, and the reference draws each
layer's anew once the program's state is freed.

The fan-in is the true one, so that attention at full width and depth is
not one-hot (scores of standard deviation about ``gain^2``) and a served
token's logit can be compared with the reference's at full depth.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable

import torch


def leaf_seed(seed: int, name: str) -> int:
    """A 60-bit generator seed from the run's seed and a parameter name."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).hexdigest()
    return int(digest[:15], 16)


def leaf_std(name: str, shape: tuple[int, ...], draw: dict) -> float:
    """The standard deviation of parameter ``name``, 0 for a zero leaf."""
    kind = name.rsplit(".", 1)[-1]
    if kind in draw["zeros"]:
        return 0.0
    if kind not in draw["fan_in_dims"]:
        raise KeyError(f"draw: no fan-in stated for {name!r}")
    fan_in = math.prod(shape[d] for d in draw["fan_in_dims"][kind])
    gain = draw.get("gain", {}).get(kind, draw.get("gain", {}).get(
        "default", 1.0))
    return gain / math.sqrt(fan_in)


def fill(t: torch.Tensor, name: str, seed: int, draw: dict) -> torch.Tensor:
    """Write parameter ``name``'s values into ``t`` (in place, in its dtype
    and on its device) and return it."""
    std = leaf_std(name, tuple(t.shape), draw)
    with torch.no_grad():
        if std == 0.0:
            return t.zero_()
        gen = torch.Generator(device=t.device).manual_seed(
            leaf_seed(seed, name))
        return t.normal_(0.0, std, generator=gen)


def drawn(name: str, shape: tuple[int, ...], seed: int, draw: dict,
          dtype: torch.dtype, device) -> torch.Tensor:
    """Parameter ``name`` drawn anew, as :func:`fill` writes it."""
    return fill(torch.empty(shape, dtype=dtype, device=device), name, seed,
                draw)


def draw_into(module: torch.nn.Module, seed: int, draw: dict,
              expected: dict[str, tuple[int, ...]]) -> int:
    """Fill every parameter of ``module``; raise unless its names and
    shapes are ``expected`` (the configuration's layout). Returns the
    number of elements drawn."""
    got = {n: tuple(p.shape) for n, p in module.named_parameters()}
    if got != {n: tuple(s) for n, s in expected.items()}:
        missing = sorted(set(expected) - set(got))
        extra = sorted(set(got) - set(expected))
        wrong = sorted(n for n in set(got) & set(expected)
                       if got[n] != tuple(expected[n]))
        raise ValueError(f"the program's parameters differ from the "
                         f"configuration's layout: missing {missing[:4]}, "
                         f"extra {extra[:4]}, shapes {wrong[:4]}")
    n = 0
    for name, p in module.named_parameters():
        fill(p.data, name, seed, draw)
        n += p.numel()
    return n


def source(seed: int, draw: dict, shapes: dict[str, tuple[int, ...]],
           dtype: torch.dtype, device) -> Callable[[str], torch.Tensor]:
    """``name -> tensor``: each parameter drawn anew when asked for."""
    return lambda name: drawn(name, shapes[name], seed, draw, dtype, device)
