"""Batched serving example: prefill + decode with continuous batching.
The port of ``examples/serve_lm.py``: the reduced arch served from seeded
weights through the slot engine's ``serve_queue``, on the CUDA card (K4 for
the attention; K5, K6 for the state archs) unless ``--device cpu`` asks for
the kernels' plain PyTorch versions on the host.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch gemma2_2b
      PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..compat import resolve_device
from ..configs import ARCH_IDS, get_config
from ..models import build_model
from ..serve import ServeConfig, ServeEngine


def main(argv=None) -> list:
    """Serve; returns the served tokens, one array a request."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2_2b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduce()
    bundle = build_model(cfg, dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(bundle, params, ServeConfig(
        max_new_tokens=args.new_tokens, temperature=args.temperature))

    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, cfg.vocab_size, (args.prompt_len,)).astype(np.int32)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = engine.serve_queue(reqs, slots=args.slots)
    dt = time.perf_counter() - t0
    total_new = sum(len(o) for o in outs)
    for i, o in enumerate(outs[:3]):
        print(f"req{i}: prompt={reqs[i][:6]}... -> {o}")
    print(f"{args.requests} requests x {args.new_tokens} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s on {dev}, {args.slots} slots)")
    return outs


if __name__ == "__main__":
    main()
