"""Serving entry point: ``python -m repro_torch.launch.serve``.

Initialises weights from a seed and serves batched generation through the
slot engine, at the reduced size of the chosen architecture (the
reference's ``.reduce()``), on the CUDA card (``--device cpu`` runs the
kernels' plain PyTorch versions on the host). The dense archs (default
``gemma2_2b``) run K4; ``--arch mamba2_1_3b`` runs the Mamba-2 SSD blocks
through K5, ``--arch recurrentgemma_2b`` its RG-LRU blocks through K6 and
its local attention through K4, e.g.::

    python -m repro_torch.launch.serve --arch mamba2_1_3b --device cpu
    python -m repro_torch.launch.serve --arch recurrentgemma_2b
    python -m repro_torch.launch.serve --arch dbrx_132b --device cpu

``--arch dbrx_132b`` and ``--arch arctic_480b`` run their
mixture-of-experts FFNs on the local path (every expert on this device)
beside K4. ``--arch seamless_m4t_medium`` fails as the reference's does,
with ``KeyError('src_embeds')``: the slot engine's queue carries no source,
and an encoder-decoder is served through ``ServeEngine.generate(prompts,
src_embeds)``. ``--ckpt-dir`` restores the ``params`` leaves of
the latest checkpoint under it (one that ``launch.train`` or the JAX
package's trainer wrote: the format is shared) into the seeded model, as
the reference does, and serves those weights::

    python -m repro_torch.launch.train --arch gemma2_2b --ckpt-dir /tmp/c
    python -m repro_torch.launch.serve --ckpt-dir /tmp/c
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
from ..train import checkpoint as ckpt


def main(argv=None) -> list:
    """Serve; returns the served tokens, one array a request."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma2_2b", choices=ARCH_IDS)
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params from a checkpoint directory")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduce()
    bundle = build_model(cfg, dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    if args.ckpt_dir:
        restored, _ = ckpt.load_checkpoint(args.ckpt_dir, {"params": params})
        params = restored["params"]
        print(f"[launch.serve] restored from {args.ckpt_dir}")

    engine = ServeEngine(bundle, params, ServeConfig(
        max_new_tokens=args.new_tokens, temperature=args.temperature))
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, cfg.vocab_size, (args.prompt_len,)).astype(np.int32)
            for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = engine.serve_queue(reqs, slots=args.slots)
    dt = time.perf_counter() - t0
    print(f"[launch.serve] {args.requests} reqs x {args.new_tokens} new tokens "
          f"in {dt:.2f}s ({sum(map(len, outs))/dt:.1f} tok/s) on {dev}")
    return outs


if __name__ == "__main__":
    main()
