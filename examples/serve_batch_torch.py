"""Batched serving with the PyTorch port: prefill + decode over request waves.

    PYTHONPATH=src python examples/serve_batch_torch.py [--arch olmo-1b]
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu

Builds a reduced-config model of one of the architectures the engine
serves (the generic decoder's dense, MoE and VLM families, mamba2's SSM
and recurrentgemma's hybrid; random weights, since the point is the
serving machinery: left-padded batched prefill, chunked prefill when a
wave is large, the KV-cache layouts of linear and chunked-local layers,
an SSM's state, a sliding-window ring) and serves a queue of requests with
``repro_torch.serve.engine``. It runs on the GPU unless given ``--device
cpu``. Whisper is not offered: the engine has no audio frames to feed it,
as the JAX package's engine has none.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import api
from repro_torch.serve.engine import ServeConfig, ServingEngine


def main():
    served = [a for a in ARCH_IDS
              if get_config(a, reduced=True).family != "audio"]
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=served)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch, reduced=True)
    params = api.init_params(cfg, device=args.device)
    print(f"arch={args.arch} (reduced: {cfg.num_layers}L d={cfg.d_model}, "
          f"family={cfg.family}) on {params.device}")
    scfg = ServeConfig(max_batch=4, max_len=96, prefill_chunk=16)
    eng = ServingEngine(cfg, params, scfg)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, int(rng.integers(4, 24)))
               .astype(np.int32) for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new=args.max_new)
    if params.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for i, (p, o) in enumerate(zip(prompts, outs)):
        print(f"  req{i}: prompt[{len(p)}] -> {o}")
    tok = sum(len(o) for o in outs)
    print(f"{tok} tokens in {dt:.2f} s ({tok / dt:.1f} tok/s on "
          f"{params.device}, waves of {scfg.max_batch}, "
          f"{eng.chunked_prefills} chunked prefills)")


if __name__ == "__main__":
    main()
