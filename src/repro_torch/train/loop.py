"""The training loop: pushdown data pipeline -> train step -> checkpoints
(port of ``repro.train.loop``).

Fault tolerance in one loop:
- auto-resume from the latest checkpoint (the step counter fast-forwards
  the deterministic data stream),
- async keep-k checkpoints every ``ckpt_every`` steps,
- a SIGTERM preemption hook that saves,
- the data pipeline's storage hosts push work back when they fall behind
  (Algorithm 1), and the loop draws the next batch before each step.

A step runs ``loss_fn`` and backward once per microbatch of an (accum,
mb, S) batch, adds each microbatch's gradients (in the parameters' dtype)
into fp32 sums as the reference's scan does, divides by ``accum`` and
applies AdamW in place. The parameters take gradients only inside a step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.api import init_params, loss_fn
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.checkpoint import CheckpointManager, PreemptionGuard


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep: int = 3
    log_every: int = 10
    opt: opt_lib.AdamWConfig = dataclasses.field(
        default_factory=opt_lib.AdamWConfig)


def make_host_train_step(cfg: ModelConfig, opt_cfg: opt_lib.AdamWConfig,
                         remat: Union[bool, str] = False):
    """``step(params, opt, batch) -> (params, opt, stats)`` over an
    (accum, mb, S) batch on the parameters' device; ``stats`` holds the
    mean microbatch ``loss``, ``grad_norm`` and ``lr`` as device scalars.
    ``remat`` is ``loss_fn``'s."""

    def step_fn(params, opt, batch):
        dev = params.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        plist = list(params.parameters())
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                for p in plist]
        accum = batch["tokens"].shape[0]
        losses = []
        params.requires_grad_(True)
        try:
            for i in range(accum):
                loss = loss_fn(params, cfg, {k: v[i] for k, v in
                                             batch.items()}, remat=remat)
                grads = torch.autograd.grad(loss, plist, allow_unused=True)
                for s, g in zip(gsum, grads):
                    if g is not None:  # unused: the reference's zeros
                        s += g.float()
                losses.append(loss.detach())
                del loss, grads
        finally:
            params.requires_grad_(False)
        for s in gsum:
            s /= accum
        params, opt, stats = opt_lib.apply(opt_cfg, params, opt, gsum)
        return params, opt, {"loss": torch.stack(losses).mean(), **stats}

    return step_fn


def train(cfg: ModelConfig, data: Iterator[Dict[str, torch.Tensor]],
          tcfg: TrainConfig, generator: Optional[torch.Generator] = None,
          hooks: Optional[Callable[[int, Dict], None]] = None,
          device: Optional[Union[str, torch.device]] = None) -> Dict:
    """Train ``cfg`` from parameters drawn with ``generator`` (seed 0 on
    ``device`` when None) on ``data``'s batches, on ``device`` (the GPU
    unless given ``device="cpu"``)."""
    dev = resolve_device(device)
    params = init_params(cfg, generator, dev)
    opt = opt_lib.init(params)
    start_step = 0

    mgr = CheckpointManager(tcfg.ckpt_dir, tcfg.keep) if tcfg.ckpt_dir else None
    if mgr and mgr.latest_step() is not None:
        (params, opt), start_step = mgr.restore((params, opt))
        for _ in range(start_step):   # fast-forward the deterministic stream
            next(data)

    step_fn = make_host_train_step(cfg, tcfg.opt)
    history = []
    t0 = time.time()
    step = start_step

    def save_now(step):
        if mgr:
            mgr.save_async(step, (params, opt), extra={"cfg": cfg.name})

    # the state at the step it holds (the reference labels it start_step)
    guard_save = lambda: mgr and mgr.save(step, (params, opt))  # noqa: E731
    with PreemptionGuard(guard_save) as guard:
        next_batch = next(data)  # prefetch
        while step < tcfg.steps:
            batch = next_batch
            try:
                next_batch = next(data)  # host ingest ahead of the step
            except StopIteration:
                next_batch = None
            params, opt, metrics = step_fn(params, opt, batch)
            step += 1
            if step % tcfg.log_every == 0 or step == tcfg.steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["wall_s"] = time.time() - t0
                history.append(m)
                if hooks:
                    hooks(step, m)
            if mgr and step % tcfg.ckpt_every == 0:
                save_now(step)
            if guard.fired or next_batch is None:
                break
    if mgr:
        mgr.wait()
        mgr.save(step, (params, opt), extra={"cfg": cfg.name, "final": True})
    return {"params": params, "opt": opt, "history": history,
            "final_step": step}
