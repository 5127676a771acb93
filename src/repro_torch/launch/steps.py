"""Step builders: one function per (arch x shape) cell (port of
``repro.launch.steps``).

- train_4k    -> ``train_step(params, opt, batch)``  (grad accumulation + AdamW)
- prefill_32k -> ``prefill_step(params, batch)``     (forward + KV collection)
- decode_*    -> ``serve_step(params, cache, pos, token)`` (one token)

Each builder also produces the *abstract* arguments (meta DTensors with
the rules' placements) so that the dry run can run the step without
allocating anything (``StepBundle.trace``). ``place`` puts real arguments
on a bundle's placements; the step then runs on DTensors inside an
``activation_sharding`` context, where the models' anchors redistribute
activations and a plain tensor made inside the models counts as
replicated (DTensor's ``implicit_replication``).

Batch layout: train batches arrive microbatched as ``(accum, mb, S)`` with
``mb`` sharded over the DP axes — every microbatch spans the full mesh.
The pushdown data pipeline (``repro_torch.data.pipeline``) delivers exactly
this layout; that is the shuffle-pushdown integration point (partitions
are routed to their DP rank at the storage layer).

Decode's ``pos`` is a Python int, as the port's ``decode_step`` takes it
(the reference traces it as a scalar): the abstract argument is the
middle of the cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.constraints import activation_sharding
from repro_torch.models import api, flags
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.loop import grad_sums

# per-(arch, shape) grad-accumulation overrides (memory control)
ACCUM_OVERRIDES: Dict[Tuple[str, str], int] = {
    ("deepseek-67b", "train_4k"): 16,
    ("llama4-scout-17b-a16e", "train_4k"): 16,
    ("qwen3-14b", "train_4k"): 8,
}

# ---------------------------------------------------------------- variants
# "baseline": the paper-faithful eager distribution.
# "opt": lower grad-accum, selective remat (keep the matmul outputs),
#        expert-parallel MoE (the in-mesh shuffle-pushdown dispatch),
#        flat attention, expert-dim padding to the TP axis.
VARIANTS: Dict[str, Dict] = {
    "baseline": {},
    "opt": {
        "accum": {("deepseek-67b", "train_4k"): 2,
                  ("llama4-scout-17b-a16e", "train_4k"): 4,
                  ("qwen2-moe-a2.7b", "train_4k"): 4,
                  ("qwen3-14b", "train_4k"): 4,
                  ("qwen1.5-4b", "train_4k"): 4},
        "remat": "dots",
        "moe": "ep",
        "attn": "flat",
        # SP pays off only when the head count doesn't divide the TP axis
        "sp_archs": ("llama4-scout-17b-a16e",),
        "expert_pad": {"qwen2-moe-a2.7b": 4},
    },
}


def apply_variant(cfg: ModelConfig, variant: str) -> ModelConfig:
    pad = VARIANTS.get(variant, {}).get("expert_pad", {}).get(cfg.name, 0)
    return dataclasses.replace(cfg, expert_pad=pad) if pad else cfg


def accum_for(cfg: ModelConfig, shape: ShapeSpec,
              variant: str = "baseline") -> int:
    v = VARIANTS.get(variant, {}).get("accum", {})
    if (cfg.name, shape.name) in v:
        return v[(cfg.name, shape.name)]
    return ACCUM_OVERRIDES.get((cfg.name, shape.name), shape.accum)


@dataclasses.dataclass
class StepBundle:
    """Everything the dry run or a launcher needs for one cell.
    ``out_shardings`` holds PartitionSpec tuples (``sharding.spec_to_pspec``'s
    form) on the bundle's mesh; ``fn`` returns its outputs in them."""
    fn: Callable
    abstract_args: Tuple[Any, ...]
    donate_argnums: Tuple[int, ...]
    out_shardings: Any
    meta: Dict[str, Any]

    def trace(self):
        """Run ``fn`` on the abstract arguments (meta DTensors: nothing is
        allocated or communicated) under an ``analysis.Recorder``. Returns
        (outputs, recorder)."""
        from repro_torch.launch.analysis import Recorder
        rec = Recorder()
        with rec:
            out = self.fn(*self.abstract_args)
        return out, rec


# ---------------------------------------------------------------- helpers
def _meta(shape, dtype, mesh, *spec) -> DTensor:
    return shd.meta_dtensor(shape, dtype, mesh, _trim(spec))


def _trim(spec) -> tuple:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _batch_abstract(cfg: ModelConfig, shape: ShapeSpec, mesh, rules,
                    microbatched: bool, variant: str = "baseline"
                    ) -> Dict[str, DTensor]:
    """Abstract input batch with DP sharding (+ optional accum leading dim)."""
    specs = api.input_specs(cfg, shape)
    bax = shd.batch_pspec(mesh, rules)
    dp = bax[0] if bax else None
    acc = accum_for(cfg, shape, variant)
    dp_n = _dp_size(mesh, rules)
    B = shape.global_batch
    # every microbatch must span the full DP axis (mb % dp == 0); larger DP
    # meshes proportionally lower the accumulation depth
    while acc > 1 and (B % acc or (B // acc) % dp_n):
        acc //= 2

    def mk(s: torch.Tensor):
        if s.ndim == 0:
            return _meta(s.shape, s.dtype, mesh)
        shp, spec = tuple(s.shape), [dp] + [None] * (s.ndim - 1)
        if microbatched:
            if shp[0] % acc:
                raise ValueError(f"{cfg.name} {shape.name}: batch {shp[0]} "
                                 f"does not split into {acc} microbatches")
            shp = (acc, shp[0] // acc) + shp[1:]
            spec = [None] + spec
        return _meta(shp, s.dtype, mesh, *spec)

    return {k: mk(v) for k, v in specs.items()}


def _state_abstract(cfg: ModelConfig, mesh, rules):
    pspecs = api.init_specs(cfg)
    params = api.params_module(cfg, shd.abstract(pspecs, mesh, rules))
    opt = opt_lib.init_specs(pspecs)  # OptState of ParamSpec
    opt_abs = opt_lib.OptState(
        m=api.params_module(cfg, shd.abstract(opt.m, mesh, rules)),
        v=api.params_module(cfg, shd.abstract(opt.v, mesh, rules)),
        step=_meta((), torch.int32, mesh))
    return params, opt_abs


def _pspecs_of(tree):
    """PartitionSpec tuples of a module's, an OptState's or a tree's
    DTensors."""
    if isinstance(tree, nn.Module):
        return {n: shd.pspec_of(p) for n, p in tree.named_parameters()}
    if isinstance(tree, opt_lib.OptState):
        return opt_lib.OptState(*(_pspecs_of(t) for t in tree))
    if isinstance(tree, dict):
        return {k: _pspecs_of(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_pspecs_of(v) for v in tree)
    return shd.pspec_of(tree) if isinstance(tree, DTensor) else ()


def _constrain(out, specs, mesh):
    """``out``'s DTensors redistributed to ``specs`` (jit's
    ``out_shardings``)."""
    if isinstance(out, dict):
        return {k: _constrain(v, specs[k], mesh) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_constrain(v, s, mesh) for v, s in zip(out, specs))
    if isinstance(out, DTensor):
        plc = shd.placements(specs, mesh)
        return out if tuple(out.placements) == plc else \
            out.redistribute(mesh, plc)
    return out


def place(abstract, value, mesh):
    """A real argument on an abstract argument's placements: a module leaf
    by leaf in the stacked layout (each rank copies its blocks, so a step
    that updates it in place leaves ``value`` as it was), a tensor by its
    abstract counterpart's PartitionSpec, an OptState or a dict field by
    field; anything else (decode's int position) as it is. Every rank
    passes the same global values."""
    if isinstance(abstract, nn.Module):
        return api.params_module(value.cfg, _zip_leaves(
            lambda a, v: shd.distribute(v, mesh, shd.pspec_of(a), copy=True),
            abstract.tree(), value.tree()))
    if isinstance(abstract, opt_lib.OptState):
        return opt_lib.OptState(*(place(a, v, mesh)
                                  for a, v in zip(abstract, value)))
    if isinstance(abstract, dict):
        return {k: place(abstract[k], value[k], mesh) for k in abstract}
    if isinstance(abstract, DTensor):
        return shd.distribute(torch.as_tensor(value), mesh,
                              shd.pspec_of(abstract))
    return value


def _zip_leaves(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_leaves(fn, a[k], b[k]) for k in a}
    return fn(a, b)


# ---------------------------------------------------------------- train
def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[opt_lib.AdamWConfig] = None,
                    remat=True, param_shardings=None,
                    variant: str = "baseline"):
    """``train/loop.py``'s gradient sums and ``train/optimizer.py``'s AdamW
    with the variant's remat, MoE and attention forms. The sums pin each
    gradient to its parameter's placements (``cs_like``), so
    ``param_shardings`` is kept only as the reference's signature: the
    port's DTensor parameters carry their shardings."""
    opt_cfg = opt_cfg or opt_lib.AdamWConfig()
    v = VARIANTS.get(variant, {})
    remat = v.get("remat", remat)
    moe = v.get("moe", "dense")
    attn = v.get("attn", "grouped")

    def train_step(params, opt, batch):
        with flags.moe_impl(moe), flags.attn_impl(attn):
            gsum, losses = grad_sums(params, cfg, batch, remat=remat)
        for s in gsum:
            s /= len(losses)
        params, opt, stats = opt_lib.apply(opt_cfg, params, opt, gsum)
        metrics = {"loss": torch.stack(losses).mean(), **stats}
        return params, opt, metrics

    return train_step


def _with_act_ctx(fn, mesh, rules):
    """``fn`` inside the anchors' context; plain tensors made inside the
    models (positions, masks, zeros) count as replicated."""
    def wrapped(*args):
        with activation_sharding(mesh, rules), implicit_replication():
            return fn(*args)
    return wrapped


def build_train(cfg: ModelConfig, shape: ShapeSpec, mesh,
                rules=shd.BASELINE_RULES,
                opt_cfg: Optional[opt_lib.AdamWConfig] = None,
                variant: str = "baseline") -> StepBundle:
    cfg = apply_variant(cfg, variant)
    if cfg.name in VARIANTS.get(variant, {}).get("sp_archs", ()):
        rules = shd.SP_RULES
    params, opt = _state_abstract(cfg, mesh, rules)
    batch = _batch_abstract(cfg, shape, mesh, rules, microbatched=True,
                            variant=variant)
    fn = _with_act_ctx(
        make_train_step(cfg, opt_cfg, variant=variant),
        mesh, rules)
    out_sh = (_pspecs_of(params), _pspecs_of(opt),
              {"loss": (), "grad_norm": (), "lr": ()})
    return StepBundle(fn, (params, opt, batch), donate_argnums=(0, 1),
                      out_shardings=out_sh,
                      meta={"kind": "train", "variant": variant,
                            "accum": accum_for(cfg, shape, variant),
                            "mesh": mesh, "rules": rules, "cfg": cfg})


# ---------------------------------------------------------------- prefill
def _infer_out_shardings(out_shapes, mesh, rules, B: int, S: int):
    """Heuristic shardings for the raw prefill outputs: the first dim equal
    to the global batch -> DP axes; the first long sequence dim -> `model`
    (SP). Applied leaf-wise over whatever cache layout the family emits."""
    bax = shd.batch_pspec(mesh, rules)
    dp = bax[0] if bax else None
    dp_n = _dp_size(mesh, rules)
    ms = shd.mesh_shape(mesh)
    mdl_n = ms.get("model", 1)

    def one(leaf):
        if isinstance(leaf, dict):
            return {k: one(v) for k, v in leaf.items()}
        if isinstance(leaf, (tuple, list)):
            return type(leaf)(one(v) for v in leaf)
        spec = [None] * leaf.ndim
        used_b = used_s = False
        for i, d in enumerate(leaf.shape):
            if not used_b and d == B and dp is not None and d % dp_n == 0:
                spec[i] = dp
                used_b = True
            elif (not used_s and d == S and d >= 4096 and "model" in ms
                  and d % mdl_n == 0):
                spec[i] = "model"
                used_s = True
        return _trim(spec)

    return one(out_shapes)


def build_prefill(cfg: ModelConfig, shape: ShapeSpec, mesh,
                  rules=shd.BASELINE_RULES) -> StepBundle:
    pspecs = api.init_specs(cfg)
    params = api.params_module(cfg, shd.abstract(pspecs, mesh, rules))
    batch = _batch_abstract(cfg, shape, mesh, rules, microbatched=False)

    def prefill_step(params, batch):
        return api.prefill(params, cfg, batch, blockwise=True)

    raw = _with_act_ctx(prefill_step, mesh, rules)
    out_shapes = raw(params, batch)  # meta: the reference's eval_shape
    out_sh = _infer_out_shardings(out_shapes, mesh, rules,
                                  shape.global_batch, shape.seq_len)

    def constrained(params, batch):
        return _constrain(raw(params, batch), out_sh, mesh)

    return StepBundle(constrained, (params, batch), donate_argnums=(),
                      out_shardings=out_sh,
                      meta={"kind": "prefill", "mesh": mesh, "rules": rules,
                            "cfg": cfg})


# ---------------------------------------------------------------- decode
def build_decode(cfg: ModelConfig, shape: ShapeSpec, mesh,
                 rules=shd.BASELINE_RULES) -> StepBundle:
    pspecs = api.init_specs(cfg)
    params = api.params_module(cfg, shd.abstract(pspecs, mesh, rules))
    cache = shd.abstract(
        api.cache_specs(cfg, shape.global_batch, shape.seq_len), mesh, rules)
    bax = shd.batch_pspec(mesh, rules)
    dp = bax[0] if bax else None
    B = shape.global_batch
    bdp = dp if B % max(1, _dp_size(mesh, rules)) == 0 else None
    token = _meta((B, 1), torch.int32, mesh, bdp)
    pos = shape.seq_len // 2

    def serve_step(params, cache, pos, token):
        return api.decode_step(params, cfg, cache, pos, token)

    raw = _with_act_ctx(serve_step, mesh, rules)
    cache_sh = _pspecs_of(cache)
    lg = raw(params, cache, pos, token)[0]  # meta: the logits' shape
    ms = shd.mesh_shape(mesh)
    vmdl = ("model" if "model" in ms
            and lg.shape[-1] % ms["model"] == 0 else None)
    logits_sh = _trim([bdp] + [None] * (lg.ndim - 2) + [vmdl])
    out_sh = (logits_sh, cache_sh)

    def constrained(params, cache, pos, token):
        return _constrain(raw(params, cache, pos, token), out_sh, mesh)

    return StepBundle(constrained, (params, cache, pos, token),
                      donate_argnums=(1,), out_shardings=out_sh,
                      meta={"kind": "decode", "mesh": mesh, "rules": rules,
                            "cfg": cfg})


def _dp_size(mesh, rules) -> int:
    ms = shd.mesh_shape(mesh)
    n = 1
    for a in shd.batch_axes(mesh, rules):
        n *= ms[a]
    return n


# ---------------------------------------------------------------- dispatch
def default_rules(shape: ShapeSpec):
    """Training uses FSDP x TP; serving must not FSDP-gather weights per
    token, so decode defaults to the TP-only INFERENCE layout."""
    return shd.INFERENCE_RULES if shape.kind == "decode" else \
        shd.BASELINE_RULES


def build(cfg: ModelConfig, shape: ShapeSpec, mesh,
          rules=None, variant: str = "baseline") -> StepBundle:
    rules = rules if rules is not None else default_rules(shape)
    if shape.kind == "train":
        return build_train(cfg, shape, mesh, rules, variant=variant)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh, rules)
    if shape.kind == "decode":
        return build_decode(cfg, shape, mesh, rules)
    raise ValueError(shape.kind)
