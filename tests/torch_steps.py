"""The step comparison of the ``tests/test_torch_launch_steps*.py``
files: the reference's compiled steps on ``make_host_mesh((4, 2))`` (8
forced host devices) and the port's built steps on a 4 x 2 gloo mesh,
on the same parameters and inputs, held to each other (see
``tests/test_torch_launch_steps.py`` for the checks and tolerances)."""
import json

import numpy as np

from torch_ranks import run_ranks, run_reference

BF16 = dict(rtol=2e-2, atol=2e-2)
CASES = {"olmo-1b": ("train_4k", "prefill_32k", "decode_32k"),
         "qwen2-moe-a2.7b": ("train_4k", "prefill_32k", "decode_32k"),
         "mamba2-2.7b": ("train_4k", "prefill_32k", "long_500k")}
B, S, ACCUM, PROMPT = 8, 256, 2, 100
# the train step's AdamW: no warmup, so step 0 updates at the full lr
OPT = dict(warmup_steps=1, lr=5e-3)
MOMENTS_REL, DELTA_REL = 0.15, 0.5

_IO = """
import json
import numpy as np

def save(path, **arrays):
    out = {}
    for k, a in arrays.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            k, a = k + "@bf16", a.view(np.uint16)
        out[k] = a
    np.savez(path, **out)

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + k + "/"))
        return out
    return {prefix[:-1]: tree}

def nest(specs, d, prefix=""):
    # d's leaves (keyed by path) in the layout of the spec tree specs: an
    # empty sub-tree, like olmo's norms, stays empty
    if isinstance(specs, dict):
        return {k: nest(v, d, prefix + k + "/") for k, v in specs.items()}
    return d[prefix[:-1]]

def inputs(vocab):
    rng = np.random.default_rng(7)
    return {"train": rng.integers(0, vocab, (%d, %d, %d)).astype(np.int32),
            "prefill": rng.integers(0, vocab, (%d, %d)).astype(np.int32),
            "prompt": rng.integers(0, vocab, (%d, %d)).astype(np.int32),
            "token": rng.integers(0, vocab, (%d, 1)).astype(np.int32)}
""" % (ACCUM, B // ACCUM, S, B, S, B, PROMPT, B)


def _ref(arch, kinds, out):
    return f"""
    import dataclasses
    import jax, jax.numpy as jnp
    from repro.configs import get_config, get_shape
    from repro.launch import steps
    from repro.launch.mesh import make_host_mesh
    from repro.models import api
    from repro.train import optimizer as opt_lib
    cfg = get_config("{arch}", reduced=True)
    mesh = make_host_mesh((4, 2))
    params = api.init_params(cfg, jax.random.PRNGKey(0))
    res = {{"p/" + k: v for k, v in flat(params).items()}}
    inp = inputs(cfg.vocab_size)
    specs = {{}}
    for sid in {list(kinds)!r}:
        shape = dataclasses.replace(get_shape(sid), global_batch={B},
                                    seq_len={S}, accum={ACCUM})
        kind = shape.kind
        b = steps.build_train(cfg, shape, mesh, steps.default_rules(shape),
                              opt_cfg=opt_lib.AdamWConfig(**{OPT!r})) \
            if kind == "train" else steps.build(cfg, shape, mesh)
        if kind == "train":
            args = (params, opt_lib.init(params), {{"tokens": inp["train"]}})
        elif kind == "prefill":
            args = (params, {{"tokens": inp["prefill"]}})
        else:
            _, cache = api.build_decode_cache(
                params, cfg, {{"tokens": jnp.asarray(inp["prompt"])}}, {S})
            args = (params, cache, jnp.int32({PROMPT}), inp["token"])
        leaves, tdef = jax.tree_util.tree_flatten(b.abstract_args)
        specs[kind] = [[jax.tree_util.keystr(p), tuple(a.sharding.spec)]
                       for p, a in jax.tree_util.tree_flatten_with_path(
                           b.abstract_args)[0]]
        real = jax.tree_util.tree_leaves(args)
        placed = jax.tree_util.tree_unflatten(tdef, [
            jax.device_put(jnp.asarray(r), a.sharding)
            for r, a in zip(real, leaves)])
        with mesh:
            o = jax.jit(b.fn, out_shardings=b.out_shardings)(*placed)
        if kind == "train":
            for part, tree in (("train", o[0]), ("m", o[1].m), ("v", o[1].v)):
                res.update({{part + "/" + k: v for k, v in flat(tree).items()}})
            res["train:loss"], res["train:grad_norm"] = (o[2]["loss"],
                                                         o[2]["grad_norm"])
            res["train:step"] = o[1].step
        else:
            res[kind + ":logits"] = o[0]
    save("{out}/ref.npz", **res)
    open("{out}/ref_specs.json", "w").write(json.dumps(specs))
    """


def _port(arch, kinds):
    return f"""
    import dataclasses
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config, get_shape
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.models import params as P
    from repro_torch.train import optimizer as opt_lib

    def arr(t):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        t = t.detach()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()

    def specs_of(a):
        if isinstance(a, torch.nn.Module):
            return specs_of(a.tree())
        if isinstance(a, opt_lib.OptState):
            return {{"m": specs_of(a.m), "v": specs_of(a.v),
                     "step": specs_of(a.step)}}
        if isinstance(a, dict):
            return {{k: specs_of(v) for k, v in a.items()}}
        # a leaf's PartitionSpec as a JSON string
        return json.dumps(shd.pspec_of(a)) if isinstance(a, DTensor) \
            else None

    def run(rank, world, out):
        cfg = get_config("{arch}", reduced=True)
        mesh = make_host_mesh((4, 2))
        ref = np.load(out + "/ref.npz")
        tree = {{}}
        for k in ref.files:
            if k.startswith("p/"):
                a = ref[k]
                if k.endswith("@bf16"):
                    k, a = k[:-5], a.view(np.int16)
                    tree[k[2:]] = torch.from_numpy(a).view(torch.bfloat16)
                else:
                    tree[k[2:]] = torch.from_numpy(a)
        host = api.params_module(cfg, nest(api.init_specs(cfg), tree))
        inp = inputs(cfg.vocab_size)
        res, specs = {{}}, {{}}
        for sid in {list(kinds)!r}:
            shape = dataclasses.replace(get_shape(sid), global_batch={B},
                                        seq_len={S}, accum={ACCUM})
            kind = shape.kind
            b = steps.build_train(
                cfg, shape, mesh, steps.default_rules(shape),
                opt_cfg=opt_lib.AdamWConfig(**{OPT!r})) \
                if kind == "train" else steps.build(cfg, shape, mesh)
            specs[kind] = json.loads(json.dumps(
                [specs_of(a) for a in b.abstract_args]))
            if kind == "train":
                vals = (host, opt_lib.init(host),
                        {{"tokens": torch.from_numpy(inp["train"])}})
                args = [steps.place(a, v, mesh) for a, v in
                        zip(b.abstract_args, vals)]
                p, o, st = b.fn(*args)
                for part, tree in (("train", p), ("m", o.m), ("v", o.v)):
                    res.update({{part + "/" + k: arr(v)
                                 for k, v in flat(tree.tree()).items()}})
                res["train:step"] = arr(o.step)
                res["train:loss"] = arr(st["loss"])
                res["train:grad_norm"] = arr(st["grad_norm"])
            elif kind == "prefill":
                args = [steps.place(a, v, mesh) for a, v in zip(
                    b.abstract_args,
                    (host, {{"tokens": torch.from_numpy(inp["prefill"])}}))]
                res[kind + ":logits"] = arr(b.fn(*args)[0])
            else:
                _, cache = api.build_decode_cache(
                    host, cfg, {{"tokens": torch.from_numpy(inp["prompt"])}},
                    {S})
                rules = b.meta["rules"]
                cd = shd.distribute_tree(
                    cache, api.cache_specs(cfg, {B}, {S}), mesh, rules)
                args = (steps.place(b.abstract_args[0], host, mesh),
                        cd, {PROMPT}, steps.place(
                            b.abstract_args[3],
                            torch.from_numpy(inp["token"]), mesh))
                res[kind + ":logits"] = arr(b.fn(*args)[0])
        if rank == 0:
            save(out + "/port.npz", **res)
            open(out + "/port_specs.json", "w").write(json.dumps(specs))
    """


def _leaf_specs(tree):
    """Leaf specs of the port's nested abstract arguments, in the order
    ``jax.tree_util`` lists the reference's (sorted dict keys; OptState's
    fields m, v, step)."""
    if isinstance(tree, dict):
        keys = ("m", "v", "step") if set(tree) == {"m", "v", "step"} else \
            sorted(tree)
        return [s for k in keys for s in _leaf_specs(tree[k])]
    if isinstance(tree, list):
        return [s for t in tree for s in _leaf_specs(t)]
    return [tree]


def check_steps(tmp_path, arch):
    """Run both sides for ``arch``'s kinds and hold them to each other."""
    kinds = CASES[arch]
    run_reference(_ref(arch, kinds, tmp_path), 8, timeout=600, prelude=_IO)
    run_ranks(_port(arch, kinds), 8, tmp_path, timeout=600, prelude=_IO)
    ref, got = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")

    def want(k):
        return ref[k] if k in ref.files else \
            (ref[k + "@bf16"].astype(np.uint32) << 16).view(np.float32)

    def rel_close(a, b, rel, what):
        a, b = a.astype(np.float64), b.astype(np.float64)
        err, size = np.linalg.norm(a - b), np.linalg.norm(b)
        assert err <= rel * size, f"{what}: |got - want| {err:.3g} > " \
            f"{rel} * |want| {size:.3g}"

    for k in got.files:
        part = k.split("/")[0]
        if k == "train:loss":
            np.testing.assert_allclose(got[k], want(k), rtol=1e-4, err_msg=k)
        elif k == "train:grad_norm":
            np.testing.assert_allclose(got[k], want(k), rtol=2e-2, err_msg=k)
        elif k == "train:step":
            assert got[k] == want(k) == 1, k
        elif part in ("m", "v"):  # fp32 moments; v through its square root
            f = np.sqrt if part == "v" else np.asarray
            rel_close(f(got[k]), f(want(k)), MOMENTS_REL, k)
        else:
            np.testing.assert_allclose(got[k], want(k), err_msg=k, **BF16)
            if part == "train":  # the update itself: p_new - p_old
                old = want("p/" + k[len("train/"):]).astype(np.float64)
                rel_close(got[k] - old, want(k) - old, DELTA_REL,
                          "update of " + k)
    assert {k.split(":")[0] for k in got.files if ":" in k} == \
        {"train", "prefill", "decode"}
    # placements: the port's abstract arguments against the reference's
    rspecs = json.loads((tmp_path / "ref_specs.json").read_text())
    pspecs = json.loads((tmp_path / "port_specs.json").read_text())
    for kind, rs in rspecs.items():
        port = _leaf_specs(pspecs[kind])
        if kind == "decode":  # the port's pos is an int: no placement
            assert port[-2] is None and rs[-2][1] == []
            port, rs = port[:-2] + port[-1:], rs[:-2] + rs[-1:]
        assert len(port) == len(rs), kind
        for (path, w), p in zip(rs, port):
            while w and w[-1] is None:  # the batch's specs are untrimmed
                w = w[:-1]
            assert p == json.dumps(w), (kind, path, p, w)
