"""``repro_torch.distributed.collectives`` and ``models.moe.apply_moe_ep``
on gloo ranks, against ``repro.distributed.collectives`` and the
reference's ``apply_moe_ep`` on forced host devices (each side in
subprocesses of its own, exchanging arrays through ``.npz`` files):

- the expert all-to-all's dispatch equal to the reference's on the same
  array, and its round trip the identity (bitwise);
- ``compressed_psum`` over 2 and 8 ranks within 1e-6 of the reference, and
  the one-rank path's conservation (grad + err, zero error);
- ``apply_moe_ep`` on (data 2, model 2) for two MoE configs: outputs within
  the bf16 tolerance of the models' tests (rtol = atol = 2e-2), ``aux``
  within 1e-5 relative;
- on (data 1, model 2) in fp32, the input and parameter gradients of the
  expert-parallel dispatch within 1e-5 relative of the dense dispatch's.
"""
import numpy as np
import pytest

from torch_ranks import run_ranks, run_reference

BF16 = dict(rtol=2e-2, atol=2e-2)
# arrays cross the process boundary as npz; bf16 as its 16-bit pattern
_IO = """
import numpy as np

def save(path, **arrays):
    out = {}
    for k, a in arrays.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            k, a = k + "@bf16", a.view(np.uint16)
        out[k] = a
    np.savez(path, **out)
"""
_TORCH_IO = _IO + """
import torch

def load(path):
    out = {}
    for k, a in np.load(path).items():
        if k.endswith("@bf16"):
            out[k[:-5]] = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(a)
    return out

def as_np(t):
    t = t.detach()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
"""


def test_expert_all_to_all_and_compressed_psum_match_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "in.npz",
             g=rng.standard_normal((16, 64)).astype(np.float32),
             e=(0.1 * rng.standard_normal((16, 64))).astype(np.float32))
    run_reference(f"""
    import jax.numpy as jnp
    from repro.distributed.collectives import (compressed_psum,
        expert_all_to_all_combine, expert_all_to_all_dispatch)
    from repro.launch.mesh import make_host_mesh
    x = jnp.arange(8 * 16 * 32, dtype=jnp.float32).reshape(8, 16, 32)
    disp = expert_all_to_all_dispatch(x, make_host_mesh((2, 4)), "model")
    inp = np.load("{tmp_path}/in.npz")
    out = {{"disp": disp}}
    for n, shape in ((2, (2, 4)), (8, (8, 1))):
        mesh = make_host_mesh(shape, ("pod", "data"))
        a, e = compressed_psum(jnp.asarray(inp["g"]), jnp.asarray(inp["e"]),
                               mesh, "pod")
        out[f"approx{{n}}"], out[f"err{{n}}"] = a, e
    save("{tmp_path}/ref.npz", **out)
    """, 8, timeout=300, prelude=_IO)
    out = run_ranks("""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sharding as shd

    def run(rank, world, out):
        x = torch.arange(8 * 16 * 32, dtype=torch.float32).reshape(8, 16, 32)
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        xd = shd.distribute(x, mesh, (None, "model"))
        disp = coll.expert_all_to_all_dispatch(xd, mesh, "model")
        assert shd.pspec_of(disp) == ("model",)
        back = coll.expert_all_to_all_combine(disp, mesh, "model")
        assert shd.pspec_of(back) == (None, "model")
        res = {"disp": as_np(disp.full_tensor()),
               "back": as_np(back.full_tensor())}
        inp = load(out + "/in.npz")
        for n, shape in ((2, (2, 4)), (8, (8, 1)), (1, (1, 8))):
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("pod", "data"))
            g = shd.distribute(inp["g"], mesh, ("pod",))
            e = shd.distribute(inp["e"], mesh, ("pod",))
            a, ne = coll.compressed_psum(g, e, mesh, "pod")
            res[f"approx{n}"] = as_np(a.full_tensor())
            res[f"err{n}"] = as_np(ne.full_tensor())
        if rank == 0:
            save(out + "/port.npz", **res)
    """, 8, tmp_path, timeout=300, prelude=_TORCH_IO)
    ref, got = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    x = np.arange(8 * 16 * 32, dtype=np.float32).reshape(8, 16, 32)
    np.testing.assert_array_equal(got["disp"], ref["disp"])
    np.testing.assert_array_equal(got["back"], x)
    for n in (2, 8):
        for k in (f"approx{n}", f"err{n}"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6)
    # the int8 sum approximates the true one within quantization error
    g, e = np.load(tmp_path / "in.npz")["g"], np.load(tmp_path / "in.npz")["e"]
    true2 = (g + e).reshape(2, 8, 64).sum(0)
    assert np.abs(got["approx2"][:8] - true2).max() / np.abs(true2).max() \
        < 0.05
    # n = 1: nothing to reduce, the carried error folds in exactly
    np.testing.assert_array_equal(got["approx1"], g + e)
    assert not got["err1"].any()
    # n = 8: each shard's estimate plus every shard's new error is the sum
    tot = (g + e).reshape(8, 2, 64).sum(0)
    np.testing.assert_allclose(
        got["approx8"][:2] + got["err8"].reshape(8, 2, 64).sum(0), tot,
        rtol=1e-4, atol=1e-4)


ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_ep_matches_the_reference(tmp_path, arch):
    run_reference(f"""
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.distributed.constraints import activation_sharding
    from repro.launch.mesh import make_host_mesh
    from repro.models import moe, params as P
    cfg = get_config("{arch}", reduced=True)
    prm = P.materialize(moe.moe_specs(cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((4, 16, cfg.d_model)),
                    jnp.bfloat16)
    mesh = make_host_mesh((2, 2))
    with activation_sharding(mesh):
        y, aux = moe.apply_moe_ep(x, prm, cfg)
    flat = {{"prm/" + k: v for k, v in prm.items() if k != "shared"}}
    flat.update({{"shared/" + k: v for k, v in prm.get("shared", {{}}).items()}})
    save("{tmp_path}/ref.npz", x=x, y=y, aux=aux, **flat)
    """, 4, timeout=300, prelude=_IO)
    out = run_ranks(f"""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.constraints import activation_sharding
    from repro_torch.models import flags, moe

    def run(rank, world, out):
        cfg = get_config("{arch}", reduced=True)
        ref = load(out + "/ref.npz")
        tree = {{k[4:]: v for k, v in ref.items() if k.startswith("prm/")}}
        shared = {{k[7:]: v for k, v in ref.items()
                   if k.startswith("shared/")}}
        if shared:
            tree["shared"] = shared
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        prm = shd.distribute_tree(tree, moe.moe_specs(cfg), mesh)
        x = shd.distribute(ref["x"], mesh, ("data",))
        assert moe.apply_moe_ep(x, prm, cfg) == (None, None)  # no context
        with activation_sharding(mesh), implicit_replication(), \\
                flags.moe_impl("ep"):
            y, aux = moe.apply_moe(x, prm, cfg)
        y, aux = y.full_tensor(), aux.full_tensor()
        if rank == 0:
            save(out + "/port.npz", y=as_np(y), aux=as_np(aux))
    """, 4, tmp_path, timeout=300, prelude=_TORCH_IO)
    ref, got = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    y_ref = ref["y@bf16"].astype(np.uint32) << 16
    np.testing.assert_allclose(got["y"], y_ref.view(np.float32), **BF16)
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_parallel_gradients_equal_the_dense_dispatch_s(tmp_path, arch):
    """fp32 parameters and inputs on (data 1, model 2): each rank runs half
    the experts, and the all-reduce's backward and the ``Partial``
    gradient placements must give the dense dispatch's gradients (an
    all-reduce without autograd would lose them, one that sums the
    replicated cotangent would double them)."""
    run_ranks(f"""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.constraints import activation_sharding
    from repro_torch.models import flags, moe
    from repro_torch.models import params as Pm

    def run(rank, world, out):
        cfg = get_config("{arch}", reduced=True)
        specs = moe.moe_specs(cfg)
        tree = Pm.tree_map_specs(lambda t: t.float(), Pm.materialize(
            specs, torch.Generator().manual_seed(0), torch.device("cpu")))
        x = torch.randn((2, 16, cfg.d_model),
                        generator=torch.Generator().manual_seed(1))
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        res = {{}}
        for impl in ("ep", "dense"):
            prm = shd.distribute_tree(tree, specs, mesh)
            leaves = [t.requires_grad_(True) for t in Pm.leaves(prm)]
            xd = shd.distribute(x, mesh, ("data",)).requires_grad_(True)
            with activation_sharding(mesh), implicit_replication(), \\
                    flags.moe_impl(impl):
                y, aux = moe.apply_moe(xd, prm, cfg)
                loss = (y * y).sum() + 10.0 * aux
                grads = torch.autograd.grad(loss, [xd] + leaves)
            res[impl + "/y"] = as_np(y.full_tensor())
            res[impl + "/aux"] = as_np(aux.full_tensor())
            for i, g in enumerate(grads):
                res[f"{{impl}}/g{{i}}"] = as_np(g.full_tensor())
        if rank == 0:
            save(out + "/port.npz", **res)
    """, 2, tmp_path, timeout=300, prelude=_TORCH_IO)
    got = np.load(tmp_path / "port.npz")
    names = sorted(k[3:] for k in got if k.startswith("ep/"))
    assert "g0" in names and len(names) > 4
    for k in names:
        a, b = got["ep/" + k], got["dense/" + k]
        assert np.abs(a).max() > 0 or np.abs(b).max() == 0, k
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30),
                                   err_msg=k)
