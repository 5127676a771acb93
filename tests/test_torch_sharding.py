"""``repro_torch.distributed.sharding`` against ``repro.distributed.sharding``:
the PartitionSpec of every parameter and cache spec of the ten full
configs, on three meshes and under the four rule tables, bitwise; and
DTensor placements on a 4-rank gloo mesh (local blocks are the global
shape divided by the axis sizes)."""
import pytest

from repro.configs import ARCH_IDS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs import get_shape as ref_shape
from repro.distributed import sharding as rshd
from repro.models import api as rapi
from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.distributed import sharding as shd
from repro_torch.models import api
from repro_torch.models import params as Pm

from torch_ranks import run_ranks


class _FakeMesh:
    """Duck-typed mesh: spec_to_pspec only reads .shape."""

    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2}}
RULES = ("BASELINE_RULES", "INFERENCE_RULES", "SP_RULES", "ZERO3_POD_RULES")


def _ref_tuples(tree):
    """The reference's PartitionSpecs as tuples, leaf by leaf."""
    if isinstance(tree, dict):
        return {k: _ref_tuples(v) for k, v in tree.items()}
    return tuple(tree)


def test_the_rule_tables_are_the_reference_s():
    for name in RULES:
        assert getattr(shd, name) == getattr(rshd, name)
    assert shd._PRIORITY == rshd._PRIORITY
    assert list(ARCH_IDS) == list(REF_ARCHS)


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pspecs_equal_the_reference(arch, mesh, rules):
    m = _FakeMesh(MESHES[mesh])
    tr, rr = getattr(shd, rules), getattr(rshd, rules)
    cfg, rcfg = get_config(arch), ref_config(arch)
    dec = get_shape("decode_32k")
    for specs, rspecs in (
            (api.init_specs(cfg), rapi.init_specs(rcfg)),
            (api.cache_specs(cfg, dec.global_batch, dec.seq_len),
             rapi.cache_specs(rcfg, dec.global_batch, dec.seq_len))):
        got = shd.tree_pspecs(specs, m, tr)
        assert got == _ref_tuples(rshd.tree_pspecs(rspecs, m, rr))
        # leaf by leaf, as spec_to_pspec gives it
        for s, g in zip(Pm.leaves(specs), Pm.leaves(got)):
            assert shd.spec_to_pspec(s.shape, s.axes, m, tr) == g
    assert shd.batch_pspec(m, tr) == tuple(rshd.batch_pspec(m, rr))
    assert shd.batch_axes(m, tr) == rshd.batch_axes(m, rr)
    assert ref_shape("decode_32k").global_batch == dec.global_batch


def test_placements_of_a_pspec():
    class Mesh:
        ndim = 3
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 4, 2)

    class One(Mesh):  # a mesh dim of size 1 holds the whole tensor
        shape = (2, 1, 2)
    from torch.distributed.tensor import Replicate, Shard
    assert shd.placements((("pod", "data"), None, "model"), Mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements((), Mesh) == (Replicate(),) * 3
    assert shd.placements((None, "data"), Mesh) == (
        Replicate(), Shard(1), Replicate())
    assert shd.placements((("pod", "data"), None, "model"), One) == (
        Shard(0), Replicate(), Shard(2))


def test_placements_on_a_gloo_mesh(tmp_path):
    """Every parameter of olmo-1b's and qwen2-moe's reduced configs and a
    two-axis batch dim, distributed on (pod 2, data 2) and (data 2, model
    2): each rank's block is the global shape divided by the axis sizes,
    holds the rank's slice of the global value, and ``pspec_of`` gives the
    PartitionSpec back."""
    out = run_ranks("""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import api
    from repro_torch.models import params as Pm

    def run(rank, world, out):
        n = 0
        for axes in (("pod", "data"), ("data", "model")):
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=axes)
            size = dict(zip(axes, (2, 2)))
            for arch in ("olmo-1b", "qwen2-moe-a2.7b"):
                cfg = get_config(arch, reduced=True)
                specs = api.init_specs(cfg)
                tree = Pm.materialize(specs, torch.Generator().manual_seed(0),
                                      torch.device("cpu"))
                dt = shd.distribute_tree(tree, specs, mesh, shd.ZERO3_POD_RULES)
                for s, t, d in zip(Pm.leaves(specs), Pm.leaves(tree),
                                   Pm.leaves(dt)):
                    ps = shd.spec_to_pspec(s.shape, s.axes, mesh,
                                           shd.ZERO3_POD_RULES)
                    want = list(s.shape)
                    for i, e in enumerate(ps):
                        for a in ((e,) if isinstance(e, str) else e or ()):
                            want[i] //= size[a]
                    assert list(d.to_local().shape) == want, (s, ps)
                    assert shd.pspec_of(d) == ps
                    assert torch.equal(d.full_tensor(), t)
                    n += 1
            x = torch.arange(8 * 3).reshape(8, 3)
            ps = shd.batch_pspec(mesh, shd.BASELINE_RULES) + (None,)
            d = shd.distribute(x, mesh, ps)
            assert torch.equal(d.full_tensor(), x)
            assert d.to_local().shape[0] == 8 // (4 if axes[0] == "pod" else 2)
        if rank == 0:
            print("checked", n)
    """, 4, tmp_path, timeout=300)
    assert "checked" in out
