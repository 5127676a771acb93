"""``repro_torch.launch`` and the api helpers against the JAX package:

- ``input_specs``, ``count_params``, ``count_matmul_params``, ``scan_units``
  and ``with_depth`` for the ten full configs (spec-only, bitwise);
- ``accum_for``, ``apply_variant``, ``default_rules``, the variants and the
  accumulation overrides;
- ``analysis``'s ``analytic_memory_bytes``, ``extrapolate``,
  ``collective_bytes``, ``roofline`` and ``dryrun.attach_adjusted_roofline``
  on the same inputs (the reference's TPU constants given to the port as a
  ``HardwareSpec``), exactly;
- the recorder's FLOPs and bytes on plain ops;
- one dry-run cell in a subprocess (a 256-rank fake process group):
  ``0 failures`` and its counts equal to the reference's functions.
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_shape as ref_shape
from repro.distributed import sharding as rshd
from repro.launch import analysis as ranalysis
from repro.launch import dryrun as rdryrun
from repro.launch import steps as rsteps
from repro.launch.mesh import V5E
from repro.models import api as rapi
from repro_torch.configs import ARCH_IDS, SHAPE_ORDER, get_config, get_shape
from repro_torch.distributed import sharding as shd
from repro_torch.launch import analysis, dryrun, steps
from repro_torch.launch.mesh import H100, HardwareSpec
from repro_torch.models import api

from torch_ranks import ROOT, _env

TPU = HardwareSpec(**dataclasses.asdict(V5E))
MESH_SHAPES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
               {"data": 4, "model": 2})


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_api_helpers_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for s in SHAPE_ORDER:
        got = api.input_specs(cfg, get_shape(s))
        want = rapi.input_specs(rcfg, ref_shape(s))
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape)
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype)
    for active in (False, True):
        assert api.count_params(cfg, active) == rapi.count_params(rcfg, active)
        assert api.count_matmul_params(cfg, active) == \
            rapi.count_matmul_params(rcfg, active)
    assert api.scan_units(cfg) == rapi.scan_units(rcfg)
    for u in (1, 2, 3):
        a, b = api.with_depth(cfg, u), rapi.with_depth(rcfg, u)
        assert (a.num_layers, a.num_encoder_layers) == \
            (b.num_layers, b.num_encoder_layers)
        assert api.count_params(a) == rapi.count_params(b)
        assert api.scan_units(a) == u


def test_step_tables_equal_the_reference():
    assert steps.ACCUM_OVERRIDES == rsteps.ACCUM_OVERRIDES
    assert steps.VARIANTS == rsteps.VARIANTS
    for arch in ARCH_IDS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        for v in steps.VARIANTS:
            assert steps.apply_variant(cfg, v).expert_pad == \
                rsteps.apply_variant(rcfg, v).expert_pad
            for s in SHAPE_ORDER:
                assert steps.accum_for(cfg, get_shape(s), v) == \
                    rsteps.accum_for(rcfg, ref_shape(s), v)
    for s in SHAPE_ORDER:
        assert steps.default_rules(get_shape(s)) == \
            rsteps.default_rules(ref_shape(s))
    assert steps.default_rules(get_shape("decode_32k")) is shd.INFERENCE_RULES
    assert rshd.INFERENCE_RULES == shd.INFERENCE_RULES


def test_analysis_equals_the_reference():
    for arch in ARCH_IDS:
        cfg, rcfg = get_config(arch), ref_config(arch)
        pb = rapi.P.bytes_of(rapi.init_specs(rcfg))
        for s in SHAPE_ORDER:
            shape, rshape = get_shape(s), ref_shape(s)
            for ms in MESH_SHAPES:
                for accum, remat, cache in ((1, True, 0.0),
                                            (4, False, 3.5e9)):
                    assert analysis.analytic_memory_bytes(
                        cfg, shape, ms, accum, shape.kind, pb, cache,
                        remat) == ranalysis.analytic_memory_bytes(
                        rcfg, rshape, ms, accum, rshape.kind, pb, cache,
                        remat)
    for f1, f2, u in ((3.0, 5.0, 16), (1e12, 1.7e12, 95), (7.0, 7.0, 1)):
        assert analysis.extrapolate(f1, f2, u) == \
            ranalysis.extrapolate(f1, f2, u)
    fields = [("all-gather", 1 << 20, 1, 3, False),
              ("all-reduce", 4096, 16, 2, True),
              ("reduce-scatter", 1 << 24, 256, 1, True),
              ("all-to-all", 12345, 512, 5, False)]
    for cpp in (256, 8):
        got = analysis.collective_bytes(
            [analysis.CollectiveOp(*f) for f in fields], cpp)
        want = ranalysis.collective_bytes(
            [ranalysis.CollectiveOp(*f) for f in fields], cpp)
        assert got == want
    coll = {"ici": 3.2e9, "dcn": 1.1e8, "total": 3.31e9}
    for args in ((1.2e15, 3.3e11, coll, 6.1e17, 256),
                 (2.0e12, 9.0e12, {}, 1.0e12, 1)):
        got = analysis.roofline(*args, hw=TPU)
        want = ranalysis.roofline(*args)
        for k in ("compute_s", "memory_s", "collective_s", "dcn_s",
                  "flops_per_device", "bytes_per_device",
                  "coll_bytes_per_device", "model_flops", "chips",
                  "dominant", "step_time_s", "mfu", "useful_frac"):
            assert getattr(got, k) == getattr(want, k), k
    # on the card's constants the compute term is the H100's
    assert analysis.roofline(989e12, 0.0, {}, 0.0, 1).compute_s == 1.0
    assert analysis.roofline(0.0, 3.35e12, {}, 0.0, 1, H100).memory_s == 1.0


@pytest.mark.parametrize("arch,shape", [("olmo-1b", "train_4k"),
                                        ("qwen2-moe-a2.7b", "decode_32k"),
                                        ("mamba2-2.7b", "prefill_32k")])
def test_attach_adjusted_roofline_equals_the_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_config(arch)
    rl = {"compute_s": 0.31, "memory_s": 0.12, "collective_s": 0.05,
          "dcn_s": 0.0, "collective_bf16eq_s": 0.04, "model_flops": 7.5e17}
    got = {"chips": 256, "roofline": dict(rl)}
    want = {"chips": 256, "roofline": dict(rl)}
    ms = {"data": 16, "model": 16}
    dryrun.attach_adjusted_roofline(got, cfg, get_shape(shape),
                                    mesh_shape=ms, hw=TPU)
    rdryrun.attach_adjusted_roofline(want, rcfg, ref_shape(shape),
                                     mesh_shape=ms)
    assert got == want


def test_the_recorder_counts_flops_and_unfused_bytes():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    rec = analysis.Recorder()
    with rec:
        c = a @ b
        d = c.t()  # a view: no bytes
        e = d * 2.0
    assert torch.equal(e, (a @ b).t() * 2.0)
    assert rec.flops == 2 * 64 * 32 * 16
    mm = (64 * 32 + 32 * 16 + 64 * 16) * 4
    mul = 2 * 64 * 16 * 4
    assert rec.bytes == mm + mul
    assert rec.collectives == []
    assert analysis.tree_bytes({"a": a, "b": [b]}) == (64 * 32 + 32 * 16) * 4


def test_dry_run_cell_subprocess(tmp_path):
    """One real dry-run cell (full config, a 256-rank fake group) of the
    port: its counts are the reference's."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "olmo-1b", "--shape", "decode_32k", "--mesh", "single", "--force",
         "--out", str(tmp_path)], capture_output=True, text=True,
        timeout=240, env=_env(), cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "\n0 failures" in r.stdout
    rec = json.loads((tmp_path / "16x16" / "olmo-1b__decode_32k.json")
                     .read_text())
    rcfg, rshape = ref_config("olmo-1b"), ref_shape("decode_32k")
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["params_total"] == rapi.count_params(rcfg)
    assert rec["params_active"] == rapi.count_params(rcfg, active_only=True)
    rl = rec["roofline"]
    assert rl["model_flops"] == 2 * rapi.count_matmul_params(
        rcfg, active_only=True) * rshape.global_batch
    assert rl["scan_units"] == rapi.scan_units(rcfg)
    assert rl["flops_per_device"] > 0 and rl["bytes_per_device"] > 0
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["collectives_rolled"], "no collective recorded"
    assert np.isfinite(rl["mfu_adj"])


def test_chip_smoke_launch_phase_runs_on_the_cpu():
    """``chip_smoke.py``'s launch phase at a small size on the CPU, in a
    subprocess (it starts a one-rank gloo group): the card run's query
    over 8 partitions of 256 documents of 64 tokens, olmo-1b's and
    qwen2-moe's reduced configs, a (4, 64) prefill and 4 decode steps,
    and the dry-run subprocess."""
    code = """
import sys
sys.path.insert(0, %r)
import chip_smoke as smoke
from repro_torch.configs import get_config
corpus = dict(smoke.PIPE_CORPUS, num_partitions=8, docs_per_part=256,
              doc_len=64, vocab=256)
query = dict(smoke.TRAIN_QUERY, seq_len=64)
launches = smoke.launch_phase(
    get_config("olmo-1b", reduced=True),
    get_config("qwen2-moe-a2.7b", reduced=True), corpus, query, "cpu",
    lambda: None, published=(0, 0),
    train_cut=dict(global_batch=8, seq_len=64, accum=2), prefill=(4, 64),
    decode_steps=4)
assert launches == dict.fromkeys(launches, 0), launches  # plain versions
print("phase ok")
""" % str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=_env(), cwd=str(ROOT))
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    out = r.stdout
    assert "phase ok" in out
    assert out.count("every parameter and moment bitwise") == 2
    assert "every logit bitwise equal" in out
    assert "0 failures" in out
