"""Multi-node dry run on a fake process group (port of
``repro.launch.dryrun``).

For every (arch x shape x mesh) cell:

1. FULL-depth pass: the step runs on meta DTensors over the production
   mesh (16x16, or 2x16x16 with `pod`), which proves that the placements
   are coherent; argument/output bytes per device from the abstract trees
   and the collective schedule from the recorder.
2. Shallow COST pass (U in {1,2}; train cells also sweep grad-accum A in
   {1,2}): recorded FLOPs/bytes and collective bytes, extrapolated
   (bi)linearly to full depth/accum as the reference does; see
   ``repro_torch.launch.analysis``.

The reference forces 512 host devices before importing JAX. Here the
process group comes first: ``main`` starts a ``fake`` group (a
``FakeStore``, no communication) of 256 or 512 ranks, as rank 0, before
any mesh exists; every tensor is a meta tensor, so nothing is allocated.
The roofline reads the ``HardwareSpec`` it is given (``mesh.H100``).

Run: ``python -m repro_torch.launch.dryrun --arch olmo-1b --shape
decode_32k --mesh single``. Results land in
``reports/dryrun_torch/<mesh>/<arch>__<shape>.json`` (resumable).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, SHAPE_ORDER, get_config,
                                 get_shape, shape_applicable)
from repro_torch.distributed import sharding as shd
from repro_torch.launch import analysis, steps
from repro_torch.launch.mesh import (H100, HardwareSpec, make_production_mesh,
                                     mesh_chips, mesh_tag)
from repro_torch.models import api, flags
from repro_torch.models import params as Pm

RULES = {"baseline": None,  # kind-appropriate default (steps.default_rules)
         "zero3": shd.ZERO3_POD_RULES}


def fake_world(world_size: int) -> None:
    """(Re)start this process's group as a ``fake`` one of
    ``world_size`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _trace(cfg, shape, mesh, rules, *, accum=None, variant="baseline"):
    """Build the cell's step (with ``accum`` microbatches when given) and
    run it on its abstract arguments. Returns (bundle, outputs,
    recorder)."""
    if accum is not None:
        steps.ACCUM_OVERRIDES[(cfg.name, shape.name)] = accum
        if variant != "baseline":
            steps.VARIANTS[variant].setdefault("accum", {})[
                (cfg.name, shape.name)] = accum
    try:
        bundle = steps.build(cfg, shape, mesh, rules, variant=variant)
        out, rec = bundle.trace()
        return bundle, out, rec
    finally:
        if accum is not None:
            steps.ACCUM_OVERRIDES.pop((cfg.name, shape.name), None)


def run_cell(arch: str, shape_id: str, mesh, rules_name: str,
             *, cost_pass: bool = True, full_pass: bool = True,
             variant: str = "baseline", hw: HardwareSpec = H100) -> dict:
    cfg = get_config(arch)
    shape = get_shape(shape_id)
    rules = RULES[rules_name]
    if rules is not None and shape.kind == "decode":
        rules = dict(rules, embed=shd.INFERENCE_RULES["embed"],
                     kv_hd=shd.INFERENCE_RULES["kv_hd"])
    chips = mesh_chips(mesh)
    ms = shd.mesh_shape(mesh)
    cpp = 256 if "pod" in ms else chips  # chips per pod
    rec: dict = {
        "arch": arch, "shape": shape_id, "mesh": mesh_tag(mesh),
        "rules": rules_name, "variant": variant, "chips": chips,
        "hardware": hw.name,
        "params_total": api.count_params(cfg),
        "params_active": api.count_params(cfg, active_only=True),
    }
    t0 = time.time()

    if full_pass:
        bundle, out, r = _trace(cfg, shape, mesh, rules, variant=variant)
        rec["memory"] = analysis.memory_summary(
            bundle.abstract_args, out, donated=bool(bundle.donate_argnums))
        rec["collectives_rolled"] = [vars(o) for o in r.collectives]
        rec["t_full_trace_s"] = round(time.time() - t0, 1)
        del bundle, out, r

    if cost_pass:
        U = api.scan_units(cfg)
        accums = (1, 2) if shape.kind == "train" else (None,)
        samples = {}
        with flags.unroll_scans():
            for u in (1, 2):
                for a in accums:
                    _, _, r = _trace(api.with_depth(cfg, u), shape, mesh,
                                     rules, accum=a, variant=variant)
                    cs = analysis.cost_summary(r)
                    coll = analysis.collective_bytes(r.collectives, cpp)
                    samples[(u, a)] = {**cs, "ici": coll["ici"],
                                       "dcn": coll["dcn"],
                                       "ici_eq": coll["ici_bf16eq"],
                                       "dcn_eq": coll["dcn_bf16eq"]}

        def extrap_u(key, a):
            """Linear in depth at fixed accumulation."""
            return analysis.extrapolate(samples[(1, a)][key],
                                        samples[(2, a)][key], U)

        def extrap(key, bilinear=False):
            if accums == (None,):
                return extrap_u(key, None)
            if not bilinear:
                # total FLOPs/bytes are accum-invariant (the global batch is
                # fixed; only its slicing changes): extrapolate over depth
                # at A=2 and keep
                return extrap_u(key, 2)
            # collectives DO scale with accum (per-microbatch FSDP gathers):
            # bilinear with non-negative increments
            A = steps.accum_for(cfg, shape)
            f11, f12 = samples[(1, 1)][key], samples[(2, 1)][key]
            f21, f22 = samples[(1, 2)][key], samples[(2, 2)][key]
            du = max(0.0, f12 - f11)
            da = max(0.0, f21 - f11)
            dau = max(0.0, f22 - f21 - f12 + f11)
            return f11 + (U - 1) * du + (A - 1) * da + (U - 1) * (A - 1) * dau

        flops_dev = extrap("flops")
        bytes_dev = extrap("bytes")
        coll = {"ici": max(0.0, extrap("ici", bilinear=True)),
                "dcn": max(0.0, extrap("dcn", bilinear=True))}
        coll["total"] = coll["ici"] + coll["dcn"]
        coll_eq = {"ici": max(0.0, extrap("ici_eq", bilinear=True)),
                   "dcn": max(0.0, extrap("dcn_eq", bilinear=True))}

        model_flops = model_flops_of(cfg, shape)
        rl = analysis.roofline(flops_dev, bytes_dev, coll, model_flops,
                               chips, hw)
        rec["roofline"] = {
            "compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "collective_s": rl.collective_s, "dcn_s": rl.dcn_s,
            "dominant": rl.dominant, "step_time_s": rl.step_time_s,
            "mfu": rl.mfu, "useful_frac": rl.useful_frac,
            "flops_per_device": flops_dev, "bytes_per_device": bytes_dev,
            "coll_ici_bytes": coll["ici"], "coll_dcn_bytes": coll["dcn"],
            "coll_ici_bf16eq": coll_eq["ici"], "coll_dcn_bf16eq": coll_eq["dcn"],
            "collective_bf16eq_s": (coll_eq["ici"] / hw.ici_bw
                                    + coll_eq["dcn"] / hw.dcn_bw),
            "model_flops": model_flops, "scan_units": U,
        }
        attach_adjusted_roofline(rec, cfg, shape, mesh, variant=variant,
                                 hw=hw)
    rec["t_total_s"] = round(time.time() - t0, 1)
    return rec


def model_flops_of(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D for a train cell, 2*N*D otherwise (N the active
    matmul parameters, D the tokens a step processes)."""
    n_active = api.count_matmul_params(cfg, active_only=True)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    factor = 6 if shape.kind == "train" else 2
    return factor * n_active * tokens


def attach_adjusted_roofline(rec: dict, cfg, shape, mesh=None,
                             mesh_shape=None, variant="baseline",
                             hw: HardwareSpec = H100):
    """Add the analytic-memory roofline terms (memory_adj_s, mfu_adj,
    dominant_adj) to a cell record, against ``hw``. Pure post-processing."""
    rl = rec.get("roofline")
    if not rl:
        return
    ms = mesh_shape or shd.mesh_shape(mesh)
    chips = rec["chips"]
    params_bytes = Pm.bytes_of(api.init_specs(cfg))
    cache_dev = 0.0
    if shape.kind == "decode":
        cache_dev = Pm.bytes_of(
            api.cache_specs(cfg, shape.global_batch, shape.seq_len)) / chips
    mem_adj = analysis.analytic_memory_bytes(
        cfg, shape, ms, steps.accum_for(cfg, shape, variant), shape.kind,
        params_bytes, cache_dev,
        remat=steps.VARIANTS.get(variant, {}).get("remat", True) is True)
    mem_adj_s = mem_adj / hw.hbm_bw
    coll_total = rl.get("collective_bf16eq_s",
                        rl["collective_s"] + rl["dcn_s"])
    step_adj = max(rl["compute_s"], mem_adj_s, coll_total)
    rl["memory_adj_bytes"] = mem_adj
    rl["memory_adj_s"] = mem_adj_s
    rl["step_time_adj_s"] = step_adj
    rl["mfu_adj"] = rl["model_flops"] / (
        chips * hw.peak_flops_bf16 * max(step_adj, 1e-12))
    terms = {"compute": rl["compute_s"], "memory": mem_adj_s,
             "collective": coll_total}
    rl["dominant_adj"] = max(terms, key=terms.get)


def cells(archs, shapes):
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            ok, why = shape_applicable(cfg, get_shape(s))
            yield a, s, ok, why


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--rules", default="baseline", choices=list(RULES))
    ap.add_argument("--variant", default="baseline",
                    choices=list(steps.VARIANTS))
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the shallow cost pass (multi-pod prove-out)")
    ap.add_argument("--no-full", action="store_true",
                    help="skip the full-depth pass (cost pass only)")
    args = ap.parse_args()

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = SHAPE_ORDER if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for multi in meshes:
        fake_world(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi)
        tag = mesh_tag(mesh)
        suffix = "" if args.rules == "baseline" else f"__{args.rules}"
        if args.variant != "baseline":
            suffix += f"__{args.variant}"
        outdir = Path(args.out) / (tag + suffix)
        outdir.mkdir(parents=True, exist_ok=True)
        for arch, shape_id, ok, why in cells(archs, shapes):
            path = outdir / f"{arch}__{shape_id}.json"
            if path.exists() and not args.force:
                print(f"[skip cached] {tag} {arch} {shape_id}")
                continue
            if not ok:
                path.write_text(json.dumps(
                    {"arch": arch, "shape": shape_id, "mesh": tag,
                     "status": "skipped", "reason": why}, indent=1))
                print(f"[skip n/a]    {tag} {arch} {shape_id}: {why}")
                continue
            print(f"[cell] {tag} {arch} {shape_id} ...", flush=True)
            try:
                rec = run_cell(arch, shape_id, mesh, args.rules,
                               cost_pass=not args.no_cost,
                               full_pass=not args.no_full,
                               variant=args.variant)
                rec["status"] = "ok"
            except Exception as e:  # noqa: BLE001 — record, keep sweeping
                rec = {"arch": arch, "shape": shape_id, "mesh": tag,
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]}
                failures.append((tag, arch, shape_id, repr(e)))
                print(f"  ERROR: {e!r}", flush=True)
            path.write_text(json.dumps(rec, indent=1))
            if rec.get("roofline"):
                r = rec["roofline"]
                print(f"  dominant={r['dominant']} step={r['step_time_s']:.6f}s "
                      f"mfu={r['mfu']:.4f} useful={r['useful_frac']:.2f} "
                      f"({rec['hardware']})", flush=True)
            if rec.get("memory"):
                m = rec["memory"]
                hbm = m["argument_bytes"] + m["output_bytes"] - \
                    m["alias_bytes"]
                print(f"  mem/device ~{hbm/2**30:.2f} GiB args+outputs "
                      f"(args {m['argument_bytes']/2**30:.2f} + out "
                      f"{m['output_bytes']/2**30:.2f} - alias "
                      f"{m['alias_bytes']/2**30:.2f}; temporaries not "
                      f"measured)", flush=True)

    print(f"\n{len(failures)} failures")
    for f in failures:
        print("  FAIL:", *f)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
