"""Helpers of the port's multi-rank tests: code on gloo ranks, and the JAX
package on forced host devices, each in subprocesses of their own (a
process group, like JAX's device count, is global to a process). Every
run has its own time limit."""
import os
import subprocess
import sys
import textwrap
import uuid
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _env() -> dict:
    return {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
            "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu",
            "OMP_NUM_THREADS": "1", "TMPDIR": os.environ.get("TMPDIR",
                                                            "/tmp")}


def _check(r: subprocess.CompletedProcess) -> str:
    assert r.returncode == 0, f"stdout:\n{r.stdout[-6000:]}\n" \
        f"stderr:\n{r.stderr[-6000:]}"
    return r.stdout


def run_ranks(code: str, world: int, out: Path, timeout: float,
              prelude: str = "") -> str:
    """Run ``prelude`` and ``code`` (dedented), which defines ``run(rank,
    world, out)``, on ``world`` gloo ranks (``torch.multiprocessing.spawn``),
    each with its process group up; ``out`` is a directory the ranks write
    to, and the ranks meet through a file store there (no port to race
    for). Returns rank 0's printed output."""
    store = Path(out) / f"pg_store_{uuid.uuid4().hex}"
    prog = prelude + textwrap.dedent(code) + textwrap.dedent(f"""

    def _main(rank, world, out):
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group("gloo",
                                init_method={store.as_uri()!r},
                                rank=rank, world_size=world)
        try:
            run(rank, world, out)
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        import logging
        import torch.multiprocessing as mp
        logging.disable(logging.WARNING)
        mp.spawn(_main, args=({world}, {str(out)!r}), nprocs={world})
    """)
    script = Path(out) / "ranks.py"
    script.write_text(prog)
    return _check(subprocess.run([sys.executable, str(script)],
                                 capture_output=True, text=True,
                                 timeout=timeout, env=_env(), cwd=str(ROOT)))


def run_reference(code: str, devices: int, timeout: float,
                  prelude: str = "") -> str:
    """Run ``prelude`` and ``code`` (dedented) with the JAX package on
    ``devices`` forced host devices."""
    prog = ("import os\n"
            "os.environ['XLA_FLAGS'] = "
            f"'--xla_force_host_platform_device_count={devices}'\n"
            + prelude + textwrap.dedent(code))
    return _check(subprocess.run([sys.executable, "-c", prog],
                                 capture_output=True, text=True,
                                 timeout=timeout, env=_env(), cwd=str(ROOT)))
