"""``tests/test_torch_launch_steps.py``'s comparison for qwen2-moe-a2.7b's
reduced config (its own file, so that the three run in parallel)."""
from torch_steps import check_steps


def test_built_steps_match_the_reference_compiled_steps(tmp_path):
    check_steps(tmp_path, "qwen2-moe-a2.7b")
