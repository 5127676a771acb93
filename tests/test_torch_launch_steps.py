"""The port's built steps on a 4 x 2 gloo mesh against the reference's
compiled steps on ``make_host_mesh((4, 2))`` (8 forced host devices), on
the same parameters and inputs, for the reduced configs of olmo-1b,
qwen2-moe-a2.7b and mamba2-2.7b with the shape cut of
``tests/test_distributed.py`` (global batch 8, S 256, accum 2); this
file holds olmo-1b, ``test_torch_launch_steps_moe.py`` and ``_ssm.py``
the other two (``tests/torch_steps.py`` runs both sides):

- every abstract argument's placements are the reference's
  ``PartitionSpec`` (the port's modules stacked back with ``.tree()``: a
  layer's placement is the stacked spec's without the layer dims);
- train, one step of AdamW with no warmup (lr 5e-3 at step 0: Adam's
  first update is about lr * sign(g) an entry, some 40 bf16 ulps of a
  weight near 0.02): the loss within 1e-4 relative (an fp32 reduction
  over bf16 logits); ``grad_norm``, the norm of a bf16 gradient, within
  2e-2 of itself, the bound ``tests/test_torch_grads.py`` holds a whole
  bf16 gradient to (2.6e-4 seen, mamba2); the optimizer's step count
  exactly; each fp32 moment m, and v through its square root, within
  0.15 of its own L2 norm (6.2e-2 seen, qwen2-moe's experts, where a
  near-tied router sends a few tokens elsewhere); each parameter's
  update p_new - p_old within 0.5 of its L2 norm (0.29 seen, qwen2-moe's
  router: where |g| is at bf16's noise, Adam's sign-like step flips);
  every updated parameter within rtol = atol = 2e-2 (bf16, as the
  models' tests). A missing update or moment is off by 1 of its norm,
  and a gradient off by a factor of 2 puts m and sqrt(v) off by at
  least 0.5 of theirs;
- prefill and decode: logits within rtol = atol = 2e-2.

Both sides shard the same bf16 products differently (GSPMD's partial sums
against DTensor's), so values agree to bf16's rounding, not bitwise.
"""
from torch_steps import check_steps


def test_built_steps_match_the_reference_compiled_steps(tmp_path):
    check_steps(tmp_path, "olmo-1b")
