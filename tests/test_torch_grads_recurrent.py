"""The port's gradients of ``loss_fn`` against ``jax.grad`` of the JAX
package's for mamba2's SSD, recurrentgemma's RG-LRU hybrid and whisper's
encoder-decoder (with ``frames``), on the CPU: the checks and tolerances
of ``tests/test_torch_grads.py``, whose helpers this file runs."""
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from test_torch_grads import check_family

RECURRENT = [a for a in ARCH_IDS
             if get_config(a, reduced=True).family in ("ssm", "hybrid",
                                                       "audio")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", RECURRENT)
def test_gradients_match_the_reference(arch):
    check_family(arch)


def test_the_recurrent_cases_cover_three_families():
    assert sorted(RECURRENT) == ["mamba2-2.7b", "recurrentgemma-2b",
                                 "whisper-small"]
