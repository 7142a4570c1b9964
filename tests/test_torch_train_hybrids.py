"""Training's loss and gradients of the hybrid and recurrent families,
jamba-v0.1 (MoE capacity = expert count) and xlstm-350m, against
``repro``'s on the CPU: tests/test_torch_train_families.py's check, in a
file of its own so that each file's jax compiles stay short."""
import pytest

from test_torch_train_families import check_loss_and_grads


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_hybrid_loss_and_grads_match_repro(arch):
    check_loss_and_grads(arch)
