"""``escn_batched_loss`` of escn-test-gate (the gate edge activation and
its per-block MoLE gate banks; the JAX package's plain edge path in both
packages, K2's plain version in the port) against JAX's on the CPU, with
JAX's weights carried across: loss rel 1e-5, every gradient leaf within
1e-4 of its max|g| (float32 both sides, JAX with x64 off). A file of its
own so that its JAX compile runs beside escn-test's in
``tests/test_torch_train_ranks.py``."""

from test_torch_train import check_escn_loss, jax_escn_loss, np_batch


def test_escn_gate_loss_and_gradients_match_jax():
    b = np_batch(3, B=2)
    check_escn_loss("escn-test-gate", b,
                    *jax_escn_loss("escn-test-gate", b))
