"""Gradient accumulation at a global batch that does not split over the dp
ranks: batch 4 in two micro-batches of 2 on ``(data=8, model=1)``, each
replicated on every rank, against the reference's ``jit_train_step`` in
every fsdp_mode (the limits of ``tests/test_torch_replicated_batch.py``,
whose helpers run it; a file of its own so that its reference subprocess
runs beside that file's)."""
import pytest

from test_torch_replicated_batch import MODES, assert_train_matches_jax, make_case
from test_torch_support import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def case():
    return make_case(("dp8_accum",), serve=False)


@pytest.mark.parametrize("mode", MODES)
def test_replicated_accum_matches_jax(case, mode):
    assert_train_matches_jax(case, "dp8_accum", mode)
