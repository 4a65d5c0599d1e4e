"""Port parity: ``repro_torch.core.contention`` against the reference
``repro.core.contention``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import contention as ref  # noqa: E402
from repro_torch.core import contention as port  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one compile per shape instead of one per eager op
ref_group_rank = jax.jit(ref.group_rank, static_argnums=2)
ref_group_prefix_sum = jax.jit(ref.group_prefix_sum, static_argnums=3)


@pytest.mark.parametrize("R,K,p_mask", [(60, 30, 0.5), (120, 120, 0.9),
                                        (120, 24, 0.3), (7, 3, 1.0),
                                        (33, 1, 0.5), (0, 4, 0.5)])
def test_group_rank_matches_reference(R, K, p_mask):
    rng = np.random.default_rng(R * 131 + K)
    keys = rng.integers(0, K, R).astype(np.int32)
    mask = rng.random(R) < p_mask
    want = ref_group_rank(jnp.asarray(keys), jnp.asarray(mask), K)
    got = port.group_rank(torch.from_numpy(keys)[None],
                          torch.from_numpy(mask)[None], K)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_group_rank_arrival_order_and_batch_axis():
    keys = torch.tensor([[2, 0, 2, 2, 1, 2], [1, 1, 1, 0, 0, 1]])
    mask = torch.tensor([[True, True, False, True, True, True],
                         [True, False, True, True, True, True]])
    rank, size = port.group_rank(keys, mask, 3)
    assert rank.tolist() == [[0, 0, 0, 1, 0, 2], [0, 0, 1, 0, 1, 2]]
    assert size.tolist() == [[3, 1, 0, 3, 1, 3], [3, 0, 3, 2, 2, 3]]


@pytest.mark.parametrize("R,K,dyadic", [(60, 30, True), (120, 10, True),
                                        (120, 10, False), (5, 2, True)])
def test_group_prefix_sum_matches_reference(R, K, dyadic):
    rng = np.random.default_rng(R + K)
    keys = rng.integers(0, K, R).astype(np.int32)
    mask = rng.random(R) < 0.7
    if dyadic:   # flit counts: every partial sum is exact in float32
        values = rng.integers(0, 9, R).astype(np.float32) * 4.0
    else:
        values = rng.random(R).astype(np.float32) * 7.0
    want = ref_group_prefix_sum(jnp.asarray(keys), jnp.asarray(values),
                                jnp.asarray(mask), K)
    got = port.group_prefix_sum(torch.from_numpy(keys)[None],
                                torch.from_numpy(values)[None],
                                torch.from_numpy(mask)[None], K)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        if dyadic:
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
        else:
            # the two cumulative sums may associate differently; float32
            # partial sums of <= 120 values in [0, 7) stay within 1e-5
            np.testing.assert_allclose(g[0].numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)
