"""Port parity: the data pipeline, AdamW and int8 error-feedback
compression against the reference, and the reference's substrate tests
(``tests/test_substrate.py``) on the port.

- ``make_batch`` bit for bit for several (seed, step, shard);
- ``schedule`` at warmup, peak, cosine and past the end (rel 1e-6: one
  f32 ``cos`` may differ by an ulp);
- ``apply_updates`` on random trees, with and without clipping: the
  grad norm and lr (rel 1e-6), ``m`` and ``v`` (rel 1e-6 of each leaf's
  largest value) and the parameters after 1 and 4 steps (within 1e-6 of
  the parameter's scale plus ``2 x lr`` where the gradient is within
  1e-5 of its leaf's largest of zero, see ``test_torch_train.py``);
- ``compress``, ``decompress`` and ``ef_compress_tree`` bit for bit
  (both round half to even);
- quadratic convergence, the warmup/cosine values, the clip bound and
  error feedback, as the reference's own tests check them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import DataConfig as RefData  # noqa: E402
from repro.data import make_batch as ref_batch  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.optim import compression as RC  # noqa: E402
from repro_torch.data import DataConfig, iterate, make_batch  # noqa: E402
from repro_torch.optim import adamw as PA  # noqa: E402
from repro_torch.optim import compression as PC  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,step,n_shards,shard", [
    (0, 0, 1, 0), (0, 7, 1, 0), (3, 123, 1, 0), (0, 5, 4, 2), (11, 2, 2, 1)])
def test_make_batch_bit_equal_to_reference(seed, step, n_shards, shard):
    kw = dict(vocab_size=1000, seq_len=24, global_batch=8, seed=seed,
              n_shards=n_shards, shard=shard)
    got, want = make_batch(DataConfig(**kw), step), ref_batch(RefData(**kw),
                                                              step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_data_deterministic_stateless_and_sharded():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=8)
    b1, b2, b3 = make_batch(cfg, 7), make_batch(cfg, 7), make_batch(cfg, 8)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    parts = [make_batch(DataConfig(vocab_size=100, seq_len=16,
                                   global_batch=8, n_shards=4, shard=s),
                        3)["tokens"] for s in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts),
                                  make_batch(cfg, 3)["tokens"])
    it = iterate(cfg, start_step=7)
    np.testing.assert_array_equal(next(it)["tokens"], b1["tokens"])
    np.testing.assert_array_equal(next(it)["tokens"], b3["tokens"])


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
OPTS = [dict(lr=1e-2, warmup_steps=2, total_steps=10),
        dict(lr=1e-2, warmup_steps=0, total_steps=5, clip_norm=0.05,
             weight_decay=0.0),
        dict()]


@pytest.mark.parametrize("kw", OPTS)
def test_schedule_matches_reference(kw):
    rc, pc = RA.AdamWConfig(**kw), PA.AdamWConfig(**kw)
    for step in (0, 1, 2, 3, 5, 10, 99, 100, 101, 5000, 10000, 20000):
        want = float(RA.schedule(rc, jnp.int32(step)))
        got = float(PA.schedule(pc, torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def _tree(rng, scale=1.0):
    return {"a": (scale * rng.standard_normal((4, 6))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal((5,))).astype(
                np.float32)},
            "d": (scale * rng.standard_normal((2, 3, 2))).astype(np.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("kw", OPTS[:2])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_updates_matches_reference(kw, seed):
    rng = np.random.default_rng(seed)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(4)]
    rc, pc = RA.AdamWConfig(**kw), PA.AdamWConfig(**kw)
    rp = jax.tree.map(jnp.asarray, p0)
    ropt = RA.init_opt_state(rp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in _flat(p0).items()}
    popt = PA.init_opt_state(pp)
    lr_sum = 0.0
    for n, g in enumerate(grads, start=1):
        rp, ropt, rm = RA.apply_updates(rc, rp, jax.tree.map(jnp.asarray, g),
                                        ropt)
        pg = {k: torch.from_numpy(v) for k, v in _flat(g).items()}
        pp, popt, pm = PA.apply_updates(pc, pp, pg, popt)
        assert float(pm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert int(popt["step"]) == int(ropt["step"]) == n
        assert popt["step"].dtype == torch.int32
        lr_sum += float(rm["lr"])
        for key in ("m", "v"):
            want = _flat(jax.tree.map(np.asarray, ropt[key]))
            for k, w in want.items():
                err = np.abs(popt[key][k].numpy() - w).max()
                assert err <= 1e-6 * np.abs(w).max() + 1e-30, (n, key, k)
        want_p = _flat(jax.tree.map(np.asarray, rp))
        g1 = _flat(grads[0])
        for k, w in want_p.items():
            diff = np.abs(pp[k].numpy() - w)
            clear = np.abs(g1[k]) > 1e-5 * np.abs(g1[k]).max()
            assert diff[clear].max() <= 1e-6 * (1 + np.abs(w).max()), (n, k)
            assert diff.max() <= 2 * lr_sum + 1e-6, (n, k)


def test_adamw_converges_on_quadratic():
    cfg = PA.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                         total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = PA.init_opt_state(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}        # d/dw of w^2
        params, opt, _ = PA.apply_updates(cfg, params, grads, opt)
    assert float(params["w"].abs().max()) < 0.1


def test_schedule_warmup_and_cosine():
    cfg = PA.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                         min_lr_frac=0.1)
    assert float(PA.schedule(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(PA.schedule(cfg, torch.tensor(10))) == pytest.approx(
        1.0, rel=1e-2)
    assert float(PA.schedule(cfg, torch.tensor(100))) == pytest.approx(
        0.1, rel=1e-2)


def test_grad_clip_bounds_update():
    """A huge gradient is reported unclipped, and the step it takes is
    the clipped one: the first step moves each element by about lr."""
    cfg = PA.AdamWConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros((3,))}
    opt = PA.init_opt_state(params)
    huge = {"w": torch.tensor([1e6, 1e6, 1e6])}
    params, opt, metrics = PA.apply_updates(cfg, params, huge, opt)
    assert float(metrics["grad_norm"]) > 1e5
    assert float(opt["m"]["w"].abs().max()) <= 0.1 * cfg.clip_norm
    assert float(params["w"].abs().max()) <= cfg.lr * (1 + 1e-6)


def test_apply_updates_on_a_module_in_place():
    """A module's named parameters are the tree; the update is written
    into them in place, in their dtype."""
    lin = torch.nn.Linear(3, 2)
    before = {k: p.detach().clone() for k, p in lin.named_parameters()}
    opt = PA.init_opt_state(lin)
    assert set(opt["m"]) == {"weight", "bias"}
    grads = {k: torch.ones_like(p) for k, p in lin.named_parameters()}
    out, opt, _ = PA.apply_updates(PA.AdamWConfig(warmup_steps=0), lin,
                                   grads, opt)
    assert out is lin
    for k, p in lin.named_parameters():
        assert not torch.equal(p, before[k])


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_and_ef_tree_bit_equal_to_reference(seed):
    rng = np.random.default_rng(seed)
    g = {"a": rng.standard_normal((7, 5)).astype(np.float32),
         "b": (1e-3 * rng.standard_normal(33)).astype(np.float32),
         # exact halves of the quantization step: round half to even
         "h": np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)}
    e = {k: (0.01 * rng.standard_normal(v.shape)).astype(np.float32)
         for k, v in g.items()}
    e["h"] = np.zeros(6, np.float32)
    rq, rs, re = RC.ef_compress_tree({k: jnp.asarray(v) for k, v in g.items()},
                                     {k: jnp.asarray(v) for k, v in e.items()})
    pq, ps, pe = PC.ef_compress_tree(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in e.items()})
    for k in g:
        assert pq[k].dtype == torch.int8
        np.testing.assert_array_equal(pq[k].numpy(), np.asarray(rq[k]))
        assert float(ps[k]) == float(rs[k])
        np.testing.assert_array_equal(pe[k].numpy(), np.asarray(re[k]))
        np.testing.assert_array_equal(
            PC.decompress(pq[k], ps[k]).numpy(),
            np.asarray(RC.decompress(rq[k], rs[k])))
    zeros = PC.init_error_buffers({k: torch.from_numpy(v)
                                   for k, v in g.items()})
    assert all(z.dtype == torch.float32 and not z.any()
               for z in zeros.values())


def test_error_feedback_accumulates_small_grads():
    """Signals smaller than one quantization step still flow through over
    time thanks to error feedback."""
    g = torch.full((8,), 0.001)
    g[0] = 1.0                             # sets scale ~ 1/127
    err = PC.init_error_buffers({"g": g})["g"]
    total = torch.zeros_like(g)
    for _ in range(50):
        q, s, err = PC.compress(g, err)
        total = total + PC.decompress(q, s)
    mean_small = float(total[1:].mean()) / 50
    assert abs(mean_small - 0.001) < 2e-4
