"""Port parity: training (loss, train step, AdamW state) at the smoke
configs of five families.

For ``qwen3-0.6b`` (dense), ``granite-moe-1b-a400m`` (MoE aux loss),
``rwkv6-3b`` (WKV6 on the ``ref`` route), ``recurrentgemma-9b`` (RG-LRU
scan, local attention) and ``whisper-tiny`` (``enc_frames`` in the
batch), one reference train state is carried across with
``convert.train_state`` and the same batches (the data pipeline's, bit
for bit the reference's) go through both packages' train steps on the
reference's default route (``attention_impl="blocked"``), all f32:

- the loss (rel 1e-5) and every gradient leaf: max abs difference
  within 1e-4 of the leaf's largest gradient (f32 sums taken in another
  order differ in the last bits, ~1e-6 relative);
- AdamW's ``m``, ``v`` (same bound, on their leaf's largest value) and
  the parameters after 1 and 3 steps. Early AdamW amplifies rounding:
  ``m/sqrt(v)`` is about ``sign(g)``, so an element whose gradient is
  near the rounding noise can move by ``lr`` one way in one package and
  the other way in the other. So every element is held to
  ``2 x (sum of the steps' lr)`` (the most two such moves can differ),
  and the elements whose step-1 gradient is above 1e-3 of their leaf's
  largest (three orders above the noise) to ``1e-3 x (sum of lr)``;
  step-3 moments to 1e-3 of their leaf's largest value (their inputs
  carry those moved elements);
- the step counter, the grad norm (rel 1e-5) and the learning rate.

Also: ``train()``'s per-step losses against the reference's ``train()``
(the decoder-only four, 5 steps; qwen3 at the 30 steps of
``test_system::test_training_reduces_loss``), ``accum_steps=2`` against
the reference's and against one full batch, ``remat="layer"`` against
``"none"`` bit for bit, the chunked cross-entropy against a plain one,
and the kernel route refused by the train step.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch import train as ref_launch  # noqa: E402
from repro.optim.adamw import AdamWConfig as RefAdamW  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import DataConfig, make_batch  # noqa: E402
from repro_torch.launch import train as port_launch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, schedule  # noqa: E402
from repro_torch.train import loss as PLoss  # noqa: E402
from repro_torch.train import step as PS  # noqa: E402

ARCHS = ("qwen3-0.6b", "granite-moe-1b-a400m", "rwkv6-3b",
         "recurrentgemma-9b", "whisper-tiny")
DECODER_ARCHS = ARCHS[:4]
B, S, S_ENC = 2, 32, 16
#: a warmup short enough that the three steps move the parameters
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
LOSS_REL = 1e-5
GRAD_REL = 1e-4
NOISE = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread per test process keeps the
    parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(cfg, n, seed=0):
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                      seed=seed)
    out = []
    rng = np.random.default_rng(100 + seed)
    for step in range(n):
        b = make_batch(dcfg, step)
        if cfg.is_enc_dec:
            b["enc_frames"] = rng.standard_normal(
                (B, S_ENC, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_run(arch):
    """The reference's train state at 0, 1 and 3 steps (numpy), its
    step-0 loss and gradients, and its per-step metrics: one jitted
    train step per architecture, shared by the tests."""
    rcfg = ref_smoke(arch)
    state = RS.init_train_state(jax.random.PRNGKey(0), rcfg)
    batches = _batches(rcfg, 3)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    loss0, grads0 = jax.jit(jax.value_and_grad(RS.loss_fn),
                            static_argnums=1)(state["params"], rcfg, jb[0])
    step = jax.jit(RS.make_train_step(rcfg, RefAdamW(**OPT)))
    states, metrics = [_np_tree(state)], []
    for b in jb:
        state, m = step(state, b)
        states.append(_np_tree(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"rcfg": rcfg, "batches": batches, "states": states,
            "loss0": float(loss0), "grads0": _np_tree(grads0),
            "metrics": metrics}


def _port_state(arch, **over):
    r = _ref_run(arch)
    cfg = dataclasses.replace(convert.model_config(r["rcfg"]), **over)
    return cfg, convert.train_state(r["states"][0], cfg, device="cpu")


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _by_name(ref_tree, cfg):
    """A reference tree shaped as the parameters, keyed by port names."""
    return {k: np.asarray(v, np.float32)
            for k, v in convert._port_leaves(ref_tree, cfg)}


def _leaf_err(got: torch.Tensor, want: np.ndarray) -> float:
    """Max abs difference over the leaf's largest magnitude."""
    diff = np.abs(got.detach().float().numpy() - want).max()
    return float(diff / max(np.abs(want).max(), 1e-30))


def _port_grads(cfg, state, batch):
    params = state["params"]
    params.zero_grad(set_to_none=True)
    loss = PS.loss_fn(params, cfg, _tensors(batch))
    loss.backward()
    grads = {k: p.grad.clone() for k, p in params.named_parameters()}
    params.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(arch):
    r = _ref_run(arch)
    cfg, state = _port_state(arch)
    loss, grads = _port_grads(cfg, state, r["batches"][0])
    assert abs(loss - r["loss0"]) <= LOSS_REL * abs(r["loss0"])
    want = _by_name(r["grads0"], cfg)
    assert set(want) == set(grads)
    worst = max(_leaf_err(grads[k], want[k]) for k in want)
    assert worst <= GRAD_REL, worst


def _lr_sum(metrics, n):
    return sum(m["lr"] for m in metrics[:n])


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_state_and_params_after_one_and_three_steps(arch):
    r = _ref_run(arch)
    cfg, state = _port_state(arch)
    step = PS.make_train_step(cfg, AdamWConfig(**OPT))
    g0 = _by_name(r["grads0"], cfg)
    for n, batch in enumerate(r["batches"], start=1):
        state, m = step(state, _tensors(batch))
        want_m = r["metrics"][n - 1]
        assert abs(float(m["loss"]) - want_m["loss"]) \
            <= LOSS_REL * abs(want_m["loss"]), n
        assert abs(float(m["grad_norm"]) - want_m["grad_norm"]) \
            <= LOSS_REL * want_m["grad_norm"], n
        assert float(m["lr"]) == pytest.approx(want_m["lr"], rel=1e-6)
        if n not in (1, 3):
            continue
        ref = r["states"][n]
        assert int(state["opt"]["step"]) == int(ref["opt"]["step"]) == n
        assert state["opt"]["step"].dtype == torch.int32
        mv_rel = GRAD_REL if n == 1 else NOISE
        for key in ("m", "v"):
            want = _by_name(ref["opt"][key], cfg)
            worst = max(_leaf_err(state["opt"][key][k], want[k])
                        for k in want)
            assert worst <= mv_rel, (n, key, worst)
        lr = _lr_sum(r["metrics"], n)
        want_p = _by_name(ref["params"], cfg)
        for k, p in state["params"].named_parameters():
            diff = np.abs(p.detach().numpy() - want_p[k])
            assert diff.max() <= 2 * lr + 1e-7, (n, k, diff.max())
            clear = np.abs(g0[k]) > NOISE * np.abs(g0[k]).max()
            if clear.any():
                assert diff[clear].max() <= NOISE * lr + 1e-7, \
                    (n, k, diff[clear].max(), lr)


def test_accumulation_matches_reference_and_one_full_batch():
    """accum_steps=2 against the reference's (lax.scan) and against one
    full batch of the port: the mean of two half-batch means is the full
    mean here (no pad labels), so loss rel 1e-5 and every leaf of ``m``
    (the clipped gradient, scaled) within 1e-4 of its largest."""
    arch = "qwen3-0.6b"
    r = _ref_run(arch)
    batch = r["batches"][0]
    ref_state = RS.init_train_state(jax.random.PRNGKey(0), r["rcfg"])
    ref_state, ref_m = jax.jit(RS.make_train_step(
        r["rcfg"], RefAdamW(**OPT), accum_steps=2))(
        ref_state, {k: jnp.asarray(v) for k, v in batch.items()})
    want = _by_name(_np_tree(ref_state["opt"]["m"]),
                    convert.model_config(r["rcfg"]))
    got = {}
    for accum in (2, 1):
        cfg, state = _port_state(arch)
        state, m = PS.make_train_step(cfg, AdamWConfig(**OPT), accum)(
            state, _tensors(batch))
        got[accum] = (float(m["loss"]), state["opt"]["m"])
    assert abs(got[2][0] - float(ref_m["loss"])) \
        <= LOSS_REL * abs(float(ref_m["loss"]))
    assert abs(got[2][0] - got[1][0]) <= LOSS_REL * abs(got[1][0])
    for k in want:
        assert _leaf_err(got[2][1][k], want[k]) <= GRAD_REL, k
        assert _leaf_err(got[2][1][k], got[1][1][k].numpy()) <= GRAD_REL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_layer_is_bit_equal_to_none(arch):
    """``remat="layer"`` recomputes each period in backward under
    ``torch.utils.checkpoint``: on the CPU the loss, every gradient and
    the updated parameters are bit for bit those of ``remat="none"``."""
    r = _ref_run(arch)
    batch = r["batches"][0]
    out = {}
    for remat in ("none", "layer"):
        cfg, state = _port_state(arch, remat=remat)
        loss, grads = _port_grads(cfg, state, batch)
        state, _ = PS.make_train_step(cfg, AdamWConfig(**OPT))(
            state, _tensors(batch))
        out[remat] = (loss, grads, dict(state["params"].named_parameters()))
    assert out["none"][0] == out["layer"][0]
    for k, g in out["none"][1].items():
        assert torch.equal(g, out["layer"][1][k]), k
        assert torch.equal(out["none"][2][k], out["layer"][2][k]), k


def test_remat_wraps_each_period_under_grad_only(monkeypatch):
    """The hybrid's periods (3 blocks) and its remainder layer: the
    forward under grad checkpoints each period once and leaves the
    remainder alone; without grad (inference) nothing is checkpointed."""
    rcfg = dataclasses.replace(ref_smoke("recurrentgemma-9b"), remat="layer",
                               n_layers=7)
    cfg = convert.model_config(rcfg)
    calls = []
    real = T.checkpoint

    def counted(fn, blocks, *a, **kw):
        calls.append(len(blocks))
        return real(fn, blocks, *a, **kw)
    monkeypatch.setattr(T, "checkpoint", counted)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    T.forward_hidden(params, cfg, tokens)
    assert calls == []                      # no parameter requires grad
    params.requires_grad_(True)
    with torch.no_grad():
        T.forward_hidden(params, cfg, tokens)
    assert calls == []
    T.forward_hidden(params, cfg, tokens)
    assert calls == [3, 3]


def test_chunked_cross_entropy_matches_plain():
    """Chunks of 16 (``chunk=20`` shrinks to a divisor of S=48), pad
    labels (-1) masked out, the padded vocab inside the log-sum-exp:
    the loss and its gradient with respect to ``h`` against
    ``F.cross_entropy`` over the whole (B, S, V) logits, rel 1e-6 (f32,
    other order of adds)."""
    cfg = dataclasses.replace(convert.model_config(ref_smoke("qwen3-0.6b")),
                              vocab_size=500)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(1),
                           device="cpu")
    rng = np.random.default_rng(0)
    h = torch.from_numpy(rng.standard_normal((2, 48, cfg.d_model))
                         .astype(np.float32)).requires_grad_(True)
    labels = rng.integers(0, cfg.vocab_size, (2, 48))
    labels[0, :5] = -1
    labels[1, -7:] = -1
    labels = torch.from_numpy(labels)
    got = PLoss.chunked_cross_entropy(params, cfg, h, labels, chunk=20)
    (g_got,) = torch.autograd.grad(got, h)
    logits = T.lm_logits(params, cfg, h)
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
        ignore_index=-1)
    (g_want,) = torch.autograd.grad(want, h)
    assert logits.shape[-1] == T.padded_vocab(cfg) > cfg.vocab_size
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-6 * abs(want)
    assert float((g_got - g_want).abs().max()) \
        <= 1e-6 * float(g_want.abs().max())


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_train_losses_match_reference_train(arch, monkeypatch):
    """``train()`` against the reference's ``train()`` from one state
    (the reference's seed-0 init, carried across): per-step losses over
    5 steps, rel 1e-5 (the default AdamW config: inside the warmup the
    learning rate is small, so the packages stay close)."""
    rcfg = ref_smoke(arch)
    cfg = convert.model_config(rcfg)
    _check_train_losses(rcfg, cfg, steps=5, batch=B, seq=S,
                        monkeypatch=monkeypatch, rel=LOSS_REL)


def _check_train_losses(rcfg, cfg, *, steps, batch, seq, monkeypatch, rel):
    start = RS.init_train_state(jax.random.PRNGKey(0), rcfg)
    monkeypatch.setattr(
        port_launch, "init_train_state",
        lambda cfg, generator, device: convert.train_state(
            _np_tree(start), cfg, device=device))
    _, want = ref_launch.train(rcfg, steps=steps, global_batch=batch,
                               seq_len=seq, log_every=1000)
    _, got = port_launch.train(cfg, steps=steps, global_batch=batch,
                               seq_len=seq, log_every=1000, device="cpu")
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, rtol=rel)
    return got


def test_thirty_step_losses_match_and_stay_in_warmup(monkeypatch):
    """``test_system::test_training_reduces_loss``'s run (qwen3 smoke, 30
    steps, B=4, T=64): the port's losses equal the reference's (rel 1e-4
    over 30 steps), so a failure of its 0.2 drop is the run's, not a
    package's. ``AdamWConfig(total_steps=30)`` keeps the default
    ``warmup_steps=100``: the learning rate never passes 0.3 x 3e-4."""
    rcfg = ref_smoke("qwen3-0.6b")
    cfg = convert.model_config(rcfg)
    _check_train_losses(rcfg, cfg, steps=30, batch=4, seq=64,
                        monkeypatch=monkeypatch, rel=1e-4)
    opt = AdamWConfig(total_steps=30)
    assert opt.warmup_steps == 100
    lr = schedule(opt, torch.tensor(30))
    assert float(lr) == pytest.approx(0.3 * opt.lr)


def test_short_warmup_meets_the_reference_loss_drop():
    """The same 30-step run with a 3-step warmup meets the 0.2 drop of
    the mean loss (first 5 against last 5 steps) that the default
    100-step warmup does not."""
    cfg = convert.model_config(ref_smoke("qwen3-0.6b"))
    _, losses = port_launch.train(
        cfg, steps=30, global_batch=4, seq_len=64, log_every=1000,
        opt=AdamWConfig(warmup_steps=3, total_steps=30), device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_kernel_route_refused_and_plain_routes_differentiate():
    """The train step refuses ``attention_impl="kernel"`` (its CUDA
    kernels have no backward); on the plain routes every parameter gets
    a finite gradient, the rwkv6 ``ref`` WKV6 included."""
    for arch in ("qwen3-0.6b", "rwkv6-3b"):
        cfg = convert.model_config(ref_smoke(arch))
        with pytest.raises(ValueError, match="no backward"):
            PS.make_train_step(dataclasses.replace(
                cfg, attention_impl="kernel"), AdamWConfig())
        with pytest.raises(ValueError, match="no backward"):
            port_launch.train(dataclasses.replace(
                cfg, attention_impl="kernel"), steps=1, global_batch=1,
                seq_len=8, device="cpu")
        for impl in ("blocked", "ref"):
            c = dataclasses.replace(cfg, attention_impl=impl)
            state = PS.init_train_state(
                c, generator=torch.Generator().manual_seed(0), device="cpu")
            _, grads = _port_grads(c, state, _batches(c, 1)[0])
            assert all(torch.isfinite(g).all() for g in grads.values())
            assert sum(int((g != 0).any()) for g in grads.values()) \
                == len(grads)
