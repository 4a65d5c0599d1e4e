"""Port parity: the checkpoint store.

- a round trip of f32, bf16, int32 and bool leaves (nested dicts, a list,
  a module's parameters), bit for bit, each leaf in its dtype;
- ``latest_step`` and a stale ``.tmp_step_*`` (a save that died) staying
  invisible;
- kill-and-resume through ``train()``: a run stopped at step 4 and
  resumed to 8 gives the uninterrupted run's losses and final state bit
  for bit on the CPU;
- a directory the reference's ``CheckpointStore`` wrote restores in the
  port bit for bit, its bf16 leaf included (stored as uint16 without
  ``ml_dtypes``), and a directory the port wrote restores in the
  reference.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointStore as RefStore  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32),
                  "n": rng.integers(-9, 9, (2, 2)).astype(np.int32)},
            "s": np.int32(42),
            "l": [rng.random(4) < 0.5, rng.standard_normal(2).astype(
                np.float32)]}


def _torch_tree(arr, bf16_key="c"):
    def conv(k, v):
        t = torch.from_numpy(np.array(v))
        return t.bfloat16() if k == bf16_key else t
    return {"a": conv("a", arr["a"]),
            "b": {k: conv(k, v) for k, v in arr["b"].items()},
            "s": conv("s", arr["s"]),
            "l": [conv("l0", arr["l"][0]), conv("l1", arr["l"][1])]}


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _assert_same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        for g, w in zip(got, want, strict=True):
            _assert_same(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_round_trip_every_dtype_and_a_module(tmp_path):
    store = CheckpointStore(tmp_path)
    tree = _torch_tree(_arrays())
    lin = torch.nn.Linear(3, 2).bfloat16()
    lin.requires_grad_(False)
    store.save(10, {"tree": tree, "model": lin}, wait=True)
    like = {"tree": {"a": torch.zeros(3, 5), "b": {
        "c": torch.zeros(7, dtype=torch.bfloat16),
        "n": torch.zeros(2, 2, dtype=torch.int32)},
        "s": torch.zeros((), dtype=torch.int32),
        "l": [torch.zeros(4, dtype=torch.bool), torch.zeros(2)]},
        "model": torch.nn.Linear(3, 2)}
    like["model"].requires_grad_(False)
    out, step = store.restore(like)
    assert step == 10
    _assert_same(out["tree"], tree)
    assert out["model"] is not like["model"]
    for (k, p), (_, q) in zip(out["model"].named_parameters(),
                              lin.named_parameters()):
        assert p.dtype == torch.bfloat16 and not p.requires_grad
        assert torch.equal(p, q), k
    manifest = json.loads((tmp_path / "step_00000010" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["tree/b/c"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_00000010" /
                   manifest["leaves"]["tree/b/c"]["file"]).dtype == np.uint16


def test_latest_step_ignores_a_stale_tmp(tmp_path):
    store = CheckpointStore(tmp_path)
    assert store.latest_step() is None
    with pytest.raises(FileNotFoundError):
        store.restore({"w": torch.zeros(2)})
    store.save(1, {"w": torch.ones(2)}, wait=True)
    store.save(3, {"w": torch.full((2,), 3.0)})
    store.wait()
    (tmp_path / ".tmp_step_00000007").mkdir()     # a save that died
    assert store.latest_step() == 3
    out, step = store.restore({"w": torch.zeros(2)}, step=1)
    assert step == 1 and torch.equal(out["w"], torch.ones(2))
    with pytest.raises(KeyError, match="missing leaf"):
        store.restore({"w": torch.zeros(2), "x": torch.zeros(1)})


def test_kill_and_resume_through_train_is_bit_exact(tmp_path):
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                              attention_impl="blocked")
    kw = dict(global_batch=2, seq_len=32, ckpt_every=4, log_every=100,
              device="cpu")
    full_state, full = train(cfg, steps=8, ckpt_dir=str(tmp_path / "a"),
                             **kw)
    # a failure at step 4: train to 4, then resume to 8
    train(cfg, steps=4, ckpt_dir=str(tmp_path / "b"), **kw)
    state, resumed = train(cfg, steps=8, ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed == full[4:]
    assert int(state["opt"]["step"]) == 8
    for (k, p), (_, q) in zip(state["params"].named_parameters(),
                              full_state["params"].named_parameters()):
        assert p.requires_grad and torch.equal(p, q), k
    for key in ("m", "v"):
        for k, t in state["opt"][key].items():
            assert torch.equal(t, full_state["opt"][key][k]), (key, k)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    arr = _arrays(1)
    ref_tree = jax.tree.map(jnp.asarray, arr)
    ref_tree["b"]["c"] = ref_tree["b"]["c"].astype(jnp.bfloat16)
    RefStore(tmp_path).save(5, ref_tree, wait=True)
    like = jax.tree.map(lambda x: torch.zeros(np.shape(x)), arr)
    out, step = CheckpointStore(tmp_path).restore(like)
    assert step == 5
    want = _torch_tree(arr)
    _assert_same(out, want)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    arr = _arrays(2)
    tree = _torch_tree(arr)
    CheckpointStore(tmp_path).save(6, tree, wait=True)
    like = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, arr))
    out, step = RefStore(tmp_path).restore(like)
    assert step == 6
    assert out["b"]["c"].dtype == jnp.bfloat16
    want_c = np.asarray(tree["b"]["c"].view(torch.int16).numpy())
    np.testing.assert_array_equal(
        np.asarray(out["b"]["c"]).view(np.int16), want_c)
    for path in (("a",), ("b", "n"), ("s",)):
        got, w = out, arr
        for k in path:
            got, w = got[k], w[k]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(w))
    np.testing.assert_array_equal(np.asarray(out["l"][0]), arr["l"][0])
