"""Port parity: the ATA prefix-cache ``ModelServer`` over the LM.

The port's server and the reference's serve the same requests with the
same weights (carried across with ``convert.params``) for the smoke
models of every decoder-only architecture (all but ``whisper-tiny``,
whose cache needs encoder frames that neither server is given): the
greedy tokens, the
per-request ``reused_blocks`` and ``prefill_tokens``, and the directory's
``ata.stats`` must be equal. The two serving claims of
``tests/test_system.py`` hold in the port, and the CLI prints the
reference's summary line.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serving import ref as ref_cache  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import ref as port_cache  # noqa: E402

#: every architecture the server takes
SERVED = tuple(a for a in ARCH_IDS if not get_smoke_config(a).is_enc_dec)
STATS = ("local_hits", "remote_hits", "recomputed_blocks", "probe_messages",
         "remote_fetch_blocks", "directory_sync_entries")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: one intra-op thread per test process keeps
    the parallel test workers from oversubscribing the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch):
    rcfg = ref_smoke(arch)
    rparams = RT.init_params(jax.random.PRNGKey(0), rcfg)
    cfg = convert.model_config(rcfg)
    return rcfg, rparams, cfg, convert.params(rparams, cfg, device="cpu")


@pytest.mark.parametrize("arch", SERVED)
def test_model_server_matches_reference(arch):
    rcfg, rparams, cfg, params = _models(arch)
    shards, block = 2, 8
    reqs = port_cache.synth_requests(
        6, n_shards=shards, vocab=cfg.vocab_size, n_prefixes=2,
        prefix_blocks=3, unique_blocks=1, block=block, shared_frac=0.7)
    ref_ata = ref_cache.AtaPrefixCache(
        ref_cache.AtaCacheConfig(n_shards=shards, block_tokens=block), "ata")
    ata = port_cache.AtaPrefixCache(
        port_cache.AtaCacheConfig(n_shards=shards, block_tokens=block), "ata")
    ref_srv = [ref_serve.ModelServer(rcfg, rparams, ref_ata, s, max_len=48)
               for s in range(shards)]
    srv = [serve.ModelServer(cfg, params, ata, s, max_len=48, device="cpu")
           for s in range(shards)]
    for shard, toks in reqs:
        want, wm = ref_srv[int(shard)].serve(np.asarray(toks), 4)
        got, m = srv[int(shard)].serve(np.asarray(toks), 4)
        assert got == want
        assert (m["reused_blocks"], m["prefill_tokens"]) == (
            wm["reused_blocks"], wm["prefill_tokens"])
    for f in STATS:
        assert getattr(ata.stats, f) == getattr(ref_ata.stats, f), f
    np.testing.assert_array_equal(ata.stats.shard_load,
                                  ref_ata.stats.shard_load)
    assert ata.stats.remote_hits > 0 and ata.stats.local_hits > 0
    # what the server sealed are cache snapshots of the run's layers
    sealed = [p for pool in ata.pool_payload for p in pool.values()
              if isinstance(p, list)]
    assert sealed and all(len(p) == cfg.n_layers for p in sealed)


def test_serve_ata_prefix_reuse_saves_prefill():
    """Two requests sharing a prefix: the second's prefill is shorter."""
    cfg = get_smoke_config("qwen3-0.6b")
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    ata = port_cache.AtaPrefixCache(
        port_cache.AtaCacheConfig(n_shards=2, block_tokens=8), "ata")
    srv = [serve.ModelServer(cfg, params, ata, s, max_len=128, device="cpu")
           for s in (0, 1)]
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab_size, 32)
    r1 = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 8)])
    r2 = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 8)])
    _, m1 = srv[0].serve(r1, decode_steps=2)
    _, m2 = srv[1].serve(r2, decode_steps=2)      # other shard!
    assert m1["reused_blocks"] == 0
    assert m2["reused_blocks"] >= 3               # prefix fetched remotely
    assert m2["prefill_tokens"] < m1["prefill_tokens"]
    assert ata.stats.probe_messages == 0


@pytest.mark.parametrize("arch", SERVED)
def test_serve_reuse_preserves_tokens(arch):
    """Decode after ATA prefix reuse == decode after full prefill, and
    serving leaves the sealed snapshots as they were sealed."""
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 16)
    req = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, 8)])
    ata = port_cache.AtaPrefixCache(
        port_cache.AtaCacheConfig(n_shards=1, block_tokens=8), "ata")
    srv = serve.ModelServer(cfg, params, ata, 0, max_len=64, device="cpu")
    out_cold, _ = srv.serve(req, decode_steps=4)
    sealed = {h: [{k: t.clone() for k, t in layer.items()} for layer in p]
              for h, p in ata.pool_payload[0].items()}
    out_warm, m = srv.serve(req, decode_steps=4)   # full prefix reuse
    assert m["reused_blocks"] >= 2
    assert out_cold == out_warm
    for h, snap in sealed.items():
        for a, b in zip(snap, ata.pool_payload[0][h]):
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_cli_prints_the_reference_summary(monkeypatch, capsys):
    """The summary line counts directory events only, so it does not
    depend on the weights: the two packages print the same line."""
    args = ["--arch", "rwkv6-3b", "--smoke", "--requests", "3",
            "--decode-steps", "2", "--shards", "2"]
    monkeypatch.setattr("sys.argv", ["serve"] + args)
    ref_serve.main()
    want = capsys.readouterr().out
    serve.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and got.startswith("[serve:ata] requests=3 ")


def test_server_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "qwen3-0.6b", "--smoke"])
    cfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"))
    params = T.init_params(cfg, generator=torch.Generator(), device="cpu")
    ata = port_cache.AtaPrefixCache(port_cache.AtaCacheConfig(n_shards=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.ModelServer(cfg, params, ata, 0)
    with pytest.raises(ValueError, match="params are on cpu"):
        serve.ModelServer(cfg, params, ata, 0, device="meta")


def test_cli_takes_every_decoder_only_arch():
    """``--arch`` takes the nine decoder-only architectures; the
    encoder-decoder, whose cache needs encoder frames, is refused."""
    assert len(SERVED) == len(ARCH_IDS) - 1
    with pytest.raises(SystemExit):
        serve.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu"])
