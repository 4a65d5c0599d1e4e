"""Batched serving driver with the ATA prefix cache.

The port of the reference's ``launch/serve.py``. Per request: probe the
replicated ATA block directory for the longest shared-prefix reuse (zero
probe traffic), resume from the deepest sealed cache snapshot and
teacher-force only the uncached suffix through ``decode_step``, seal a
cache snapshot into the *local* shard's pool at every block boundary,
then decode greedily.

Usage (on the CUDA card; ``--device cpu`` for a smoke run without one;
``--arch`` any decoder-only architecture of ``repro_torch.configs``):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --requests 32 --decode-steps 16 --policy ata
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.simulator import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serving.ref import (AtaCacheConfig, AtaPrefixCache,
                                     hash_blocks, synth_requests)


def _clone(cache: T.Cache) -> T.Cache:
    return [{k: t.clone() for k, t in layer.items()} for layer in cache]


class ModelServer:
    """One logical serving shard holding real model KV block payloads.

    The payloads are decode caches; a sealed snapshot and a resumed cache
    are copies, as in the reference, so nothing the directory holds
    changes under it. It serves decoder-only models: an encoder-decoder
    (``whisper-tiny``) needs encoder frames for its cache, which a
    request of tokens does not carry (the reference's server cannot make
    that cache either); it runs through ``forward`` and ``decode_step``."""

    def __init__(self, cfg, params: T.Transformer, ata: AtaPrefixCache,
                 shard: int, max_len: int = 512, *, device="cuda"):
        if cfg.is_enc_dec:
            raise ValueError(f"{cfg.name} is an encoder-decoder: ModelServer "
                             "serves decoder-only models; use forward and "
                             "decode_step with enc_frames")
        self.device = resolve_device(device)
        if params.embed.table.device.type != self.device.type:
            raise ValueError(f"params are on {params.embed.table.device}, "
                             f"the server runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.ata = ata
        self.shard = shard
        self.max_len = max_len

    def _token(self, t: int) -> torch.Tensor:
        return torch.tensor([[t]], dtype=torch.int32, device=self.device)

    def serve(self, tokens: np.ndarray, decode_steps: int
              ) -> Tuple[List[int], Dict[str, float]]:
        t0 = time.time()
        block = self.ata.cfg.block_tokens
        reused, payloads = self.ata.lookup_prefix(self.shard, tokens)
        # payloads hold a cache snapshot at each block boundary; resume
        # from the deepest one and recompute only the suffix.
        if reused and isinstance(payloads[-1], list):
            cache = _clone(payloads[-1])
            suffix = tokens[reused * block:]
        else:
            cache = T.init_cache(self.cfg, 1, self.max_len,
                                 device=self.device)
            suffix = tokens
            reused = 0
        for i, t in enumerate(suffix):
            _, cache = T.decode_step(self.params, self.cfg,
                                     self._token(int(t)), cache)
            # seal a block snapshot at block boundaries (local write rule)
            pos = reused * block + i + 1
            if pos % block == 0:
                h = int(hash_blocks(tokens[:pos], block)[-1])
                self.ata.pool_payload[self.shard][h] = _clone(cache)
        out = []
        last = self._token(int(tokens[-1]))
        for _ in range(decode_steps):
            logits, cache = T.decode_step(self.params, self.cfg, last, cache)
            nxt = int(torch.argmax(logits[0, -1]))
            out.append(nxt)
            last = self._token(nxt)
        return out, {"reused_blocks": reused,
                     "prefill_tokens": len(suffix),
                     "latency_s": time.time() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=[a for a in ARCH_IDS
                             if not get_config(a).is_enc_dec])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--policy", default="ata")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.cast_for_compute(
        T.init_params(cfg, generator=gen, device=device), cfg)
    acfg = AtaCacheConfig(n_shards=args.shards, block_tokens=16)
    ata = AtaPrefixCache(acfg, args.policy)
    servers = [ModelServer(cfg, params, ata, s, device=device)
               for s in range(args.shards)]
    reqs = synth_requests(args.requests, n_shards=args.shards,
                          vocab=cfg.vocab_size, shared_frac=0.7)
    tot_prefill = 0
    tot_reused = 0
    for shard, toks in reqs:
        _, m = servers[int(shard)].serve(np.asarray(toks),
                                         args.decode_steps)
        tot_prefill += m["prefill_tokens"]
        tot_reused += m["reused_blocks"] * acfg.block_tokens
    st = ata.stats
    print(f"[serve:{args.policy}] requests={args.requests} "
          f"prefill_tokens={tot_prefill} reused_tokens={tot_reused} "
          f"hit_rate={st.hit_rate:.3f} local={st.local_hits} "
          f"remote={st.remote_hits} probes={st.probe_messages}")


if __name__ == "__main__":
    main()
