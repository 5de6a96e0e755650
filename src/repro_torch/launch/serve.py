"""Batched serving of the port: a continuous-batching decode loop.

The same scheduler as ``repro.launch.serve``: prefill a batch of prompts,
then decode all slots at one shared position; a slot that finishes (EOS or
the length budget) is refilled at once from the queue by a prefill of its
prompt tiled over the batch, and the slot's part of the result is merged
into the running cache. Reports prefill and per-token decode
latency/throughput, in the reference's dict.

A model with a frontend gets the reference's stub embeddings: ``[batch,
frontend_tokens, frontend_dim]`` standard normals from the request
generator (after the prompts), in bfloat16, passed to every prefill.

Two differences:

* the refill merges every per-slot tensor of the cache along its batch
  axis (``k``, ``v`` and ``pos`` of the attention layers and of a ``dec``
  layer's cross part, the RG-LRU, mLSTM and sLSTM states, the conv state),
  from a prefill into a fresh cache, so a refilled slot holds exactly a
  fresh prefill of its prompt. The reference merges only leaves with
  ``ndim >= 4`` along axis -4, which misses ``pos``, the RG-LRU and sLSTM
  states and the mLSTM stabiliser, and merges the conv state and the mLSTM
  normaliser along the group axis (ROADMAP Queue 3).
* a vision model decodes from position ``frontend_tokens + prompt_len``,
  past its patch prefix, and counts the prefix against ``cache_len``. The
  reference decodes from ``prompt_len``: its first step reuses the
  position of a prompt token, overwrites that token's cache slot and
  cannot see the last ``frontend_tokens`` prompt tokens (ROADMAP Queue 3).

Example (on the card; any config of ``repro_torch.configs``, e.g. also
``xlstm-350m``, ``seamless-m4t-large-v2`` or ``llava-next-34b``, whose
1,024 patches count against ``--cache-len``):
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --preset full --requests 8 --batch 4 \
        --prompt-len 3072 --max-new 32 --cache-len 4096
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.fabric import resolve_device
from ..models import build_model
from ..models.layers import AttnCache
from ..models.stacks import frontend_dim, prefix_len

__all__ = ["serve", "main", "merge_slot", "refill_slot", "cache_leaves"]


def cache_leaves(cache) -> list:
    """Every tensor of a cache (a list of per-layer entries: ``AttnCache``s
    and tuples of them or of tensors), in order."""
    if isinstance(cache, torch.Tensor):
        return [cache]
    if isinstance(cache, AttnCache):
        return [cache.k, cache.v, cache.pos]
    return [t for entry in cache for t in cache_leaves(entry)]


def merge_slot(cache, new_cache, s: int) -> None:
    """Copy slot ``s`` of every per-slot tensor of ``new_cache`` into
    ``cache``, in place: the batch is axis 0 of every one of them."""
    for a, b in zip(cache_leaves(cache), cache_leaves(new_cache),
                    strict=True):
        a[s] = b[s]


def refill_slot(model, params, cache, s: int, prompt, batch: int,
                cache_len: int, frontend_embeds=None):
    """Prefill ``prompt`` (tiled over the ``batch`` slots, into a fresh
    cache) and merge slot ``s`` of the result into ``cache``. Returns the
    slot's logits ``[1, V]`` for its first generated token."""
    dev = params.embed.device
    toks = torch.as_tensor(np.tile(prompt, (batch, 1)), device=dev)
    fresh = model.init_cache(batch, cache_len, dev,
                             enc_len=model.cfg.frontend_tokens or None)
    logits, new_cache = model.prefill(params, toks, fresh, frontend_embeds)
    merge_slot(cache, new_cache, s)
    return logits[s]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str = "olmo-1b", preset: str = "tiny", requests: int = 12,
          batch: int = 4, prompt_len: int = 32, max_new: int = 16,
          cache_len: int = 128, seed: int = 0, eos_id: int = 1,
          device=None) -> dict:
    """Serve ``requests`` random prompts of ``prompt_len`` tokens with
    ``batch`` slots, greedy decoding up to ``max_new`` tokens each. Random
    weights from ``seed``. CUDA unless ``device`` says otherwise."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if preset == "tiny":
        cfg = cfg.reduced(vocab=512)
    model = build_model(cfg)
    params = model.init(seed, dev)
    rng = np.random.default_rng(seed)
    queue = [rng.integers(2, cfg.vocab, size=prompt_len).astype(np.int32)
             for _ in range(requests)]
    fe = None
    if cfg.frontend is not None:
        fe = torch.tensor(rng.normal(size=(batch, cfg.frontend_tokens,
                                           frontend_dim(cfg))),
                          dtype=torch.float32, device=dev).to(torch.bfloat16)

    cache = model.init_cache(batch, cache_len, dev,
                             enc_len=cfg.frontend_tokens or None)
    lengths = np.zeros(batch, np.int64)      # generated tokens per slot
    active = np.zeros(batch, bool)
    done, t_prefill, t_decode, n_decoded = 0, 0.0, 0.0, 0

    def fill_slots(tok):
        nonlocal t_prefill
        for s in range(batch):
            if not active[s] and queue:
                prompt = queue.pop(0)
                t0 = time.time()
                logits = refill_slot(model, params, cache, s, prompt,
                                     batch, cache_len, fe)
                tok[s, 0] = logits[-1].argmax()
                _sync(dev)
                t_prefill += time.time() - t0
                active[s] = True
                lengths[s] = 0

    # initial batched prefill: all slots at once (the common fast path)
    first = [queue.pop(0) for _ in range(min(batch, len(queue)))]
    while len(first) < batch:
        first.append(np.zeros(prompt_len, np.int32))
    t0 = time.time()
    toks = torch.as_tensor(np.stack(first), device=dev)
    logits, cache = model.prefill(params, toks, cache, fe)
    tok = logits[:, -1].argmax(-1)[:, None]
    _sync(dev)
    t_prefill += time.time() - t0
    active[:] = True

    pos = prefix_len(cfg) + prompt_len
    while (done < requests and (active.any() or queue)) and pos < cache_len - 1:
        t0 = time.time()
        logits, cache = model.decode_step(params, tok, cache, pos)
        tok = logits[:, -1].argmax(-1)[:, None]
        last = tok[:, 0].cpu().numpy()       # waits for the step
        t_decode += time.time() - t0
        n_decoded += int(active.sum())
        pos += 1
        lengths[active] += 1
        finished = active & ((last == eos_id) | (lengths >= max_new))
        for s in np.nonzero(finished)[0]:
            active[s] = False
            done += 1
        if queue and (~active).any():
            fill_slots(tok)
    return {
        "requests_done": int(done),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tokens": int(n_decoded),
        "decode_tok_s": n_decoded / t_decode if t_decode else 0.0,
        "ms_per_token": 1e3 * t_decode / max(n_decoded, 1),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = serve(arch=args.arch, preset=args.preset, requests=args.requests,
                batch=args.batch, prompt_len=args.prompt_len,
                max_new=args.max_new, cache_len=args.cache_len,
                device=args.device)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
