"""Deterministic synthetic token pipeline with document packing: the port
of ``repro.data.pipeline``.

Every batch is a pure function of (seed, step), so a restart resumes
bit-identically without a data-state checkpoint. ``pack_documents`` and
``SyntheticLM.batch`` are the reference's numpy code, copied, and give the
same arrays; :meth:`SyntheticLM.device_batch` puts a batch on a device in
place of the reference's ``sharded_batch``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DataConfig", "SyntheticLM", "pack_documents"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # token distribution skew
    mean_doc_len: int = 512      # documents get packed to seq_len
    eos_id: int = 0


def pack_documents(docs: list[np.ndarray], seq_len: int, eos_id: int,
                   pad_id: int = 0) -> np.ndarray:
    """Greedy packing of variable-length documents into fixed rows; every
    document ends with EOS; rows are padded with ``pad_id``."""
    rows, cur = [], []
    for d in docs:
        d = np.concatenate([d, [eos_id]])
        while len(d) > 0:
            space = seq_len - len(cur)
            take = min(space, len(d))
            cur.extend(d[:take].tolist())
            d = d[take:]
            if len(cur) == seq_len:
                rows.append(cur)
                cur = []
    if cur:
        rows.append(cur + [pad_id] * (seq_len - len(cur)))
    return np.asarray(rows, dtype=np.int32)


class SyntheticLM:
    """Zipf-distributed documents with local n-gram structure (so the loss
    goes down during a training run)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _docs_for(self, rng: np.random.Generator, n_tokens: int) -> list[np.ndarray]:
        docs = []
        got = 0
        while got < n_tokens:
            ln = max(8, int(rng.exponential(self.cfg.mean_doc_len)))
            base = rng.zipf(self.cfg.zipf_a, size=ln) % (self.cfg.vocab - 2) + 1
            # inject bigram structure: token[i] often follows token[i-1]+1
            follow = rng.random(ln) < 0.5
            base[1:] = np.where(follow[1:], (base[:-1] + 1) % self.cfg.vocab,
                                base[1:])
            docs.append(base.astype(np.int32))
            got += ln + 1
        return docs

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Global batch for ``step``: {"tokens": [B, L], "labels": [B, L]}."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        need = c.global_batch * (c.seq_len + 1)
        rows = pack_documents(self._docs_for(rng, int(need * 1.1)),
                              c.seq_len + 1, c.eos_id)
        while rows.shape[0] < c.global_batch:
            rows = np.concatenate([rows, rows])
        rows = rows[: c.global_batch]
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def device_batch(self, step: int, device) -> dict[str, torch.Tensor]:
        """The global batch of ``step`` as int32 tensors on ``device`` (one
        card holds the whole batch)."""
        return {k: torch.from_numpy(v).to(device)
                for k, v in self.batch(step).items()}
