"""Inputs made from the seed: the weights and the token batches.

Both sides of the check get the same raw tensors from here: the program
through its driver, which lays them out as the program wants them, and the
reference, which reads them as they are. Each weight leaf has a generator
of its own, seeded from the run's seed and the leaf's name, so a leaf can
be drawn again alone (the change of the parameters is read against a fresh
draw of the start) and a seed gives the same numbers on every run.
"""

from __future__ import annotations

import hashlib

import torch


def derive(seed: int, *names: object) -> int:
    """A 63-bit generator seed from the run's seed and ``names``; any whole
    seed works, negative or above 2**63 too."""
    text = "/".join([str(int(seed)), *map(str, names)])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little") >> 1


def dense_lm_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """The raw leaves of a dense decoder LM with tied embeddings, by path,
    each layer's leaves stacked along a leading layer dim."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // h
    ff, v = cfg["intermediate_size"], cfg["vocab_size"]
    return {
        "embedding": (v, d),
        "layers/attn/wk": (L, d, hkv, hd),
        "layers/attn/wo": (L, h, hd, d),
        "layers/attn/wq": (L, d, h, hd),
        "layers/attn/wv": (L, d, hkv, hd),
        "layers/ln_attn": (L, d),
        "layers/ln_mlp": (L, d),
        "layers/mlp/w_down": (L, ff, d),
        "layers/mlp/w_gate": (L, d, ff),
        "layers/mlp/w_up": (L, d, ff),
        "ln_final": (d,),
    }


def draw_leaf(cfg: dict, seed: int, path: str, shape: tuple[int, ...],
              device: torch.device | str) -> torch.Tensor:
    """One leaf in float32 on ``device``: ones for a norm's weight, else
    normal with the configuration's ``initializer_range`` as its std, in
    one call on a generator of the leaf's own."""
    if path.rsplit("/", 1)[-1].startswith("ln_"):
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights", path))
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.normal_(0.0, cfg["initializer_range"], generator=gen)


def raw_weights(cfg: dict, seed: int, device: torch.device | str
                ) -> dict[str, torch.Tensor]:
    return {path: draw_leaf(cfg, seed, path, shape, device)
            for path, shape in dense_lm_shapes(cfg).items()}


def layer_norms(path: str, t: torch.Tensor) -> dict[str, float]:
    """The float32 norm of each layer's slice of a leaf under ``layers/``
    (stacked along its first dim; keys ``path[i]``), or of the whole
    leaf."""
    if not path.startswith("layers/"):
        return {path: float(t.float().norm())}
    norms = t.float().flatten(1).norm(dim=1).tolist()
    return {f"{path}[{i}]": n for i, n in enumerate(norms)}


class Feed:
    """Token batches of ``rows`` x ``seq`` ids uniform over the vocabulary,
    each drawn on the device one batch ahead of its use; ``labels`` are the
    next ids. The same seed gives the same sequence of batches."""

    def __init__(self, seed: int, rows: int, seq: int, vocab: int,
                 device: torch.device | str):
        self.rows, self.seq, self.vocab = rows, seq, vocab
        self.device = device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(derive(seed, "tokens"))
        self._next = self._draw()

    def _draw(self) -> dict[str, torch.Tensor]:
        ids = torch.randint(0, self.vocab, (self.rows, self.seq + 1),
                            generator=self.gen, device=self.device,
                            dtype=torch.int32)
        return {"tokens": ids[:, :-1].contiguous(),
                "labels": ids[:, 1:].contiguous()}

    def next(self) -> dict[str, torch.Tensor]:
        out, self._next = self._next, self._draw()
        return out
