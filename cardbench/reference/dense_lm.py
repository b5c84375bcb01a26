"""A dense decoder LM in plain PyTorch, as a configuration file states it.

Pre-norm blocks of RMSNorm, grouped-query attention with rotary embeddings
(the rotate-half form) and a SwiGLU MLP; tied embeddings; the Granite
multipliers (``embedding_multiplier``, ``residual_multiplier``,
``attention_multiplier`` as the softmax scale, ``logits_scaling`` as the
logits' divisor). Every value is float32. Each layer, each block of
query rows in the attention and each block of rows in the loss runs under
activation checkpointing, so a model of billions of parameters at
thousands of tokens a row fits beside its optimizer state.

``precision`` names how the matrix products are computed:

* ``"fp32"``: float32 products (the caller turns TF32 off);
* ``"fp8"``: the control, each product's operands rounded to float8 with
  one scale a tensor (E4M3 forward, E5M2 for the gradients that the
  backward's products take), accumulated in float32.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 512          # query rows per attention block
LOSS_ROWS = 2048       # tokens per block of the loss

_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0),
        "e5m2": (torch.float8_e5m2, 57344.0)}


def _fp8(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` rounded to a float8 format under one scale for the tensor,
    returned in ``x``'s dtype."""
    dtype, top = _FP8[kind]
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / top
    return ((x / scale).to(dtype).to(x.dtype) * scale)


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with float8 operands: E4M3 in the forward, the incoming
    gradient in E5M2 in the backward's two products."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, "e4m3"), _fp8(b, "e4m3")
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, "e5m2")
        return qg @ qb.mT, qa.mT @ qg


class DenseLM:
    def __init__(self, cfg: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.cfg = cfg
        self.precision = precision
        self.d = cfg["hidden_size"]
        self.h = cfg["num_attention_heads"]
        self.hkv = cfg["num_key_value_heads"]
        self.hd = cfg.get("head_dim") or self.d // self.h
        self.eps = cfg["rms_norm_eps"]

    # -- arithmetic ---------------------------------------------------------
    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _Fp8Matmul.apply(a, b)
        return a @ b

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x`` (..., k) times ``w`` (k, n), through a 2-D product."""
        lead = x.shape[:-1]
        return self.matmul(x.reshape(-1, x.shape[-1]), w).reshape(
            *lead, w.shape[-1])

    def rms_norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.eps) * w

    # -- rotary -------------------------------------------------------------
    def rotary(self, s: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        half = self.hd // 2
        inv = self.cfg["rope_theta"] ** (
            -torch.arange(half, dtype=torch.float32, device=device) / half)
        ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] \
            * inv[None, :]
        return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]

    @staticmethod
    def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
             ) -> torch.Tensor:
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    # -- attention ------------------------------------------------------------
    def _attend_block(self, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, start: int) -> torch.Tensor:
        """Causal attention of the query rows ``start ..`` (B, H, n, hd)
        over keys 0 .. start + n - 1."""
        n = q.shape[2]
        end = start + n
        scores = self.matmul(q, k[:, :, :end].mT) \
            * self.cfg["attention_multiplier"]
        rows = torch.arange(start, end, device=q.device)[:, None]
        cols = torch.arange(end, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        return self.matmul(torch.softmax(scores, dim=-1), v[:, :, :end])

    def attention(self, q, k, v) -> torch.Tensor:
        """q (B, S, H, hd), k/v (B, S, Hkv, hd) -> (B, S, H * hd): query
        head i reads KV head i // (H / Hkv)."""
        b, s = q.shape[:2]
        g = self.h // self.hkv
        q = q.transpose(1, 2)
        k = k.repeat_interleave(g, dim=2).transpose(1, 2)
        v = v.repeat_interleave(g, dim=2).transpose(1, 2)
        outs = [checkpoint(self._attend_block, q[:, :, i:i + Q_BLOCK], k, v,
                           i, use_reentrant=False)
                for i in range(0, s, Q_BLOCK)]
        return torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, -1)

    # -- blocks ---------------------------------------------------------------
    def layer(self, x: torch.Tensor, w: dict, i: int, cos, sin
              ) -> torch.Tensor:
        b, s, d = x.shape
        res = self.cfg["residual_multiplier"]
        hn = self.rms_norm(x, w["layers/ln_attn"][i])
        q = self.linear(hn, w["layers/attn/wq"][i].reshape(d, -1))
        k = self.linear(hn, w["layers/attn/wk"][i].reshape(d, -1))
        v = self.linear(hn, w["layers/attn/wv"][i].reshape(d, -1))
        q = self.rope(q.view(b, s, self.h, self.hd), cos, sin)
        k = self.rope(k.view(b, s, self.hkv, self.hd), cos, sin)
        a = self.attention(q, k, v.view(b, s, self.hkv, self.hd))
        x = x + res * self.linear(a, w["layers/attn/wo"][i].reshape(-1, d))
        hn = self.rms_norm(x, w["layers/ln_mlp"][i])
        gate = self.linear(hn, w["layers/mlp/w_gate"][i])
        up = self.linear(hn, w["layers/mlp/w_up"][i])
        mlp = self.linear(torch.nn.functional.silu(gate) * up,
                          w["layers/mlp/w_down"][i])
        return x + res * mlp

    def _loss_sum(self, x: torch.Tensor, labels: torch.Tensor, w: dict
                  ) -> torch.Tensor:
        """Summed cross-entropy of rows ``x`` (n, d) against ``labels``."""
        hn = self.rms_norm(x, w["ln_final"])
        logits = self.linear(hn, w["embedding"].T) \
            / self.cfg["logits_scaling"]
        return torch.nn.functional.cross_entropy(logits, labels.long(),
                                                 reduction="sum")

    def loss(self, w: dict, tokens: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
        """Mean next-token cross-entropy over every position."""
        s = tokens.shape[1]
        x = w["embedding"][tokens.long()] * self.cfg["embedding_multiplier"]
        cos, sin = self.rotary(s, x.device)
        for i in range(self.cfg["num_hidden_layers"]):
            x = checkpoint(self.layer, x, w, i, cos, sin, use_reentrant=False)
        x = x.reshape(-1, self.d)
        flat = labels.reshape(-1)
        total = sum(checkpoint(self._loss_sum, x[j:j + LOSS_ROWS],
                               flat[j:j + LOSS_ROWS], w, use_reentrant=False)
                    for j in range(0, x.shape[0], LOSS_ROWS))
        return total / flat.numel()
