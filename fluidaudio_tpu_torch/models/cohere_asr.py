"""Cohere Transcribe encoder-decoder multilingual ASR (14 languages), in PyTorch.

Port of `fluidaudio_tpu/models/cohere_asr.py` (reference
`Cohere/CohereAsrConfig.swift:25-60`, `CoherePipeline.swift:690-715`): the
port's FastConformer encoder at hidden 1280 x 48 layers over 128 mels, a
transformer decoder (hidden 1024, 8 heads x 128, 8 layers) with an external
KV cache of `max_decode_tokens` = 108 positions, an additive -1e4 cross
attention pad mask, and greedy decoding with a repetition penalty and a
no-repeat-n-gram ban.

The encoder's head width is 160 at full width (8 at the test size), outside
the rel-pos attention kernel's 16..128, so it takes `relpos_attention_plain`
(the JAX encoder likewise takes plain XLA for every Dh other than 128).

Numerics follow the JAX module: the decoder's LayerNorms use flax's eps
1e-6 (the encoder keeps the conformer's 1e-5); `gelu` is flax's tanh
approximation; the scores leave the compute dtype when scaled by
`1/sqrt(Dh)` (a NumPy scalar in JAX, which promotes to f32), so the
self-attention fill `finfo(dtype).min` and the cross-attention -1e4 are
applied in f32, as there; the output head is tied to the embedding table.

`cohere_greedy_decode` keeps JAX's stopping rule (stop when every row is
done or ANY row reaches position M-1; `pos` advances on the step that emits
EOS) without a host sync per token: each step computes the rule on the
device and gates every update by it, so a step past the end changes
nothing, and the host reads the rule once per `SYNC_EVERY` steps. A row
that is not done advances `pos` on every step, so inside the loop no row has
reached M-1 and the rule reduces to "some row is not done"; a done row only
rewrites EOS over EOS. Each row of a batch therefore takes the same steps as
it would alone, which lets the pipeline batch the windows of a long input.
The emitted-token set of the repetition penalty and the n-gram ban are
reductions (`scatter_reduce` with `amax`), never a last-write-wins scatter.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from fluidaudio_tpu_torch.models.conformer import ConformerConfig, ConformerEncoder
from fluidaudio_tpu_torch.models.sensevoice import FLAX_LN_EPS, layer_norm, masked_softmax


@dataclass(frozen=True)
class CohereConfig:
    # documented dims: CohereAsrConfig.swift:25-60
    vocab_size: int = 16_384
    enc_hidden: int = 1280
    n_encoder_layers: int = 48
    n_enc_heads: int = 8
    d_model: int = 1024  # decoder hidden
    n_heads: int = 8  # decoder heads (head_dim 128)
    n_decoder_layers: int = 8
    n_mels: int = 128
    max_audio_frames: int = 3500  # 35 s at 10 ms hop
    max_decode_tokens: int = 108  # CohereAsrConfig.maxSeqLen
    bos_id: int = 4  # startToken
    eos_id: int = 3  # eosToken
    pad_id: int = 2
    no_speech_id: int = 1
    repetition_penalty: float = 1.3
    no_repeat_ngram: int = 3
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def conformer(self) -> ConformerConfig:
        """The encoder trunk at the Cohere width (JAX `CohereEncoder`)."""
        return ConformerConfig(
            n_mels=self.n_mels, d_model=self.enc_hidden, n_layers=self.n_encoder_layers,
            n_heads=self.n_enc_heads, subsampling_channels=max(32, self.enc_hidden // 8),
            dtype=self.dtype,
        )


# the 14 supported locales (reference `CohereAsrConfig.Language`,
# ISO-639-1 code -> English name)
COHERE_LANGUAGES = {
    "en": "English", "fr": "French", "de": "German", "es": "Spanish",
    "it": "Italian", "pt": "Portuguese", "nl": "Dutch", "pl": "Polish",
    "el": "Greek", "ar": "Arabic", "ja": "Japanese", "zh": "Chinese",
    "vi": "Vietnamese", "ko": "Korean",
}

COHERE_BASE = CohereConfig()
COHERE_TEST = CohereConfig(
    vocab_size=64, enc_hidden=32, n_encoder_layers=2, n_enc_heads=4,
    d_model=32, n_heads=4, n_decoder_layers=2,
    n_mels=16, max_audio_frames=64, max_decode_tokens=16, dtype="float32",
)


class CohereEncoder(nn.Module):
    """mel [B, n_mels, T] -> (f32 enc [B, T', enc_hidden], mask [B, T'])."""

    def __init__(self, cfg: CohereConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.conformer = ConformerEncoder(cfg.conformer(), device)

    @torch.no_grad()
    def forward(self, mel: torch.Tensor, mel_lengths: torch.Tensor):
        enc, enc_lengths = self.conformer(mel, mel_lengths)
        mask = torch.arange(enc.shape[1], device=enc.device)[None, :] < enc_lengths[:, None]
        return enc, mask


class _Embed(nn.Module):
    """flax `nn.Embed`: the table is `embedding` [V, D]."""

    def __init__(self, vocab_size: int, d_model: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(vocab_size, d_model, device=device))


class CohereDecoderStep(nn.Module):
    """One decoder step with an external KV cache (token t attends cache[0..t])."""

    def __init__(self, cfg: CohereConfig, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        self.embed = _Embed(cfg.vocab_size, D, device)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_decode_tokens, D, device=device))
        for i in range(cfg.n_decoder_layers):
            for name in ("sln", "cln", "fln"):
                self.add_module(f"{name}{i}", nn.LayerNorm(D, eps=FLAX_LN_EPS, device=device))
            for name in ("q", "k", "v", "so", "cq", "co"):
                self.add_module(f"{name}{i}", nn.Linear(D, D, device=device))
            for name in ("ck", "cv"):  # over the encoder output
                self.add_module(f"{name}{i}", nn.Linear(cfg.enc_hidden, D, device=device))
            self.add_module(f"ff1_{i}", nn.Linear(D, 4 * D, device=device))
            self.add_module(f"ff2_{i}", nn.Linear(4 * D, D, device=device))
        self.final_ln = nn.LayerNorm(D, eps=FLAX_LN_EPS, device=device)
        self.to(cfg.compute_dtype)

    @torch.no_grad()
    def cross_kv(self, enc: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Per-layer cross-attention keys and values [B, H, Te, Dh] of `enc`.
        They depend on `enc` alone, so a decode projects them once."""
        cfg = self.cfg
        B, Te, _ = enc.shape
        H, Dh = cfg.n_heads, cfg.head_dim
        e = enc.to(cfg.compute_dtype)
        out = []
        for i in range(cfg.n_decoder_layers):
            kc = getattr(self, f"ck{i}")(e).reshape(B, Te, H, Dh).transpose(1, 2)
            vc = getattr(self, f"cv{i}")(e).reshape(B, Te, H, Dh).transpose(1, 2)
            out.append((kc, vc))
        return out

    @torch.no_grad()
    def forward(self, token, position, k_cache, v_cache, enc, enc_mask, cross=None):
        """token [B] int, position [B] int, k/v_cache [L, B, M, H, Dh] ->
        (f32 logits [B, V], k_cache, v_cache). The caches are written in
        place at `position` (and returned). `cross`: `cross_kv(enc)`,
        computed here when not given."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        B = token.shape[0]
        H, Dh, D = cfg.n_heads, cfg.head_dim, cfg.d_model
        M = cfg.max_decode_tokens
        if cross is None:
            cross = self.cross_kv(enc)
        rows = torch.arange(B, device=token.device)
        pos = position.long()
        table = self.embed.embedding.to(dt)
        x = (table[token.long()]
             + self.pos_embed[torch.clamp(pos, 0, M - 1)].to(dt))[:, None, :]  # [B, 1, D]
        causal = torch.arange(M, device=token.device)[None, :] <= pos[:, None]  # [B, M]
        cross_bias = torch.where(enc_mask, 0.0, -1e4)[:, None, None, :]  # f32, as in JAX

        for i in range(cfg.n_decoder_layers):
            h = layer_norm(getattr(self, f"sln{i}"), x, dt)
            q = getattr(self, f"q{i}")(h).reshape(B, 1, H, Dh).transpose(1, 2)
            k_cache[i, rows, pos] = getattr(self, f"k{i}")(h).reshape(B, H, Dh)
            v_cache[i, rows, pos] = getattr(self, f"v{i}")(h).reshape(B, H, Dh)
            k_i = k_cache[i].permute(0, 2, 3, 1)  # [B, H, Dh, M]
            v_i = v_cache[i].transpose(1, 2)  # [B, H, M, Dh]
            scores = torch.matmul(q, k_i).float() / math.sqrt(Dh)  # [B, H, 1, M]
            probs = masked_softmax(scores, causal[:, None, None, :], dt)
            att = torch.matmul(probs, v_i).transpose(1, 2).reshape(B, 1, D)
            x = x + getattr(self, f"so{i}")(att)

            h = layer_norm(getattr(self, f"cln{i}"), x, dt)
            qc = getattr(self, f"cq{i}")(h).reshape(B, 1, H, Dh).transpose(1, 2)
            kc, vc = cross[i]
            cs = torch.matmul(qc, kc.transpose(-1, -2)).float() / math.sqrt(Dh) + cross_bias
            cp = torch.softmax(cs, dim=-1).to(dt)
            catt = torch.matmul(cp, vc).transpose(1, 2).reshape(B, 1, D)
            x = x + getattr(self, f"co{i}")(catt)

            f = layer_norm(getattr(self, f"fln{i}"), x, dt)
            f = F.gelu(getattr(self, f"ff1_{i}")(f), approximate="tanh")
            x = x + getattr(self, f"ff2_{i}")(f)

        x = layer_norm(self.final_ln, x, dt)
        logits = (x[:, 0] @ table.T).float()  # the head is tied to the embedding
        return logits, k_cache, v_cache


#: decode steps between two host reads of the stopping rule (as the TDT loop)
SYNC_EVERY = 8


class CohereDecodeResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_decode_tokens] int32
    counts: torch.Tensor  # [B] int32
    steps: int = 0  # decode steps run (a multiple of SYNC_EVERY, or M-1)
    host_syncs: int = 0  # device->host reads of the stopping rule


StepFn = Callable[..., tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _vocab_any(rows: torch.Tensor, flags: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """[B, V] bool: v is set where some j has rows[b, j] == v and flags[b, j]
    (an order-free reduction over duplicate indices)."""
    acc = torch.zeros(rows.shape[0], vocab_size, dtype=torch.float32, device=rows.device)
    return acc.scatter_reduce_(1, rows.long(), flags.float(), reduce="amax") > 0


@torch.no_grad()
def cohere_greedy_decode(
    cfg: CohereConfig,
    step_fn: StepFn,  # (token, position, k, v, enc, enc_mask) -> (logits, k, v)
    enc: torch.Tensor,
    enc_mask: torch.Tensor,
) -> CohereDecodeResult:
    """Greedy AR decode with repetition penalty + no-repeat-ngram ban."""
    B = enc.shape[0]
    dev = enc.device
    L, H, Dh = cfg.n_decoder_layers, cfg.n_heads, cfg.head_dim
    M, V, n = cfg.max_decode_tokens, cfg.vocab_size, cfg.no_repeat_ngram
    k = torch.zeros((L, B, M, H, Dh), dtype=cfg.compute_dtype, device=dev)
    v = torch.zeros_like(k)
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    token = torch.full((B,), cfg.bos_id, dtype=torch.int32, device=dev)
    out = torch.full((B, M), cfg.eos_id, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    eos = torch.tensor(cfg.eos_id, dtype=torch.int32, device=dev)
    slots = torch.arange(M, device=dev)
    if n >= 2:
        win = torch.clamp(slots[:, None] + torch.arange(n - 1, device=dev)[None, :], 0, M - 1)
        nxt_slot = torch.clamp(slots + n - 1, 0, M - 1)

    steps = syncs = 0
    while steps < M - 1:
        # JAX's loop condition, evaluated on the device
        running = (~done).any() & (pos < M - 1).all()
        if steps and steps % SYNC_EVERY == 0:
            syncs += 1
            if not bool(running):
                break
        logits, k, v = step_fn(token, pos, k, v, enc, enc_mask)
        emitted = _vocab_any(out, slots[None, :] < pos[:, None], V)
        penalized = torch.where(logits > 0, logits / cfg.repetition_penalty,
                                logits * cfg.repetition_penalty)
        logits = torch.where(emitted, penalized, logits)
        if n >= 2:
            ctx_idx = torch.clamp(pos[:, None].long() - (n - 1)
                                  + torch.arange(n - 1, device=dev)[None, :], 0, M - 1)
            ctx = torch.gather(out, 1, ctx_idx)  # [B, n-1]
            match = (out[:, win] == ctx[:, None, :]).all(dim=-1)  # [B, M]
            match &= (slots[None, :] + n - 1) < pos[:, None]
            banned = _vocab_any(out[:, nxt_slot], match, V)
            logits = torch.where(banned & (pos >= n - 1)[:, None], -1e9, logits)

        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(done, eos, nxt)
        new_out = out.scatter(1, pos[:, None].long(), nxt[:, None])
        new_done = done | (nxt == eos)
        new_pos = torch.where(done, pos, pos + 1)
        token = torch.where(running, nxt, token)
        out = torch.where(running, new_out, out)
        done = torch.where(running, new_done, done)
        pos = torch.where(running, new_pos, pos)
        steps += 1
    return CohereDecodeResult(tokens=out, counts=pos, steps=steps, host_syncs=syncs)
