"""Plain Sortformer v2 offline diarization: the 30.72 s windows with a
~5 s overlap, the FastConformer encoder, the NeMo post-LN transformer head
with its 4 sigmoid speaker slots, the window stitching (overlap correlation,
then the Hungarian assignment) and the 0.5-threshold segments."""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment
from torch.nn import functional as F

from reference.common import F32, conformer, conformer_spec, log_mel, true_f32

WINDOW_MEL = 3072  # 30.72 s
WINDOW = WINDOW_MEL * 160
FRAME_SAMPLES = 1280
STEP = WINDOW - 64 * FRAME_SAMPLES  # 64 frames (5.12 s) of overlap
SPEAKERS = 4
FRAME_S = 0.08


def param_spec(cfg: dict) -> list:
    h = cfg["head"]
    d, e, dt = h["d_model"], cfg["encoder"]["d_model"], cfg["dtype"]
    s = conformer_spec("encoder.", cfg["encoder"], dt)
    s += [("encoder_proj.weight", (d, e), "w", dt), ("encoder_proj.bias", (d,), "b", dt)]
    for i in range(h["n_transformer_layers"]):
        for n in ("q", "k", "v", "out"):
            s += [(f"tf{i}.{n}.weight", (d, d), "w", dt), (f"tf{i}.{n}.bias", (d,), "b", dt)]
        s += [(f"tf{i}.ln1.weight", (d,), "ln", dt), (f"tf{i}.ln1.bias", (d,), "b", dt),
              (f"tf{i}.ffn_in.weight", (4 * d, d), "w", dt), (f"tf{i}.ffn_in.bias", (4 * d,), "b", dt),
              (f"tf{i}.ffn_out.weight", (d, 4 * d), "w", dt), (f"tf{i}.ffn_out.bias", (d,), "b", dt),
              (f"tf{i}.ln2.weight", (d,), "ln", dt), (f"tf{i}.ln2.bias", (d,), "b", dt)]
    s += [("hidden_fc.weight", (d, d), "w", dt), ("hidden_fc.bias", (d,), "b", dt),
          ("head.weight", (SPEAKERS, d), "w", dt), ("head.bias", (SPEAKERS,), "b", dt)]
    return s


def plan_windows(total: int) -> list[tuple[int, int]]:
    """-> [(start sample, valid samples)]: windows every STEP samples; a
    window of less than 1 s after the first is dropped."""
    out = []
    for start in range(0, max(1, total), STEP):
        size = max(0, min(total - start, WINDOW))
        if size < 16_000 and out:
            break
        out.append((start, size))
        if start + WINDOW >= total:
            break
    return out


def bucket(n: int) -> int:
    return 1 << (n - 1).bit_length()


def window_audio(audio: np.ndarray, windows: list[tuple[int, int]]) -> np.ndarray:
    """int16 [n, WINDOW]: each window's samples, zeros past the recording."""
    out = np.zeros((len(windows), WINDOW), np.int16)
    for i, (s, n) in enumerate(windows):
        out[i, :n] = audio[s:s + n]
    return out


def head(W: dict, frames: torch.Tensor, cfg: dict) -> torch.Tensor:
    """encoder output [B, T, e] -> speaker probabilities [B, T, 4]."""
    h = cfg["head"]
    H = h["n_heads"]
    x = F.linear(frames, W["encoder_proj.weight"], W["encoder_proj.bias"])
    B, N, d = x.shape
    hd = d // H
    for i in range(h["n_transformer_layers"]):
        p = f"tf{i}."
        q, k, v = (F.linear(x, W[p + n + ".weight"], W[p + n + ".bias"]).reshape(B, N, H, hd)
                   for n in ("q", "k", "v"))
        probs = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) / math.sqrt(hd), dim=-1)
        att = torch.einsum("bhnm,bmhd->bnhd", probs, v).reshape(B, N, d)
        x = F.layer_norm(x + F.linear(att, W[p + "out.weight"], W[p + "out.bias"]), (d,),
                         W[p + "ln1.weight"], W[p + "ln1.bias"], 1e-6)
        ff = F.linear(F.relu(F.linear(x, W[p + "ffn_in.weight"], W[p + "ffn_in.bias"])),
                      W[p + "ffn_out.weight"], W[p + "ffn_out.bias"])
        x = F.layer_norm(x + ff, (d,), W[p + "ln2.weight"], W[p + "ln2.bias"], 1e-6)
    z = F.relu(F.linear(x, W["hidden_fc.weight"], W["hidden_fc.bias"]))
    return torch.sigmoid(F.linear(z, W["head.weight"], W["head.bias"]))


def windows_forward(W: dict, audio: np.ndarray, cfg: dict, device, block: int = 16
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int16 windows [n, WINDOW] -> (mel [n, 128, 3072], encoder output
    [n, 384, e], probabilities [n, 384, 4]), f32, TF32 off, `block` rows at
    a time."""
    mels, encs, preds = [], [], []
    We = {k[len("encoder."):]: v for k, v in W.items() if k.startswith("encoder.")}
    with true_f32():
        for s in range(0, len(audio), block):
            x = torch.from_numpy(audio[s:s + block]).to(device).float() / 32768.0
            n = torch.full((len(x),), WINDOW, device=device)
            mel, _ = log_mel(x, n, cfg["encoder"]["n_mels"], normalize=False)
            mel = mel[:, :, :WINDOW_MEL]
            enc, _ = conformer(We, mel, torch.full((len(x),), WINDOW_MEL, device=device),
                               cfg["encoder"])
            mels.append(mel)
            encs.append(enc)
            preds.append(head(W, enc, cfg))
    return torch.cat(mels), torch.cat(encs), torch.cat(preds)


def stitch(windows: list[tuple[int, np.ndarray]]) -> np.ndarray:
    """[(first frame, probabilities [n, 4])] -> the recording's probabilities:
    each window's slots permuted to the timeline by the Hungarian assignment
    on the overlap's correlation, then the windows averaged."""
    total = max(off + len(p) for off, p in windows)
    acc = np.zeros((total, SPEAKERS), np.float32)
    count = np.zeros(total, np.float32)
    for off, p in windows:
        end = off + len(p)
        ov = count[off:end] > 0
        if ov.any():
            a = acc[off:end][ov] / count[off:end][ov][:, None]
            rows, cols = linear_sum_assignment(-(a.T @ p[ov]))
            perm = np.zeros(SPEAKERS, np.int64)
            perm[rows] = cols
            p = p[:, perm]
        acc[off:end] += p
        count[off:end] += 1.0
    return acc / np.maximum(count[:, None], 1.0)


def segments(probs: np.ndarray, threshold: float = 0.5) -> list[tuple[str, float, float]]:
    """Runs of frames at or over the threshold, per slot, sorted by start."""
    out = []
    for s in range(SPEAKERS):
        on = np.concatenate([[False], probs[:, s] >= threshold, [False]])
        edges = np.flatnonzero(on[1:] != on[:-1])
        for a, b in zip(edges[::2], edges[1::2]):
            out.append((f"spk{s}", a * FRAME_S, b * FRAME_S))
    return sorted(out, key=lambda x: x[1])


def valid_frames(size: int) -> int:
    return min(WINDOW_MEL // 8, math.ceil(size / FRAME_SAMPLES))
