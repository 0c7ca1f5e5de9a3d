#!/usr/bin/env python3
"""Where the time of one streaming chunk step goes, on one NVIDIA GPU.

    python3 scripts/torch_streaming_profile.py

Nemotron-en 0.6B (24 x 1024, f32 and bf16, 2240 ms chunks) and EOU 120M
(17 x 512, f32, 160 ms chunks) with seeded random weights, the joint's blank
bias calibrated to 9-12 tokens per second of speech-like audio
(`chip_smoke.calibrate_stream_blank_bias`). For N streams of a multi-stream
session (N = 1 and 128 for Nemotron, 1 for EOU), five steady ticks are split
into the stages of `MultiStreamMixin._serve_tick`, each ended by a device
sync: host windows (numpy, copy to the card), mel, encoder, RNN-T decode
(with its loop steps: joint calls), and the masks plus the one device->host
copy plus the host bookkeeping. For each stage: host wall ms (five
unprofiled ticks), kernel launches and device busy ms (torch.profiler around
the stage alone, three more ticks), so the idle share of each stage is
1 - busy / wall. The card's name and power limit head the output.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import busy_ms, calibrate_stream_blank_bias, speechlike  # noqa: E402
from fluidaudio_tpu_torch.asr.multistream import (  # noqa: E402
    _mask_caches, _mask_dec_state, chunk_outputs_to_host)
from fluidaudio_tpu_torch.asr.streaming_eou import (  # noqa: E402
    EOU_DEFAULT, StreamingEouAsrManager)
from fluidaudio_tpu_torch.asr.streaming_nemotron import (  # noqa: E402
    NEMOTRON_EN, StreamingNemotronAsrManager)
from fluidaudio_tpu_torch.utils.weights import load_state  # noqa: E402

STAGES = ("host windows", "mel", "encoder", "decode", "mask + copy + host")


def staged_tick(mgr, session, active, record, joint_calls, profiled: bool) -> None:
    """`_serve_tick` cut into its stages, each ended by a device sync.
    `record[stage]` gets the stage's host wall ms, or with `profiled` its
    (kernel launches, device busy ms) from a profiler around it alone."""
    def stage(name, fn):
        if not profiled:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            record[name].append((time.perf_counter() - t0) * 1e3)
            return out
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        launches = sum(not e.name.startswith(("Memcpy", "Memset")) for e in device)
        record[name].append((launches, busy_ms(device) if device else 0.0))
        return out

    dev = mgr.device

    def windows():
        B, need = session.n, mgr._need
        w = np.zeros((B, need), np.float32)
        last = np.zeros((B,), np.float32)
        for i, s in enumerate(session.streams):
            w[i] = s.pending[:need]
            last[i] = s.last_sample
        return (torch.from_numpy(w).to(dev), torch.from_numpy(last).to(dev),
                torch.from_numpy(active).to(dev), torch.from_numpy(session.prompt_ids).to(dev))

    win, lst, act, pid = stage("host windows", windows)
    mel = stage("mel", lambda: mgr._mel_chunk(win, lst))
    enc, new_caches = stage("encoder", lambda: mgr._apply_encoder(mel, session.caches, pid))
    before = joint_calls[0]
    result, new_state = stage("decode", lambda: mgr._decode_chunk(enc, session.dec_state))
    record["decode steps"].append(joint_calls[0] - before)

    def finish():
        session.caches = _mask_caches(act, new_caches, session.caches)
        session.dec_state = _mask_dec_state(act, new_state, session.dec_state)
        counts = torch.where(act, result.counts, 0)
        tokens_h, times_h, counts_h, eou_h = chunk_outputs_to_host(
            result.tokens, result.token_times, counts, result.eou_detected & act)
        for i, s in enumerate(session.streams):
            n = int(counts_h[i])
            mgr._host_advance(s, tokens_h[i][:n], times_h[i][:n], bool(eou_h[i]))

    stage("mask + copy + host", finish)


def profile_stages(mgr, label: str, n_streams: int, smi: str) -> None:
    rs = np.random.RandomState(n_streams)
    warm, timed, profiled = 2, 5, 3
    ticks = warm + timed + profiled
    audios = [speechlike(rs, (ticks * mgr.chunk_samples + 240) / 16_000)
              for _ in range(n_streams)]
    session = mgr.make_multi_state(n_streams)
    for s, a in zip(session.streams, audios):
        s.pending = a
    active = np.ones(n_streams, bool)
    joint_calls = [0]
    hook = mgr.joint.register_forward_pre_hook(
        lambda *_: joint_calls.__setitem__(0, joint_calls[0] + 1))
    walls = {k: [] for k in (*STAGES, "decode steps")}
    device = {k: [] for k in (*STAGES, "decode steps")}
    try:
        for _ in range(warm):
            staged_tick(mgr, session, active, {k: [] for k in walls}, joint_calls, False)
        for _ in range(timed):
            staged_tick(mgr, session, active, walls, joint_calls, False)
        for _ in range(profiled):
            staged_tick(mgr, session, active, device, joint_calls, True)
    finally:
        hook.remove()
    total = sum(np.mean(walls[k]) for k in STAGES)
    tokens = sum(len(s.tokens) for s in session.streams) / n_streams
    print(f"[{smi}] {label} {mgr.chunk_ms} ms chunks, N={n_streams}: one tick {total:.2f} ms "
          f"of host wall with a sync after each stage (mean of {timed}), "
          f"{np.mean(walls['decode steps']):.1f} decode loop steps per tick, "
          f"{tokens / ticks:.2f} tokens per stream per tick")
    for name in STAGES:
        wall = float(np.mean(walls[name]))
        launches = float(np.mean([n for n, _ in device[name]]))
        busy = float(np.mean([b for _, b in device[name]]))
        print(f"  {name:20s} wall {wall:8.3f} ms, {launches:7.1f} launches, device busy "
              f"{busy:7.3f} ms (idle share {max(0.0, 1 - busy / wall):.3f})")
    launches = np.mean([n for n, _ in device["decode"]])
    print(f"  decode loop: {launches / np.mean(device['decode steps']):.1f} launches per step "
          f"(profiled ticks), {np.mean(walls['decode']) / np.mean(walls['decode steps']) * 1e3:.1f}"
          f" us of wall per step (timed ticks)")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    device = torch.device("cuda", 0)
    rs = np.random.RandomState(7)
    nem = StreamingNemotronAsrManager(NEMOTRON_EN, 2240, device=device)
    tps = calibrate_stream_blank_bias(nem, rs, 9)
    print(f"[{smi}] Nemotron-en blank bias calibrated to {tps:.2f} tok/s")
    for n in (1, 128):
        profile_stages(nem, "Nemotron-en 0.6B f32", n, smi)
    bf16 = StreamingNemotronAsrManager(
        NEMOTRON_EN, 2240, device=device,
        enc_cfg=dataclasses.replace(nem.enc_cfg, dtype="bfloat16"))
    for part in ("encoder", "predictor", "joint"):
        load_state(getattr(bf16, part), getattr(nem, part).state_dict())
    del nem
    profile_stages(bf16, "Nemotron-en 0.6B bf16", 128, smi)
    del bf16
    eou = StreamingEouAsrManager(160, spec=EOU_DEFAULT, device=device)
    tps = calibrate_stream_blank_bias(eou, rs, 16)
    print(f"[{smi}] EOU 120M blank bias calibrated to {tps:.2f} tok/s")
    profile_stages(eou, "EOU 120M f32", 1, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
