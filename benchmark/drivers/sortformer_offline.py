"""Entry driver: `SortformerDiarizer.process_offline` of fluidaudio_tpu_torch:
a recording's 30.72 s windows in one batched pass (window count bucketed to
a power of two), then the host's stitching and segments.

Set-up builds the diarizer at the configuration's sizes, loads the
benchmark's seeded weights into its model and runs each window bucket that
the mix's lengths reach, once. The probes keep every request's window
probabilities as the model returns them, and a few rows of the mel and
encoder output of two early requests.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from reference import sortformer as ref
from reference.common import rel_l2
from yardstick.capture import RowProbe
from yardstick.costs import conformer_flops, mel_flops, sortformer_head_flops
from yardstick.weights import make_weights

CAPTURE_ROWS = 4


class Driver:
    def __init__(self, cfg: dict, cell: dict, mix: dict, seed: int, device, spans, trace: bool):
        self.cfg, self.cell, self.mix, self.seed = cfg, cell, mix, seed
        self.device, self.spans, self.trace = device, spans, trace
        self.real_rows: int | None = None

    def setup(self, pool: np.ndarray) -> None:
        import fluidaudio_tpu_torch.models.conformer as conformer_mod
        from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer
        from fluidaudio_tpu_torch.models.sortformer import SortformerConfig

        self.pool = pool
        cfg, dev = self.cfg, self.device
        enc, head = cfg["encoder"], cfg["head"]
        self.weights = make_weights(ref.param_spec(cfg), self.seed, dev)
        scfg = SortformerConfig(
            n_mels=enc["n_mels"], d_model=head["d_model"], encoder_d_model=enc["d_model"],
            n_encoder_layers=enc["n_layers"], n_transformer_layers=head["n_transformer_layers"],
            n_heads=head["n_heads"], spkcache_len=head["spkcache_len"], fifo_len=head["fifo_len"],
            chunk_frames=head["chunk_frames"], update_period=head["update_period"],
            dtype=cfg["dtype"])
        # no checkpoint folder: the diarizer draws its own weights, replaced here
        self.diarizer = SortformerDiarizer(
            scfg, checkpoint_dir=Path(__file__).resolve().parent / "no-checkpoint", device=dev)
        self.diarizer.model.load_state_dict(self.weights, strict=True)
        self.diarizer.model.requires_grad_(False)
        self._install_probes(conformer_mod)
        self._warm()
        self.weights = {k: v.cpu() for k, v in self.weights.items()}

    def _install_probes(self, conformer_mod) -> None:
        d, model, spans = self.diarizer, self.diarizer.model, self.spans
        pin = self.device.type == "cuda"
        rs = np.random.default_rng(self.seed + 7)
        picks = sorted(rs.choice(4, size=2, replace=False).tolist())
        lo = min(len(ref.plan_windows(n)) for n in self._sizes())
        want = {i: (0, int(rs.integers(0, max(0, lo - CAPTURE_ROWS) + 1))) for i in picks}
        enc = self.cfg["encoder"]
        self.mel_probe = RowProbe(d.mel, spans, "mel", CAPTURE_ROWS,
                                  (enc["n_mels"], ref.WINDOW // 160 + 1), 2, pin)
        self.enc_probe = RowProbe(model.encoder.forward, spans, "encoder", CAPTURE_ROWS,
                                  (ref.WINDOW_MEL // 8, enc["d_model"]), 2, pin)
        self.mel_probe.want = self.enc_probe.want = want
        d.mel = self.mel_probe
        model.encoder.forward = self.enc_probe
        self.preds: list = []
        orig_forward = model.forward

        def forward(mel):
            out = orig_forward(mel)
            self.preds.append(out)
            return out

        model.forward = forward
        if self.trace:
            H, Dh = enc["n_heads"], enc["d_model"] // enc["n_heads"]

            def describe(args, kw, out):
                """What `attn_roofline.diar` reads of one call: the key lengths
                of the request's real windows (not the bucket's padding rows)."""
                o = kw.get("out")
                return {"lengths": args[5].clone(), "rows": self.real_rows, "heads": H,
                        "head_dim": Dh, "in": str(args[0].dtype).split(".")[-1],
                        "out": str((o if o is not None else out).dtype).split(".")[-1]}

            conformer_mod.relpos_attention = spans.timed_call(
                "attention", conformer_mod.relpos_attention, describe)

    def _sizes(self) -> list[int]:
        from yardstick.traffic import sizes
        return sizes(self.mix)

    def _warm(self) -> None:
        """One recording of each window bucket the mix reaches."""
        seen = set()
        for n in self._sizes():
            b = ref.bucket(len(ref.plan_windows(n)))
            if b not in seen:
                seen.add(b)
                self.diarizer.process_offline(self.pool[:n])
        self.preds.clear()

    def use_control(self) -> None:
        """The program in the next precision down: TF32 for its f32 matmuls
        and convolutions."""
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        self._warm()

    def serve(self, req):
        audio = self.pool[req.offset:req.offset + req.samples]
        self.mel_probe.start(req.index)
        self.enc_probe.start(req.index)
        self.real_rows = len(ref.plan_windows(req.samples))
        self.preds.clear()
        with self.spans.device_span("entry"):
            res = self.diarizer.process_offline(audio)
        return (self.preds[0], [(s.speaker_id, s.start_time, s.end_time) for s in res.segments])

    def tally(self, req, out) -> dict[str, float]:
        """Model FLOPs the request's real windows need (not the bucket's padding)."""
        enc, head = self.cfg["encoder"], self.cfg["head"]
        n = len(ref.plan_windows(req.samples))
        return {"flops": n * (mel_flops(ref.WINDOW // 160 + 1)
                              + conformer_flops(ref.WINDOW_MEL, enc)
                              + sortformer_head_flops(ref.WINDOW_MEL // 8, head))}

    def release(self) -> None:
        del self.diarizer
        self.enc_probe.fn = self.mel_probe.fn = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def check(self, done: list) -> dict[str, float]:
        cfg, dev = self.cfg, self.device
        W = {k: v.to(dev).float() for k, v in self.weights.items()}
        nums = {"mel_err": 0.0, "enc_err": 0.0, "prob_err": 0.0, "plan_diff": 0,
                "segment_diff": 0, "frames": 0}
        for req, _ in done:
            mel_rows, enc_rows = self.mel_probe.rows_of(req.index), self.enc_probe.rows_of(req.index)
            if mel_rows is None:
                continue
            r0 = self.mel_probe.want[req.index][1]
            plan = ref.plan_windows(req.samples)[r0:r0 + CAPTURE_ROWS]
            audio = ref.window_audio(self.pool[req.offset:req.offset + req.samples], plan)
            mel, enc, _ = ref.windows_forward(W, audio, cfg, dev)
            k = len(plan)
            nums["mel_err"] = max(nums["mel_err"],
                                  rel_l2(mel_rows[:k, :, :ref.WINDOW_MEL].to(dev), mel))
            nums["enc_err"] = max(nums["enc_err"], rel_l2(enc_rows[:k].to(dev), enc))
        rs = np.random.default_rng(self.seed + 11)
        longest = max(done, key=lambda d: d[0].samples)
        others = [d for d in done if d is not longest]
        pick = [longest] + [others[i] for i in rs.choice(len(others), size=min(
            len(others), int(self.cell.get("check_requests", 2))), replace=False)]
        for req, (preds, segs) in pick:
            audio = self.pool[req.offset:req.offset + req.samples]
            plan = ref.plan_windows(req.samples)
            nums["plan_diff"] += int(preds.shape[0] != ref.bucket(len(plan)))
            _, _, want = ref.windows_forward(W, ref.window_audio(audio, plan), cfg, dev)
            got = preds[:len(plan)].float()
            windows = []
            for i, (start, size) in enumerate(plan):
                n = ref.valid_frames(size)
                nums["prob_err"] = max(nums["prob_err"], float((got[i, :n] - want[i, :n]).abs().max()))
                nums["frames"] += n
                windows.append((start // ref.FRAME_SAMPLES, got[i, :n].cpu().numpy()))
            expect = ref.segments(ref.stitch(windows))
            nums["segment_diff"] += sum(a != b for a, b in zip(expect, segs)) + abs(
                len(expect) - len(segs))
        return nums
