"""The mesh cases of the port's `parallel/`, one process per rank.

`spawn(world, device)` starts `world` ranks (`python
tests/torch_parallel_ranks.py RANK WORLD RDZV_FILE OUT DEVICE`, from the
repository root, `LOCAL_RANK` set) that form one process group (gloo on
the CPU, NCCL on cards) and run every case on one (world / 2) x 2
("data", "model") mesh; rank 0 pickles each case's outputs (plain numbers,
strings and lists, or the traceback of a failure). Each case's `expect_`
function holds them to JAX's assertions (`tests/test_multichip.py`, the
mesh cases of `tests/test_multistream.py`) and to the single-device
results. Nothing here imports JAX: `tests/test_torch_parallel.py` runs it
as 8 CPU ranks, and on a machine with cards

    python tests/torch_parallel_ranks.py --check 4 cuda

runs it on 4 of them and exits 1 if a case fails.
"""

from __future__ import annotations

import functools
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

DRYRUN = dict(n_mels=16, d_model=64, n_layers=2, n_heads=4, subsampling_channels=16,
              dtype="float32")
VOCAB, MEL_FRAMES = 32, 65
REPO = Path(__file__).resolve().parents[1]
DEVICE = "cpu"  # this rank's device type, set by `main`
WORLD = 8  # ranks, set by `main`: the mesh is (WORLD / 2) x 2


@functools.cache
def _mesh():
    from fluidaudio_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(WORLD, data=WORLD // 2, model=2, device=DEVICE)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device=DEVICE).manual_seed(seed)


def _mixed_batch(seed: int) -> dict:
    """A batch of 8 at the dryrun's config, with mixed lengths so the masks
    are exercised."""
    rng = np.random.RandomState(seed)
    return {
        "mel": rng.randn(8, DRYRUN["n_mels"], MEL_FRAMES).astype(np.float32),
        "mel_lengths": np.array([65, 60, 49, 65, 41, 65, 33, 57], np.int32),
        "labels": rng.randint(0, VOCAB, (8, 8)).astype(np.int32),
        "label_lengths": np.array([8, 5, 3, 8, 2, 8, 1, 6], np.int32),
    }


def _tdt_configs():
    from fluidaudio_tpu_torch.models.conformer import ConformerConfig
    from fluidaudio_tpu_torch.models.predictor import PredictorConfig

    cfg = ConformerConfig(**DRYRUN)
    pcfg = PredictorConfig(vocab_size=VOCAB, pred_hidden=32, n_layers=1,
                           enc_hidden=cfg.d_model, joint_hidden=32, n_durations=5)
    return cfg, pcfg


# ------------------------------------------------------------------- cases


def case_mesh_and_param_sharding():
    from torch import nn
    from torch.distributed.tensor import Shard

    from fluidaudio_tpu_torch.parallel.mesh import param_sharding_rules, shard_batch

    mesh = _mesh()
    params = nn.ModuleDict({"layer": nn.Linear(16, 64)})
    rules = param_sharding_rules(mesh, params)
    batch = shard_batch(mesh, {"x": np.zeros((8, 4))})
    return {
        "shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "kernel": [repr(p) for p in rules["layer.weight"]],
        "bias": [repr(p) for p in rules["layer.bias"]],
        "batch_x_data_placement": batch["x"].placements[0] == Shard(0),
        "batch_x_local_shape": list(batch["x"].to_local().shape),
    }


def _torch_axis(placements):
    from torch.distributed.tensor import Shard

    model = placements[1]
    return model.dim if isinstance(model, Shard) else None


def case_param_sharding_rules_equal_jax():
    """The port's rule on the dryrun's CTC and TDT parameters, as the torch
    axis sharded over "model" per parameter (None: replicated)."""
    from fluidaudio_tpu_torch.parallel.mesh import param_sharding_rules
    from fluidaudio_tpu_torch.parallel.train import create_tdt_train_state, create_train_state
    from fluidaudio_tpu_torch.models.conformer import ConformerConfig

    mesh = _mesh()
    gen = _gen(0)
    state, _, _ = create_train_state(gen, ConformerConfig(**DRYRUN), VOCAB, MEL_FRAMES,
                                     device=DEVICE)
    cfg, pcfg = _tdt_configs()
    tstate, _, _ = create_tdt_train_state(gen, cfg, pcfg, MEL_FRAMES, device=DEVICE)
    return {
        "ctc": {k: _torch_axis(p) for k, p in param_sharding_rules(mesh, state.params).items()},
        "tdt": {k: _torch_axis(p) for k, p in param_sharding_rules(mesh, tstate.params).items()},
    }


def _grad_errors(got: dict, want: dict) -> dict:
    """Per leaf: |got - want| L2, |want| L2 (the sharded gradients gathered
    over "model")."""
    return {k: (float((g.full_tensor() - want[k]).norm()), float(want[k].norm()))
            for k, g in got.items()}


def _sharded_vs_single(kind: str):
    from fluidaudio_tpu_torch.parallel import train as pt
    from fluidaudio_tpu_torch.parallel.mesh import shard_batch, shard_params
    from fluidaudio_tpu_torch.models.conformer import ConformerConfig

    mesh = _mesh()
    batch = _mixed_batch(0 if kind == "ctc" else 1)
    gen = _gen(0 if kind == "ctc" else 1)
    if kind == "ctc":
        state, encoder, tx = pt.create_train_state(gen, ConformerConfig(**DRYRUN), VOCAB,
                                                   MEL_FRAMES, device=DEVICE)
        objective = pt.CtcObjective(encoder, VOCAB)
    else:
        cfg, pcfg = _tdt_configs()
        state, modules, tx = pt.create_tdt_train_state(gen, cfg, pcfg, MEL_FRAMES,
                                                       device=DEVICE)
        objective = pt.TdtObjective(modules, pcfg, (0, 1, 2, 3, 4))
    want_loss, want = pt.loss_and_grads(objective, state.params, batch)
    loss, got = pt.loss_and_grads(objective, shard_params(mesh, state.params),
                                  shard_batch(mesh, batch), mesh)
    return {"loss": float(loss), "single_loss": float(want_loss),
            "grads": _grad_errors(got, want)}


def case_ctc_loss_and_grads_equal_single_device():
    return _sharded_vs_single("ctc")


def case_tdt_loss_and_grads_equal_single_device():
    return _sharded_vs_single("tdt")


def case_dryrun_multichip():
    """`__graft_entry__._dryrun_impl(8)` on the port: the CTC step, the TDT
    step and `jit_sharded_infer` over the 4 x 2 mesh at JAX's dryrun
    config, then the infer's tokens against the single-device decode."""
    from fluidaudio_tpu_torch.models.conformer import ConformerConfig
    from fluidaudio_tpu_torch.ops.tdt_decode import (
        TdtDecodeConfig,
        make_initial_state,
        tdt_greedy_decode,
    )
    from fluidaudio_tpu_torch.parallel.infer import jit_sharded_infer
    from fluidaudio_tpu_torch.parallel.mesh import axis_size, shard_batch, shard_params
    from fluidaudio_tpu_torch.parallel import train as pt

    mesh = _mesh()
    cfg = ConformerConfig(**DRYRUN)
    batch = axis_size(mesh, "data") * 2

    def dryrun_batch(rng, labels=True):
        b = {"mel": rng.randn(batch, cfg.n_mels, MEL_FRAMES).astype(np.float32),
             "mel_lengths": np.full((batch,), MEL_FRAMES, np.int32)}
        if labels:
            b["labels"] = rng.randint(0, VOCAB, (batch, 8)).astype(np.int32)
            b["label_lengths"] = np.full((batch,), 8, np.int32)
        return b

    state, encoder, tx = pt.create_train_state(_gen(0), cfg, VOCAB,
                                               MEL_FRAMES, device=DEVICE)
    state = state._replace(params=shard_params(mesh, state.params))
    step = pt.jit_sharded_train_step(mesh, encoder, tx, blank_id=VOCAB, state=state)
    state, metrics = step(state, shard_batch(mesh, dryrun_batch(np.random.RandomState(0))))
    loss = float(metrics["loss"])

    _, pcfg = _tdt_configs()
    tstate, modules, ttx = pt.create_tdt_train_state(_gen(1), cfg,
                                                     pcfg, MEL_FRAMES, device=DEVICE)
    tstate = tstate._replace(params=shard_params(mesh, tstate.params))
    tstep = pt.jit_sharded_tdt_train_step(mesh, modules, pcfg, ttx, (0, 1, 2, 3, 4), tstate)
    rng = np.random.RandomState(1)
    tstate, tmetrics = tstep(tstate, shard_batch(mesh, dryrun_batch(rng)))
    tdt_l = float(tmetrics["loss"])

    infer = jit_sharded_infer(mesh, modules, pcfg, tstate.params)
    ibatch = dryrun_batch(rng, labels=False)
    sharded = shard_batch(mesh, ibatch)
    tokens, counts, enc_lengths = infer(tstate.params, sharded["mel"], sharded["mel_lengths"])

    # the single-device decode of the same (stepped) parameters
    params = {k: v.full_tensor() for k, v in tstate.params.items()}
    with torch.no_grad():
        enc_p = {k[8:]: v for k, v in params.items() if k.startswith("encoder.")}
        pred_p = {k[10:]: v for k, v in params.items() if k.startswith("predictor.")}
        joint_p = {k[6:]: v for k, v in params.items() if k.startswith("joint.")}
        call = torch.func.functional_call
        mel = torch.from_numpy(ibatch["mel"]).to(DEVICE)
        enc, enc_len = call(modules[0], enc_p,
                            (mel, torch.from_numpy(ibatch["mel_lengths"]).to(DEVICE)))
        dcfg = TdtDecodeConfig(blank_id=pcfg.blank_id, max_tokens=64)
        ref = tdt_greedy_decode(
            dcfg, lambda t, h, c: call(modules[1], pred_p, (t, h, c)),
            lambda f, g: call(modules[2], joint_p, (f, g)), enc, enc_len,
            make_initial_state(dcfg, pcfg.n_layers, pcfg.pred_hidden, batch, device=DEVICE))
    return {
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "batch": batch,
        "ctc_loss": loss, "tdt_loss": tdt_l, "ctc_step": state.step, "tdt_step": tstate.step,
        "tokens_rows": int(tokens.shape[0]), "counts": counts.tolist(),
        "enc_len0": int(enc_lengths[0]), "single_tokens_equal": bool(torch.equal(tokens,
                                                                                ref.tokens)),
        "single_counts": ref.counts.tolist(), "single_enc_len0": int(enc_len[0]),
    }


def case_manager_sharded_long_file_matches_single_device():
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    models = AsrModels.load("test-tiny", checkpoint_dir=fx.trained_assets_dir() / "asr",
                            allow_random_init=False, device=DEVICE)
    rs = np.random.RandomState(2024)
    ids = rs.randint(0, tc.N_WORDS, size=60)  # ~26 s -> several 15 s windows
    audio = tc.make_utterance(ids, rs)
    ref = AsrManager(models, ASRConfig(parallel_chunk_batch=4)).transcribe(audio)
    sharded = AsrManager(models, ASRConfig(parallel_chunk_batch=4))
    sharded.set_mesh(_mesh())
    got = sharded.transcribe(audio)
    return {"text": got.text, "ref_text": ref.text, "truth": tc.transcript_text(ids),
            "ids": [t.token_id for t in got.token_timings],
            "ref_ids": [t.token_id for t in ref.token_timings]}


def case_vad_sharded_batch_matches_single_device():
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc
    from fluidaudio_tpu_torch.vad import VadManager

    rs = np.random.RandomState(77)
    utts = [tc.speechish(1.5, rs) for _ in range(3)] + [
        (rs.randn(24000) * 0.002).astype(np.float32) for _ in range(2)]
    ckpt = fx.trained_assets_dir() / "vad"
    ref = VadManager(checkpoint_dir=ckpt, device=DEVICE).process_batch(utts)
    sharded = VadManager(checkpoint_dir=ckpt, device=DEVICE)
    sharded.set_mesh(_mesh())
    got = sharded.process_batch(utts)
    return {"probs": [[r.probability for r in b] for b in got],
            "ref_probs": [[r.probability for r in b] for b in ref]}


def case_sortformer_sharded_offline_matches_single_device():
    from fluidaudio_tpu_torch.diarizer.sortformer import SortformerDiarizer
    from fluidaudio_tpu_torch.models.sortformer import SORTFORMER_TEST
    from fluidaudio_tpu_torch.train import fixtures as fx
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    rs = np.random.RandomState(4242)
    mix, _, _ = tc.diarizer_mixture(rs, 60.0, overlap_prob=0.0)
    ckpt = fx.trained_assets_dir() / "sortformer"
    ref = SortformerDiarizer(SORTFORMER_TEST, checkpoint_dir=ckpt,
                             device=DEVICE).process_offline(mix)
    sharded = SortformerDiarizer(SORTFORMER_TEST, checkpoint_dir=ckpt, device=DEVICE)
    sharded.set_mesh(_mesh())
    got = sharded.process_offline(mix)

    def segs(r):
        return [(s.speaker_id, round(s.start_time, 3), round(s.end_time, 3))
                for s in r.segments]

    return {"segments": segs(got), "ref_segments": segs(ref),
            "speakers": got.speaker_count, "ref_speakers": ref.speaker_count}


def case_manager_set_mesh_validates_batch_divisibility():
    from fluidaudio_tpu_torch.asr.config import ASRConfig
    from fluidaudio_tpu_torch.asr.manager import AsrManager
    from fluidaudio_tpu_torch.models.zoo import AsrModels

    models = AsrModels.load("test-tiny", allow_random_init=True, device=DEVICE)
    mgr = AsrManager(models, ASRConfig(parallel_chunk_batch=3))
    try:
        mgr.set_mesh(_mesh())
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def _eou_manager():
    from fluidaudio_tpu_torch.asr.streaming_eou import EOU_TEST, StreamingEouAsrManager
    from fluidaudio_tpu_torch.train import fixtures as fx

    return StreamingEouAsrManager(chunk_ms=320, spec=EOU_TEST,
                                  checkpoint_dir=fx.trained_assets_dir() / "eou", device=DEVICE)


def _nemotron_manager():
    from fluidaudio_tpu_torch.asr.streaming_nemotron import (
        NEMOTRON_TEST,
        StreamingNemotronAsrManager,
    )
    from fluidaudio_tpu_torch.train import fixtures as fx

    return StreamingNemotronAsrManager(
        NEMOTRON_TEST, 560, language="auto", enc_cfg=fx.nemotron_tiny_enc_cfg(),
        checkpoint_dir=fx.trained_assets_dir() / "nemotron", device=DEVICE)


def case_mesh_sharded_matches_single_stream():
    """4 EOU streams sharded over "data": the same partials, finals and EOU
    flags as the single-stream path (JAX's `TestEouMultiStream`)."""
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    rs = np.random.RandomState(31)
    tail = np.zeros(int(1.28 * 16_000), np.float32)
    utts, refs = [], []
    for _ in range(4):
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 8)))
        utts.append(np.concatenate([tc.make_utterance(ids, rs), tail]))
        refs.append(tc.transcript_text(ids))
    single = _eou_manager()
    ref_finals, ref_eous = [], []
    for a in utts:
        state = single.make_state()
        partials = single.process(a, state)
        ref_eous.append(sum(p.eou_detected for p in partials))
        ref_finals.append(single.finish(state))
    mgr = _eou_manager()
    mgr.set_mesh(_mesh())
    session = mgr.make_multi_state(4)
    partials = mgr.process_multi(session, utts)
    finals = mgr.flush_multi(session)
    return {"texts": [f.text for f in finals], "ref_texts": [f.text for f in ref_finals],
            "refs": refs, "ids": [f.token_ids for f in finals],
            "ref_ids": [f.token_ids for f in ref_finals],
            "eous": [sum(p.eou_detected for p in ps) for ps in partials], "ref_eous": ref_eous}


def case_mesh_requires_divisible_stream_count():
    mgr = _eou_manager()
    mgr.set_mesh(_mesh())
    try:
        mgr.make_multi_state(3)
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def case_mesh_sharded_multilingual():
    from fluidaudio_tpu_torch.train import tiny_corpus as tc

    rs = np.random.RandomState(808)
    langs = ["aa-AA", "bb-BB", "aa-AA", "bb-BB"]
    utts, refs = [], []
    for lang in langs:
        corpus_lang = "b" if lang == "bb-BB" else "a"
        ids = rs.randint(0, tc.N_WORDS, size=int(rs.randint(2, 6)))
        utts.append(tc.make_utterance(ids, rs, lang=corpus_lang))
        words = (tc.word_text(i) if corpus_lang == "a" else tc.word_text_b(i) for i in ids)
        refs.append(" ".join(words))
    single = _nemotron_manager()
    ref_texts = []
    for lang, a in zip(langs, utts):
        single.set_language(lang)
        state = single.make_state()
        single.process(a, state)
        ref_texts.append(single.finish(state).text)
    mgr = _nemotron_manager()
    mgr.set_mesh(_mesh())
    session = mgr.make_multi_state(4, languages=langs)
    mgr.process_multi(session, utts)
    finals = mgr.flush_multi(session)
    return {"texts": [f.text for f in finals], "ref_texts": ref_texts, "refs": refs}


# -------------------------------------------- JAX's assertions, per case


def _data() -> int:
    return WORLD // 2


def expect_mesh_and_param_sharding(out):
    assert out["shape"] == {"data": _data(), "model": 2}
    assert out["kernel"] == ["Replicate()", "Shard(dim=0)"]  # JAX: "model" in its spec
    assert out["bias"] == ["Replicate()", "Shard(dim=0)"]
    assert out["batch_x_data_placement"] and out["batch_x_local_shape"] == [8 // _data(), 4]


def expect_dryrun_multichip(out):
    """JAX's dryrun's three programs over the mesh: finite CTC and TDT
    losses, and the sharded infer's tokens for every row (here also equal
    to the single-device decode of the same parameters)."""
    assert out["mesh"] == {"data": _data(), "model": 2}
    assert np.isfinite(out["ctc_loss"]) and np.isfinite(out["tdt_loss"])
    assert out["ctc_step"] == out["tdt_step"] == 1
    assert out["tokens_rows"] == out["batch"] == 2 * _data() and min(out["counts"]) >= 0
    assert out["single_tokens_equal"] and out["counts"] == out["single_counts"]
    assert out["enc_len0"] == out["single_enc_len0"] == 9


def expect_manager_sharded_long_file_matches_single_device(out):
    assert out["text"] == out["ref_text"]
    assert out["text"] == out["truth"]  # and it's the real labels
    assert out["ids"] == out["ref_ids"]


def expect_vad_sharded_batch_matches_single_device(out):
    assert out["probs"] == out["ref_probs"]
    assert np.mean(out["probs"][0]) >= 0.5 and np.mean(out["probs"][3]) < 0.5


def expect_sortformer_sharded_offline_matches_single_device(out):
    assert out["segments"] == out["ref_segments"]
    assert out["speakers"] == out["ref_speakers"] == 2


def expect_manager_set_mesh_validates_batch_divisibility(out):
    assert out["raised"] is not None and "multiple of the mesh data axis" in out["raised"]


def expect_mesh_sharded_matches_single_stream(out):
    assert out["texts"] == out["ref_texts"] == out["refs"]
    assert out["ids"] == out["ref_ids"]
    assert out["eous"] == out["ref_eous"]


expect_mesh_requires_divisible_stream_count = expect_manager_set_mesh_validates_batch_divisibility


def expect_mesh_sharded_multilingual(out):
    assert out["texts"] == out["ref_texts"] == out["refs"]


def _expect_equal_to_single_device(out):
    """The sharded loss within 1e-6 relative of the single-device loss (the
    data axis averages the rows' means where one device takes one mean);
    each gradient leaf within 1e-5 of its norm, floored at 1e-3 of the
    largest leaf's norm (the attention's key bias has a gradient that is
    zero but for rounding, ~1e-8, so its relative error is noise)."""
    assert np.isfinite(out["loss"])
    assert abs(out["loss"] - out["single_loss"]) <= 1e-6 * abs(out["single_loss"])
    floor = 1e-3 * max(norm for _, norm in out["grads"].values())
    for name, (err, norm) in out["grads"].items():
        assert err <= 1e-5 * max(norm, floor), (name, err, norm)


expect_ctc_loss_and_grads_equal_single_device = _expect_equal_to_single_device
expect_tdt_loss_and_grads_equal_single_device = _expect_equal_to_single_device


def expect_param_sharding_rules_equal_jax(out):
    """JAX's rule itself is applied in the test module (it needs JAX); here
    only that the rule shards something."""
    assert any(a is not None for a in out["tdt"].values())


CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}
EXPECT = {name: globals()[f"expect_{name}"] for name in CASES}


def main(rank: int, world: int, rdzv: str, out: str, device: str) -> None:
    global DEVICE, WORLD
    DEVICE, WORLD = device, world
    torch.set_num_threads(1)
    if device == "cuda":
        from fluidaudio_tpu_torch.models.zoo import disable_tf32

        disable_tf32()  # the sharded and single-device runs pick other conv algorithms
    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            init_method=f"file://{rdzv}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    results = {}
    try:
        for name, fn in CASES.items():
            try:
                results[name] = {"ok": True, "out": fn()}
            except Exception:  # reported by the expectation that reads this case
                results[name] = {"ok": False, "error": traceback.format_exc()}
    finally:
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()


def spawn(world: int, device: str, workdir: Path, timeout_s: float = 420.0) -> dict:
    """Run the cases on `world` ranks (processes of this module, one thread
    each, collectives timing out at 120 s, all killed at `timeout_s`);
    -> {case: {"ok", "out" | "error"}}. Raises RuntimeError, with rank 0's
    output, when the group wrote no results."""
    out = workdir / "results.pkl"
    logs = [open(workdir / f"rank{r}.log", "wb") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world),
         str(workdir / "rdzv"), str(out), device],
        cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT,
        env=dict(os.environ, LOCAL_RANK=str(r), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1"))
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
    if not out.exists():
        tail = (workdir / "rank0.log").read_text(errors="replace")[-3000:]
        raise RuntimeError(f"the group wrote no results (rcs {[p.returncode for p in procs]}):"
                           f"\n{tail}")
    with open(out, "rb") as f:
        return pickle.load(f)


def check(world: int, device: str) -> int:
    """`spawn`, then every case's expectation: one line per case, 1 if any
    fails."""
    global WORLD
    WORLD = world
    with tempfile.TemporaryDirectory(prefix="torch_parallel_ranks_") as tmp:
        t0 = time.perf_counter()
        results = spawn(world, device, Path(tmp))
    failed = 0
    for name, result in results.items():
        try:
            assert result["ok"], result.get("error")
            EXPECT[name](result["out"])
            print(f"{name}: ok", flush=True)
        except AssertionError as e:
            failed += 1
            print(f"{name}: FAILED {e}", flush=True)
    print(f"{len(results) - failed} of {len(results)} cases passed on {world} {device} ranks "
          f"({world // 2} x 2 mesh) in {time.perf_counter() - t0:.1f} s")
    return int(failed > 0)


if __name__ == "__main__":
    # run by path, as `spawn` runs it: an installed package named `tests`
    # would shadow this directory under `python -m tests....`
    sys.path.insert(0, str(REPO))
    if sys.argv[1] == "--check":
        sys.exit(check(int(sys.argv[2]), sys.argv[3]))
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
